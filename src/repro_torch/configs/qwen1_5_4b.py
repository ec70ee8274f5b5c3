"""qwen1.5-4b [hf:Qwen/Qwen1.5-0.5B; hf].

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936, QKV bias, SwiGLU.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        vocab_size=151936,
        layer_pattern=("attn",),
        mlp_pattern=("swiglu",),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="qwen-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
