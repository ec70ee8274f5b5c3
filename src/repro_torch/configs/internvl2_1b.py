"""internvl2-1b [arXiv:2404.16821; hf].

Backbone (Qwen2-0.5B): 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655, QKV bias. The InternViT-300M vision frontend is a STUB per
the assignment: ``input_specs()`` provides precomputed patch embeddings
[B, num_patches, d_model] that are prepended to the token stream.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151655,
        layer_pattern=("attn",),
        mlp_pattern=("swiglu",),
        qkv_bias=True,
        rope_theta=1_000_000.0,
        num_patches=256,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="internvl2-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_patches=8,
    )
