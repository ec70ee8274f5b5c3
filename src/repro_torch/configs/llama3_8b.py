"""llama3-8b [arXiv:2407.21783; unverified].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, SwiGLU,
rope theta 500k.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        layer_pattern=("attn",),
        mlp_pattern=("swiglu",),
        rope_theta=500_000.0,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="llama3-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
