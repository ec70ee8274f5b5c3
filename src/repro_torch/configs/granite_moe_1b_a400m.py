"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32 experts top-8.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        layer_pattern=("attn",),
        mlp_pattern=("moe",),
        num_experts=32,
        num_experts_per_tok=8,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="granite-moe-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=32,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=2,
        moe_group_size=64,
    )
