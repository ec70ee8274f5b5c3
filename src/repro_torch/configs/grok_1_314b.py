"""grok-1-314b [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2. Attention-logit softcap 30 (grok-1's tanh capping); final logit
softcap 30.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=32768,
        vocab_size=131072,
        layer_pattern=("attn",),
        mlp_pattern=("moe",),
        num_experts=8,
        num_experts_per_tok=2,
        attn_softcap=30.0,
        logit_softcap=30.0,
        rope_theta=10_000.0,
        tie_embeddings=True,
        scale_embed=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="grok-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        num_experts=4,
        num_experts_per_tok=2,
        moe_group_size=64,
    )
