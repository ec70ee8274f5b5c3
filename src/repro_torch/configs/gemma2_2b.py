"""gemma2-2b [arXiv:2408.00118; hf].

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000. Alternating
local (window 4096) / global attention, attention-logit softcap 50, final
logit softcap 30, pre+post block norms, embeddings scaled by sqrt(d).
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256_000,
        layer_pattern=("local_attn", "attn"),
        mlp_pattern=("geglu",),
        local_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        use_post_norm=True,
        scale_embed=True,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="gemma2-smoke",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        local_window=16,
    )
