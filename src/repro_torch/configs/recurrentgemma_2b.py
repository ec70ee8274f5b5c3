"""recurrentgemma-2b [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000. Griffin pattern:
two RG-LRU recurrent blocks per local-attention block (window 2048), i.e.
(rglru, rglru, local_attn) repeating; 26 layers -> 8 full periods + (rglru,
rglru) tail, handled by the per-layer (non-scanned) layout since 26 % 3 != 0.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        layer_pattern=("rglru", "rglru", "local_attn"),
        mlp_pattern=("geglu",),
        local_window=2048,
        lru_width=2560,
        conv_width=4,
        rope_theta=10_000.0,
        tie_embeddings=True,
        scale_embed=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="recurrentgemma-smoke",
        num_layers=5,          # still not pattern-divisible: exercises loop
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        local_window=16,
        lru_width=64,
    )
