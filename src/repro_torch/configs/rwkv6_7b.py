"""rwkv6-7b "Finch" [arXiv:2404.05892; hf].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536. Data-dependent
decay time-mix (head size 64 -> 64 heads) + squared-ReLU channel-mix.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,           # d_model / rwkv_head_size
        num_kv_heads=64,
        d_ff=14336,
        vocab_size=65536,
        layer_pattern=("rwkv6",),
        mlp_pattern=("rwkv_cmix",),
        rwkv_head_size=64,
        norm_kind="ln",
        use_rope=False,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="rwkv6-smoke",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=8,
        d_ff=128,
        vocab_size=256,
        rwkv_head_size=8,
    )
