"""granite-20b [arXiv:2405.04324; hf] (granite-20b-code family).

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152. GPT-BigCode-style:
MQA, plain GELU MLP (non-gated), learned absolute positions.
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        layer_pattern=("attn",),
        mlp_pattern=("gelu",),
        use_rope=False,
        use_abs_pos=True,
        max_abs_pos=32768 + 8,   # prefill_32k/decode_32k need 32k positions
        norm_kind="ln",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="granite20b-smoke",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        max_abs_pos=128,
    )
