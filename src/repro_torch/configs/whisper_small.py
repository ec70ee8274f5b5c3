"""whisper-small [arXiv:2212.04356; unverified].

Encoder-decoder, 12L + 12L, d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865, GELU, learned absolute positions. The conv1d audio frontend is
a STUB per the assignment: ``input_specs()`` provides precomputed frames
[B, 1500, d_model] (the post-conv 30s mel window at 50 Hz).
"""

import dataclasses

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        layer_pattern=("attn",),
        mlp_pattern=("gelu",),
        is_encoder_decoder=True,
        encoder_layers=12,
        encoder_seq=1500,
        use_rope=False,
        use_abs_pos=True,
        max_abs_pos=32768 + 8,   # decode_32k needs positions to 32k
        norm_kind="ln",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(),
        name="whisper-smoke",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        encoder_seq=24,
        max_abs_pos=128,
    )
