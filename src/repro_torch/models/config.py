"""Unified model configuration covering all 10 assigned architectures.

Counterpart of ``repro/models/config.py``, a copy (it is plain Python):
the parameter counts, padded vocabulary and layer periods equal the JAX
package's exactly.

One ``ModelConfig`` describes any member of the zoo via a per-layer
``layer_pattern`` of token-mixer kinds and a parallel ``mlp_pattern``:

    mixer kinds: "attn" (global causal), "local_attn" (sliding window),
                 "bidir_attn" (encoder), "rglru" (Griffin RG-LRU),
                 "rwkv6" (Finch time-mix)
    mlp kinds:   "swiglu" | "geglu" | "gelu" | "moe" | "rwkv_cmix"

Patterns of length < num_layers repeat cyclically (gemma2's local/global
alternation is pattern ("local_attn", "attn"); recurrentgemma's 1:2 is
("rglru", "rglru", "local_attn")).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads

    layer_pattern: Tuple[str, ...] = ("attn",)
    mlp_pattern: Tuple[str, ...] = ("swiglu",)

    # attention details
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None    # tanh cap on attention logits
    logit_softcap: Optional[float] = None   # tanh cap on final LM logits
    local_window: int = 4096
    attn_q_chunk: int = 512                 # flash-attention chunk sizes;
    attn_kv_chunk: int = 1024               # align q_chunk to seq shards
                                            # for sequence parallelism
    use_abs_pos: bool = False               # learned absolute positions
    max_abs_pos: int = 4096

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 256               # GShard dispatch group granularity

    # recurrent (rglru / rwkv6)
    lru_width: int = 0                      # 0 -> d_model
    conv_width: int = 4
    rwkv_head_size: int = 64

    # norms / residual
    norm_kind: str = "rms"                  # "rms" | "ln" (whisper, rwkv)
    norm_eps: float = 1e-6
    use_post_norm: bool = False             # gemma2: extra norm after block
    tie_embeddings: bool = True
    scale_embed: bool = False               # gemma family: x *= sqrt(d)

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500                 # whisper post-conv frame count

    # vlm prefix (internvl2): patch embeddings prepended to the token stream
    num_patches: int = 0

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # distribution hillclimb knobs (see models/sharding.py): param-rule and
    # activation-rule overrides applied on top of the baselines
    sharding_rules: Tuple[Tuple[str, Optional[str]], ...] = ()
    act_sharding_rules: Tuple[Tuple[str, Optional[str]], ...] = ()

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so embedding/logits shard cleanly over any mesh axis
        used in the production meshes (multiples of 512 = lcm-friendly for
        16 x 16 x 2)."""
        return round_up(self.vocab_size, 512)

    def mixer_of(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def mlp_of(self, layer: int) -> str:
        return self.mlp_pattern[layer % len(self.mlp_pattern)]

    @property
    def uniform_period(self) -> int:
        """Smallest period p such that layers repeat with period p AND
        num_layers % p == 0 (enables scan-over-layer-groups); falls back to
        num_layers (pure python loop) when no period divides."""
        p = math.lcm(len(self.layer_pattern), len(self.mlp_pattern))
        if self.num_layers % p == 0:
            return p
        return self.num_layers

    @property
    def is_attention_free(self) -> bool:
        return all(m in ("rglru", "rwkv6") for m in self.layer_pattern)

    @property
    def supports_long_context(self) -> bool:
        """True if every mixer has bounded decode state (no full KV growth):
        SSM/linear-recurrent layers and *windowed* attention qualify; any
        global-attention layer disqualifies (the long_500k skip rule)."""
        return all(m in ("rglru", "rwkv6", "local_attn")
                   for m in self.layer_pattern)

    @property
    def num_params_active(self) -> int:
        """Approximate active params/token (MoE counts top-k experts)."""
        return _count_params(self, active_only=True)

    @property
    def num_params_total(self) -> int:
        return _count_params(self, active_only=False)


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    total = cfg.padded_vocab * d  # embedding
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d

    def layer_params(mixer: str, mlp: str) -> int:
        p = 0
        if mixer in ("attn", "local_attn", "bidir_attn"):
            p += d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            if cfg.qkv_bias:
                p += (n_q + 2 * n_kv) * hd
        elif mixer == "rglru":
            w = cfg.lru_width or d
            # in-proj x2, conv, gates a/x, out-proj
            p += 2 * d * w + cfg.conv_width * w + 2 * w * w // 8 + w + w * d
        elif mixer == "rwkv6":
            p += 4 * d * d + d * d  # r,k,v,g,o (+ small lora/decay terms)
            p += d * 2 + d * 32 * 2 * 5
        if mlp in ("swiglu", "geglu"):
            p += 3 * d * cfg.d_ff
        elif mlp == "gelu":
            p += 2 * d * cfg.d_ff
        elif mlp == "moe":
            e = (cfg.num_experts_per_tok if active_only else cfg.num_experts)
            p += d * cfg.num_experts          # router
            p += e * 3 * d * cfg.d_ff
        elif mlp == "rwkv_cmix":
            p += 2 * d * cfg.d_ff
        p += 2 * d  # norms
        return p

    for layer in range(cfg.num_layers):
        total += layer_params(cfg.mixer_of(layer), cfg.mlp_of(layer))
    if cfg.is_encoder_decoder:
        for _ in range(cfg.encoder_layers):
            total += layer_params("bidir_attn", cfg.mlp_of(0))
            # decoder cross-attention blocks
        total += cfg.num_layers * (2 * d * n_kv * hd + d * n_q * hd
                                   + n_q * hd * d + 2 * d)
    return total
