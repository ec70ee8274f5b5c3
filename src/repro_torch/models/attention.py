"""Attention: GQA + RoPE + flash-style chunked softmax, in plain PyTorch.

Counterpart of ``repro/models/attention.py``. Training/prefill attention
never materializes the [S, S] score matrix: keys stream through the same
online-softmax recurrence over kv chunks as JAX's ``lax.scan``, with JAX's
masking constant (``NEG_INF = -1e30``, not ``-inf``), so a query row whose
leading chunks are all masked carries ``m = -1e30`` until its first
unmasked chunk wipes them out through ``corr = exp(-1e30 - m) = 0``. The q
chunks, which JAX maps over one at a time, are independent, so they go
through each kv step together: one batched product per kv chunk. Every kv
chunk is computed, masked or not (JAX's baseline; a block-causal variant
would skip the fully masked ones).

Dtypes are JAX's: scores are f32 (``preferred_element_type``: on the card
a bf16 product with an f32 output, elsewhere the operands widened to f32,
exactly), probabilities are cast to ``v``'s dtype before ``P·V``, the
accumulator is f32 and the output is cast back to ``q``'s dtype.

Decode attends one query against the cache directly (no chunking): either a
full cache [B, S_max, Hkv, D] + length, or a ring buffer of ``window`` slots
for local attention. ``update_cache`` and ``update_ring_cache`` return new
buffers, as JAX's do; ``update_cache_`` and ``update_ring_cache_`` write the
token into the cache itself (the decode step's: a functional write would
copy every layer's whole cache at every token).

On the card the f32 scores' products have a gradient of their own
(``_BmmF32``), so a bf16 train step differentiates through attention.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common.nodes import resolve_device
from repro_torch.models.layers import softcap as _softcap

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Full-sequence cache (global attention)."""
    k: torch.Tensor        # [B, S_max, Hkv, D]
    v: torch.Tensor        # [B, S_max, Hkv, D]
    length: torch.Tensor   # 0-dim int32 — valid prefix


class RingKVCache(NamedTuple):
    """Window-bounded ring cache (local attention)."""
    k: torch.Tensor        # [B, W, Hkv, D]
    v: torch.Tensor        # [B, W, Hkv, D]
    pos: torch.Tensor      # [W] int32 absolute positions (-1 = empty)
    length: torch.Tensor   # 0-dim int32 — total tokens seen


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=torch.float32)`` with a gradient (the
    op has no autograd formula): JAX's transpose of ``dot_general(...,
    preferred_element_type=f32)``. The f32 cotangent times the other
    operand widened to f32, in f32, cast to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(dc, b.to(torch.float32).mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.to(torch.float32).mT, dc).to(b.dtype)
        return da, db


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 3-dim tensors of one dtype with an f32 result, the
    products accumulated in f32 (JAX's ``preferred_element_type``). On the
    CPU, which has no such kernel, the operands are widened (exact), and
    autograd differentiates that; its gradients are what the card's are
    held against."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, kind: str = "causal",
                    window: int = 0,
                    attn_softcap: Optional[float] = None,
                    q_offset: int = 0,
                    q_chunk: int = 512,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """Chunked online-softmax attention.

    q: [B, Sq, Hq, D]; k, v: [B, Sk, Hkv, D]; returns [B, Sq, Hq, D].
    kind: "causal" | "local" (needs window) | "bidir".
    ``q_offset``: absolute position of q[0] relative to k[0] (prefill
    continuation); 0 for self-attention from scratch.
    """
    if kind not in ("causal", "local", "bidir"):
        raise ValueError(kind)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5
    dev = q.device

    qc = min(q_chunk, sq)
    kc = min(kv_chunk, sk)
    # pad to chunk multiples
    sq_p = ((sq + qc - 1) // qc) * qc
    sk_p = ((sk + kc - 1) // kc) * kc
    n_q, n_k = sq_p // qc, sk_p // kc
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_p - sk))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_p - sk))

    # [B, Sq_p, Hq, D] -> [B, Hkv, n_q, G, qc, D] -> [B*Hkv, n_q*G*qc, D]
    qg = qp.reshape(b, n_q, qc, hkv, g, d).permute(0, 3, 1, 4, 2, 5)
    qg = qg.reshape(b * hkv, n_q * g * qc, d)
    # [B, Sk_p, Hkv, D] -> [B*Hkv, Sk_p, D]
    kt = kp.permute(0, 2, 1, 3).reshape(b * hkv, sk_p, d)
    vt = vp.permute(0, 2, 1, 3).reshape(b * hkv, sk_p, d)
    q_pos = (q_offset + torch.arange(sq_p, device=dev)).reshape(n_q, 1, qc, 1)

    stats = (b, hkv, n_q, g, qc)
    m = torch.full(stats, NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(stats, dtype=torch.float32, device=dev)
    acc = torch.zeros(stats + (d,), dtype=torch.float32, device=dev)
    for kj in range(n_k):
        k_blk = kt[:, kj * kc:(kj + 1) * kc]
        v_blk = vt[:, kj * kc:(kj + 1) * kc]
        k_pos = kj * kc + torch.arange(kc, device=dev)

        s = _bmm_f32(qg, k_blk.transpose(1, 2)) * scale
        s = _softcap(s, attn_softcap).reshape(stats + (kc,))

        mask = k_pos < sk                                  # padding
        if kind == "causal":
            mask = mask & (k_pos <= q_pos)
        elif kind == "local":
            mask = mask & (k_pos <= q_pos) & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)                  # [.., n_q, 1, qc, kc]

        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = _bmm_f32(p.to(v_blk.dtype).reshape(b * hkv, n_q * g * qc, kc),
                      v_blk)
        acc = acc * corr[..., None] + pv.reshape(stats + (d,))
        m = m_new

    out = acc / torch.clamp(l[..., None], min=1e-30)
    # [B, Hkv, n_q, G, qc, D] -> [B, n_q, qc, Hkv, G, D]
    out = out.permute(0, 2, 4, 1, 3, 5).reshape(b, sq_p, hq, d)
    return out[:, :sq].to(q.dtype)


# --------------------------------------------------------------------------
# Decode-time attention
# --------------------------------------------------------------------------

def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            valid: torch.Tensor, attn_softcap: Optional[float]):
    """One query [B, 1, Hq, D] against keys [B, K, Hkv, D], ``valid`` [K]."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)                     # [B, Hkv, G, D]
    kt = k.permute(0, 2, 3, 1).reshape(b * hkv, d, -1)       # [B*Hkv, D, K]
    s = _bmm_f32(qg.reshape(b * hkv, hq // hkv, d), kt) * (d ** -0.5)
    s = _softcap(s, attn_softcap)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vt = v.permute(0, 2, 1, 3).reshape(b * hkv, -1, d)       # [B*Hkv, K, D]
    out = _bmm_f32(p.to(v.dtype), vt)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, cache: KVCache,
                     attn_softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a full cache.

    q: [B, 1, Hq, D] -> [B, 1, Hq, D].
    """
    k_pos = torch.arange(cache.k.shape[1], device=q.device)
    return _decode(q, cache.k, cache.v, k_pos < cache.length, attn_softcap)


def decode_attention_ring(q: torch.Tensor, cache: RingKVCache,
                          window: int,
                          attn_softcap: Optional[float] = None
                          ) -> torch.Tensor:
    """One-token local attention against a ring cache (bounded state).

    Call with the *updated* cache (current token already written), matching
    ``decode_attention``: the current token's position is ``length - 1``.
    """
    cur = cache.length - 1  # absolute position of the current token
    valid = (cache.pos >= 0) & (cache.pos <= cur) & (cache.pos > cur - window)
    return _decode(q, cache.k, cache.v, valid, attn_softcap)


def _at(start: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's ``dynamic_update_slice_in_dim`` start of a size-1 update:
    ``start`` (a 0-dim tensor, never read on the host) clamped into
    ``[0, size)``, as an index vector."""
    return start.clamp(0, size - 1).reshape(1).to(torch.int64)


def _write_at(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
              dim: int) -> torch.Tensor:
    return buf.index_copy(dim, _at(start, buf.shape[dim]), new)


def _write_at_(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
               dim: int) -> None:
    """:func:`_write_at` into ``buf`` itself (a view writes through)."""
    buf.index_copy_(dim, _at(start, buf.shape[dim]), new)


def update_cache_(cache: KVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> KVCache:
    """:func:`update_cache` in place: the token's K/V are written into the
    cache's buffers and ``length`` is advanced, all of them views that may
    lie in a stacked ``[R, ...]`` leaf. Returns ``cache``."""
    _write_at_(cache.k, k_new, cache.length, 1)
    _write_at_(cache.v, v_new, cache.length, 1)
    cache.length.add_(1)
    return cache


def update_ring_cache_(cache: RingKVCache, k_new: torch.Tensor,
                       v_new: torch.Tensor) -> RingKVCache:
    """:func:`update_ring_cache` in place. Returns ``cache``."""
    slot = cache.length % cache.k.shape[1]
    _write_at_(cache.k, k_new, slot, 1)
    _write_at_(cache.v, v_new, slot, 1)
    _write_at_(cache.pos, cache.length.reshape(1).to(cache.pos.dtype), slot,
               0)
    cache.length.add_(1)
    return cache


def update_cache(cache: KVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> KVCache:
    """Append [B, 1, Hkv, D] at position cache.length."""
    return KVCache(k=_write_at(cache.k, k_new, cache.length, 1),
                   v=_write_at(cache.v, v_new, cache.length, 1),
                   length=cache.length + 1)


def update_ring_cache(cache: RingKVCache, k_new: torch.Tensor,
                      v_new: torch.Tensor) -> RingKVCache:
    """Write [B, 1, Hkv, D] at slot (length % window)."""
    slot = cache.length % cache.k.shape[1]
    return RingKVCache(
        k=_write_at(cache.k, k_new, slot, 1),
        v=_write_at(cache.v, v_new, slot, 1),
        pos=_write_at(cache.pos, cache.length.reshape(1).to(cache.pos.dtype),
                      slot, 0),
        length=cache.length + 1)


def empty_cache(batch: int, s_max: int, hkv: int, d: int,
                dtype=torch.bfloat16, *, device=None) -> KVCache:
    """A zero cache on ``device`` (the card unless the caller asks for the
    CPU)."""
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros((batch, s_max, hkv, d), dtype=dtype, device=device),
        v=torch.zeros((batch, s_max, hkv, d), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def empty_ring_cache(batch: int, window: int, hkv: int, d: int,
                     dtype=torch.bfloat16, *, device=None) -> RingKVCache:
    """An empty ring on ``device`` (the card unless the caller asks for
    the CPU)."""
    device = resolve_device(device)
    return RingKVCache(
        k=torch.zeros((batch, window, hkv, d), dtype=dtype, device=device),
        v=torch.zeros((batch, window, hkv, d), dtype=dtype, device=device),
        pos=torch.full((window,), -1, dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


def prefill_into_cache(cache: KVCache, k: torch.Tensor,
                       v: torch.Tensor, length: int) -> KVCache:
    """Bulk-write a prefill's K/V (length static) into a fresh cache."""
    kc, vc = cache.k.clone(), cache.v.clone()
    kc[:, :k.shape[1]] = k
    vc[:, :v.shape[1]] = v
    return KVCache(k=kc, v=vc, length=torch.full(
        (), length, dtype=torch.int32, device=cache.k.device))
