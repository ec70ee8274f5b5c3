"""Int8 error-feedback gradient compression for a data-parallel
all-reduce.

Counterpart of ``repro/optim/compression.py``. The all-reduce bytes drop
4x (f32 -> int8 plus one f32 scale a tensor); the quantization error is
fed back into the next step's gradient, which keeps SGD and Adam
converging (Karimireddy et al., arXiv:1901.09847)::

    q, scale = compress_int8(g + ef)           # quantize with feedback
    ef_new   = (g + ef) - decompress_int8(q, scale)

``torch.round`` rounds half to even as ``jnp.round`` does, and both
divides are IEEE (the divisors are tensors on the input's device), so
``q`` and ``scale`` are bit-equal to the JAX package's on the same input.
"""

from __future__ import annotations

import torch

from repro_torch.common import tree as tr


def compress_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns ``(q, scale)``."""
    xf = x.to(torch.float32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


def ef_compress_update(grad: torch.Tensor, error: torch.Tensor):
    """One error-feedback round for a single tensor: ``(estimate,
    new_error)``. ``estimate`` is the dequantized value all ranks agree on
    after the int8 all-reduce; ``new_error`` is carried to the next
    step."""
    target = grad.to(torch.float32) + error
    q, scale = compress_int8(target)
    est = decompress_int8(q, scale)
    return est.to(grad.dtype), target - est


def tree_ef_compress(grads, errors):
    """Error-feedback compression leaf by leaf over a gradient tree."""
    outs = [ef_compress_update(g, e) for g, e in zip(tr.tree_leaves(grads),
                                                      tr.tree_leaves(errors))]
    return (tr.tree_unflatten(grads, [o[0] for o in outs]),
            tr.tree_unflatten(grads, [o[1] for o in outs]))
