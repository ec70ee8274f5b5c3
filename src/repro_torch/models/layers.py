"""Primitive layers: norms, dense projections, RoPE, embeddings.

Counterpart of ``repro/models/layers.py``. A "module" is an ``*_init``
function that returns ``(params, axes)`` (a dict of tensors and a parallel
dict of logical axis names for ``models/sharding.py``) plus a pure function
that applies it. The JAX package draws from split PRNG keys; here every
init function draws, in order, from one :class:`ParamRng` (a
``torch.Generator`` and the device the leaves live on), so the port's
random parameters are its own, and tests carry JAX's across by path name
(``models/convert.py``).

Dtypes follow JAX's: norms and RoPE compute in f32 and cast back, a dense
product runs in the operands' promoted dtype, and ``unembed`` multiplies
in the table's dtype and only then casts the logits to f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Parallel-tree container: params["w"], axes["w"] = ("embed", "ffn")
Params = dict


class ParamRng:
    """Where init functions draw from: f32 standard normals (or uniforms)
    from ``generator`` (on its own device), scaled in f32, cast to the leaf's
    dtype and placed on ``device``. A leaf of three or more dims (a stack of
    experts) is drawn one leading slice at a time, so no f32 copy of the
    whole leaf is ever held. On the ``meta`` device nothing is drawn."""

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device):
        self.generator = generator
        self.device = torch.device(device)

    def _draw(self, shape, std: float, dtype) -> torch.Tensor:
        gen_device = (self.generator.device if self.generator is not None
                      else "cpu")
        x = torch.randn(shape, generator=self.generator, device=gen_device,
                        dtype=torch.float32) * std
        return x.to(device=self.device, dtype=dtype)

    def normal(self, shape, std: float, dtype) -> torch.Tensor:
        shape = tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        if len(shape) < 3:
            return self._draw(shape, std, dtype)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for i in range(shape[0]):
            out[i] = self._draw(shape[1:], std, dtype)
        return out

    def uniform(self, shape, lo: float, hi: float, dtype) -> torch.Tensor:
        """f32 draws from ``[lo, hi)``, as ``u * (hi - lo) + lo`` in f32,
        cast to ``dtype``."""
        shape = tuple(shape)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=dtype, device=self.device)
        gen_device = (self.generator.device if self.generator is not None
                      else "cpu")
        u = torch.rand(shape, generator=self.generator, device=gen_device,
                       dtype=torch.float32)
        return (u * (hi - lo) + lo).to(device=self.device, dtype=dtype)

    def zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype, device=self.device)

    def ones(self, shape, dtype) -> torch.Tensor:
        return torch.ones(tuple(shape), dtype=dtype, device=self.device)


def promoted(*xs: torch.Tensor):
    """The tensors cast to their promoted dtype, as JAX promotes the
    operands of a product (bf16 with f32 is f32); torch's products refuse
    mixed dtypes."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the operands' promoted dtype."""
    x, w = promoted(x, w)
    return x @ w


def gelu(z: torch.Tensor) -> torch.Tensor:
    """JAX's ``jax.nn.gelu`` (``approximate=True``): the tanh form."""
    return F.gelu(z, approximate="tanh")


def dense_init(rng: ParamRng, d_in: int, d_out: int, axes: tuple,
               dtype=torch.bfloat16, bias: bool = False,
               bias_axis: Optional[str] = None):
    scale = (1.0 / d_in) ** 0.5
    p = {"w": rng.normal((d_in, d_out), scale, dtype)}
    a = {"w": axes}
    if bias:
        p["b"] = rng.zeros((d_out,), dtype)
        a["b"] = (bias_axis or axes[1],)
    return p, a


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = mm(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm_init(rng: ParamRng, d: int, dtype=torch.bfloat16):
    return {"scale": rng.ones((d,), dtype)}, {"scale": (None,)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(x.dtype)


def layernorm_init(rng: ParamRng, d: int, dtype=torch.bfloat16):
    return ({"scale": rng.ones((d,), dtype), "bias": rng.zeros((d,), dtype)},
            {"scale": (None,), "bias": (None,)})


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def embedding_init(rng: ParamRng, vocab: int, d: int, dtype=torch.bfloat16):
    return ({"table": rng.normal((vocab, d), d ** -0.5, dtype)},
            {"table": ("vocab", "embed")})


def embed(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def unembed(p: Params, x: torch.Tensor,
            softcap: Optional[float] = None) -> torch.Tensor:
    x, table = promoted(x, p["table"])
    logits = (x @ table.transpose(0, 1)).to(torch.float32)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


def abs_pos_init(rng: ParamRng, max_pos: int, d: int, dtype=torch.bfloat16):
    return {"pos": rng.normal((max_pos, d), 0.02, dtype)}, \
        {"pos": (None, "embed")}


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] int. The two
    halves of the head dim rotate together (not interleaved pairs), in f32,
    and the result is cast back to ``x``'s dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # [hd/2]
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]              # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap
