"""Carrying parameters across: the port's tree from JAX's leaves and back.

A leaf is named by its path (``common/tree.py``'s names, the ones
checkpoints cross with: ``layers/0/mixer/wq/w``, ``encoder/mlp/up/b``, ...),
for both layer layouts: the stacked slots (``layers/<slot>/...`` with a
leading ``[n_rep]`` dim, when ``uniform_period < num_layers``) and the
per-layer list (``layers/<i>/...``). ``init_params`` on the ``meta``
device gives the tree both functions check names, shapes and dtypes
against.

JAX's bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they cross as their ``uint16`` bits, as
checkpoints do. ``params_to_numpy`` gives bf16 leaves as f32 arrays (exact:
every bf16 value is an f32), which need no ``ml_dtypes`` to read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.common import tree as tr
from repro_torch.common.nodes import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_params


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")              # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ModelConfig, *,
                      device=None):
    """The port's parameter tree for ``cfg`` on ``device`` (the card
    unless the caller asks for the CPU) from ``{path: array}``. Every path
    of the tree must be given with its shape; each array is cast to its
    leaf's dtype. Raises ``ValueError`` on a missing, extra or misshapen
    leaf."""
    device = resolve_device(device)
    like, _ = init_params(cfg, device="meta")
    want = tr.tree_flatten_with_paths(like)
    names = {name for name, _ in want}
    extra = sorted(set(flat) - names)
    missing = sorted(names - set(flat))
    if extra or missing:
        raise ValueError(f"{cfg.name}: leaves missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    leaves = []
    for name, meta in want:
        arr = np.asarray(flat[name])
        if tuple(arr.shape) != tuple(meta.shape):
            raise ValueError(f"{cfg.name}: {name} has shape {arr.shape}, "
                             f"the config's is {tuple(meta.shape)}")
        leaves.append(_tensor(arr).to(device=device, dtype=meta.dtype))
    return tr.tree_unflatten(like, leaves)


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{path: array}`` of a parameter tree, bf16 leaves as f32."""
    out = {}
    for name, x in tr.tree_flatten_with_paths(params):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        out[name] = x.cpu().numpy()
    return out
