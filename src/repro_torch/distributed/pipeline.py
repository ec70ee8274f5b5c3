"""GPipe-style pipeline parallelism: stages over microbatches.

Counterpart of ``repro/distributed/pipeline.py``. Layers are split into
``num_stages`` contiguous stages and microbatches stream through them on
JAX's schedule: ``m + s - 1`` ticks, stage i running microbatch ``t - i``
at tick t, the last stage writing microbatch ``t - s + 1``'s result. The
bubble is the standard ``(s - 1) / (m + s - 1)`` fraction of a stage's
ticks.

The stages are the nodes of a :class:`~repro_torch.common.nodes.NodeGroup`:

- **one process** (``group=None``): every stage is here, as the port
  holds P nodes along a leading axis, and a tick's hand-off from stage i
  to stage i+1 is the tensor itself, handed on;
- **a gang** (``group`` over ``num_stages`` nodes): a rank holds the
  contiguous stages ``group.first .. group.first + group.local - 1``. A
  hand-off within a rank stays in memory; a hand-off across ranks is
  ``common.nodes.ppermute`` (JAX's ``lax.ppermute``) over the ranks'
  boundary stages, a gloo send and receive staged through pinned host
  memory. JAX's final ``psum`` over stages, whose other stages hold
  zeros, is ``common.nodes.broadcast`` from the rank of the last stage.

JAX computes junk on bubble ticks (stage 0 on zeros after the last
microbatch, the others on zeros before the first arrives) and never
writes it. This port skips those (stage, tick) pairs, and in a gang their
sends: a tick's ``ppermute`` carries only the pairs whose sender ran a
microbatch, which every rank derives from the same schedule. ``fn`` must
be a function of its arguments, as it is under JAX's ``scan``, so the
output is JAX's.

Forward only, like the JAX package's only use of it
(``tests/md_scripts/pipeline_check.py``): a gloo hand-off carries no
autograd, and no backward is defined. Everything runs on the device of
``x`` and the parameters; nothing here picks a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.common import nodes as nodes_lib
from repro_torch.common import tree as tr
from repro_torch.common.nodes import NodeGroup


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_stages: int
    num_microbatches: int
    axis_name: str = "pipe"


def _stage_params(stage_params, i: int):
    return tr.tree_unflatten(stage_params,
                             [x[i] for x in tr.tree_leaves(stage_params)])


def schedule(num_stages: int, num_microbatches: int, tick: int) -> list:
    """``(stage, microbatch)`` of every stage that runs at ``tick``: stage
    i runs microbatch ``tick - i`` when that is one of the m."""
    return [(i, tick - i) for i in range(num_stages)
            if 0 <= tick - i < num_microbatches]


def pipeline_apply(fn: Callable[[Any, torch.Tensor, int], torch.Tensor],
                   stage_params: Any,
                   x: torch.Tensor,
                   cfg: PipelineConfig,
                   group: Optional[NodeGroup] = None) -> torch.Tensor:
    """Run ``fn(params_for_stage, microbatch, stage)`` as a pipeline.

    - ``stage_params``: a tree whose leaves have a leading axis of the
      stages this process holds (``num_stages`` in one process,
      ``group.local`` in a gang), in stage order.
    - ``x``: ``[num_microbatches * mb, ...]``, the global batch (in a
      gang, the same on every rank; only stage 0's rank reads it).
    - ``stage``: the global stage index, a Python int.

    Returns ``fn(...(fn(x)))`` through all stages, in x's shape and dtype,
    on every process.
    """
    s, m = cfg.num_stages, cfg.num_microbatches
    if m < 1 or x.shape[0] % m:
        raise ValueError(f"pipeline_apply: a batch of {x.shape[0]} does "
                         f"not split into {m} microbatches")
    group = nodes_lib.group_of(group, s)
    for path, leaf in tr.tree_flatten_with_paths(stage_params):
        if leaf.ndim == 0 or leaf.shape[0] != group.local:
            raise ValueError(
                f"pipeline_apply: stage_params leaf {path or '<root>'} of "
                f"shape {tuple(leaf.shape)} has no leading axis of the "
                f"{group.local} stages this process holds (of "
                f"num_stages={s})")
    mb = x.shape[0] // m
    xs = x.reshape(m, mb, *x.shape[1:])
    out = torch.zeros_like(xs)
    params = [_stage_params(stage_params, j) for j in range(group.local)]
    first, last = group.first, group.first + group.local - 1
    # rank boundaries: one node a rank, for the hand-offs between ranks
    edge = NodeGroup(group.world, rank=group.rank, world=group.world,
                     clock=group.clock)
    cur = {}                         # stage -> its input at this tick
    for t in range(m + s - 1):
        nxt, sent = {}, None
        for i, k in schedule(s, m, t):
            if not first <= i <= last:
                continue
            y = fn(params[i - first], xs[k] if i == 0 else cur.pop(i), i)
            if y.shape != xs.shape[1:] or y.dtype != x.dtype:
                raise ValueError(
                    f"pipeline_apply: stage {i} returned {y.dtype} "
                    f"{tuple(y.shape)}; a stage keeps its microbatch's "
                    f"{x.dtype} {tuple(xs.shape[1:])}, as JAX's scan carry "
                    f"does")
            if i == s - 1:
                out[k] = y
            elif i < last:
                nxt[i + 1] = y
            else:
                sent = y
        cur = nxt
        if not group.distributed:
            continue
        # stage i hands microbatch t - i on at tick t when it ran one
        pairs = [(i // group.local, i // group.local + 1)
                 for i, _ in schedule(s, m, t)
                 if i < s - 1 and (i + 1) % group.local == 0]
        if not pairs:
            continue
        # a rank that sends nothing this tick still passes a row
        row = sent if sent is not None else out[0]
        got = nodes_lib.ppermute(row[None], pairs, edge)[0]
        if first > 0 and any(d == group.rank for _, d in pairs):
            cur[first] = got
    out = nodes_lib.broadcast(out, s - 1, group)
    return out.reshape(m * mb, *x.shape[1:])
