#!/usr/bin/env python3
"""A model's blocks as a pipeline over a gang of processes: each rank
saves what it got.

    PYTHONPATH=src python tools/pipeline_gang.py --num-processes N \\
        --arch llama3_8b [--smoke] [--f32] [--layers L] --stages S \\
        --microbatches M --batch B --seq T --device cpu|cuda --out DIR \\
        [--runs R] [--save-output] [--record] [--collectives] \
        [--timeout SECONDS]

Without ``--process-id`` (and with ``--num-processes N > 1``) this is a
spawn parent: it forks N ranks of itself joined over gloo
(``repro_torch.launch.coordinator``) and exits with the gang's status (124
on a timeout). ``--num-processes 1`` runs the pipeline in this one
process. The S stages are the nodes of a ``NodeGroup``: a rank holds S/N
contiguous stages of ``L/S`` blocks each (``transformer.block_apply``,
layer ``stage * L/S + j``), built from its own stages' generators only
(``stage_blocks``: stage i's blocks come from a generator seeded
``MODEL_SEED + i``, so every gang and the one-process run hold the same
weights). Each rank feeds the same ``[B, T, d_model]`` hidden states
(``hidden_states``) through ``distributed.pipeline_apply`` in M
microbatches under ``torch.no_grad``: once to check, then ``--runs``
timed runs, each after a barrier, with the group's ``ExchangeClock``
summed over them.

Rank k writes ``DIR/rank{k}.json``: a digest of its output's bytes
(``launch.mesh.checksum``), the timed runs' ms, the clock, the stages it
held and peak device memory; with ``--save-output`` also
``DIR/rank{k}.npz`` holding the output as float32. ``--record`` keeps the
first run's collectives as ``analysis.collective_passes`` records them;
``--collectives`` also runs ``common.nodes.ppermute`` over the rank's rows
of ``collective_input`` on JAX's ring and on :func:`partial_perm`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.common import nodes  # noqa: E402
from repro_torch.common.nodes import NodeGroup, resolve_device  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed import PipelineConfig, pipeline_apply  # noqa: E402
from repro_torch.launch import coordinator, mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MODEL_SEED = 30
INPUT_SEED = 31


def model_cfg(arch: str, *, smoke: bool = False, layers=None,
              f32: bool = False):
    """``arch``'s config (published or smoke widths), cut to ``layers``
    blocks, at f32 if asked."""
    import dataclasses

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


def stage_blocks(cfg, stages, per_stage: int, device, seed: int = MODEL_SEED):
    """The blocks of ``stages`` (global stage indices, ascending), as a
    tree whose leaves are ``[len(stages), per_stage, ...]`` on ``device``:
    stage i's ``per_stage`` blocks drawn in order from a generator on
    ``device`` seeded ``seed + i``. Each block is written into its slice
    as soon as it is made."""
    stages = list(stages)
    out = None
    for a, i in enumerate(stages):
        gen = torch.Generator(device=device).manual_seed(seed + i)
        rng = L.ParamRng(gen, device)
        for j in range(per_stage):
            p, _ = T.block_init(rng, cfg, i * per_stage + j)
            if out is None:
                out = _alloc(p, (len(stages), per_stage))
            _copy(out, p, a, j)
            del p
    return out


def _alloc(tree, lead):
    if isinstance(tree, dict):
        return {k: _alloc(v, lead) for k, v in tree.items()}
    return torch.empty(lead + tuple(tree.shape), dtype=tree.dtype,
                       device=tree.device)


def _copy(out, tree, a: int, j: int) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _copy(out[k], v, a, j)
        else:
            out[k][a, j].copy_(v)


def blocks_fn(cfg, per_stage: int):
    """The pipeline's ``fn``: stage ``stage``'s ``per_stage`` blocks
    (leaves ``[per_stage, ...]``) applied in order."""

    def fn(params, x, stage: int):
        for j in range(per_stage):
            x = T.block_apply(T._index(params, j), cfg,
                              stage * per_stage + j, x)
        return x

    return fn


def hidden_states(cfg, batch: int, seq: int, device,
                  seed: int = INPUT_SEED) -> torch.Tensor:
    """``[batch, seq, d_model]`` standard normals drawn on the CPU from
    ``seed``, in the config's compute dtype on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen)
    return x.to(device=device, dtype=getattr(torch, cfg.compute_dtype))


def sequential(fn, params, x: torch.Tensor, stages: int) -> torch.Tensor:
    """``x`` through every stage in turn (``params``' leaves ``[stages,
    ...]``): the pipeline's reference."""
    for i in range(stages):
        x = fn(T._index(params, i), x, i)
    return x


def collective_input(stages: int) -> torch.Tensor:
    """``[stages, 3]`` float32 rows, one a stage, for the ppermute check."""
    return torch.arange(1, 3 * stages + 1, dtype=torch.float32).reshape(
        stages, 3)


def partial_perm(stages: int) -> list:
    """Every even stage sends two stages on; the odd stages get zeros."""
    return [(i, (i + 2) % stages) for i in range(0, stages, 2)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rank(args, device, group) -> tuple:
    cfg = model_cfg(args.arch, smoke=args.smoke, layers=args.layers,
                    f32=args.f32)
    if cfg.num_layers % args.stages:
        raise SystemExit(f"--stages {args.stages} must divide the "
                         f"{cfg.num_layers} blocks")
    per = cfg.num_layers // args.stages
    first = group.first if group is not None else 0
    local = group.local if group is not None else args.stages
    t0 = time.perf_counter()
    params = stage_blocks(cfg, range(first, first + local), per, device)
    x = hidden_states(cfg, args.batch, args.seq, device)
    _sync(device)
    build_s = time.perf_counter() - t0
    pcfg = PipelineConfig(num_stages=args.stages,
                          num_microbatches=args.microbatches)
    fn = blocks_fn(cfg, per)
    records = None
    with torch.no_grad():
        if args.record:
            from repro_torch.analysis.collective_passes import (
                record_collectives,
            )

            with record_collectives() as recs:
                out = pipeline_apply(fn, params, x, pcfg, group)
            records = [r.to_dict() for r in recs]
        else:
            out = pipeline_apply(fn, params, x, pcfg, group)
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        clock = group.clock if group is not None else None
        if clock is not None:
            clock.reset()
        ms = []
        for _ in range(args.runs):
            if group is not None:
                torch.distributed.barrier()
            t0 = time.perf_counter()
            again = pipeline_apply(fn, params, x, pcfg, group)
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(again, out):
                raise SystemExit("a timed run's output differs from the "
                                 "first run's")
    result = {
        "rank": group.rank if group is not None else 0,
        "world": group.world if group is not None else 1,
        "stages": list(range(first, first + local)),
        "digest": mesh.checksum([out]),
        "shape": list(out.shape), "dtype": str(out.dtype),
        "build_s": build_s, "ms": ms,
        "clock": clock.as_dict() if clock is not None else None,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "records": records,
    }
    if args.collectives:
        rows = (group or NodeGroup(args.stages)).rows(
            collective_input(args.stages).reshape(-1)).to(device)
        result["ppermute_ring"] = nodes.ppermute(rows, None,
                                                 group).tolist()
        result["ppermute_partial"] = nodes.ppermute(
            rows, partial_perm(args.stages), group).tolist()
    return result, out


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    coordinator.add_arguments(ap)
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke widths")
    ap.add_argument("--f32", action="store_true",
                    help="f32 parameters and compute")
    ap.add_argument("--layers", type=int, default=None,
                    help="blocks in all (default: the config's)")
    ap.add_argument("--stages", type=int, required=True)
    ap.add_argument("--microbatches", type=int, required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--runs", type=int, default=0,
                    help="timed runs after the first")
    ap.add_argument("--save-output", action="store_true")
    ap.add_argument("--record", action="store_true",
                    help="record the first run's collectives")
    ap.add_argument("--collectives", action="store_true",
                    help="also run ppermute over seeded rows")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", required=True, metavar="DIR")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the spawn parent waits for the gang")
    args = ap.parse_args(argv)
    if args.stages % args.num_processes:
        ap.error(f"--stages {args.stages} must divide evenly over "
                 f"--num-processes {args.num_processes}")
    cfg = coordinator.bootstrap([__file__, *argv], timeout=args.timeout)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", (cfg.process_id or 0)
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    group = (NodeGroup(args.stages, rank=cfg.process_id,
                       world=cfg.num_processes)
             if cfg.is_distributed else None)
    print(f"[{coordinator.process_banner(cfg)}] on {device}", flush=True)
    result, out = run_rank(args, device, group)
    dest = pathlib.Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    rank = cfg.process_id or 0
    (dest / f"rank{rank}.json").write_text(json.dumps(result))
    if args.save_output:
        np.savez(dest / f"rank{rank}.npz",
                 out=out.to(torch.float32).cpu().numpy())
    if cfg.is_distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
