"""Multi-pod dry run: every (architecture x input shape) cell priced on both
production meshes, on ``meta`` tensors.

Counterpart of ``repro/launch/dryrun.py``. For every cell, on the
single-pod (data 16 x model 16, 256 devices) and the multi-pod mesh (pod 2
x data 16 x model 16, 512 devices), JAX lowers and compiles the cell's
step with its shardings and reads the compiled program's memory and cost
analyses. Eager PyTorch has no compiler, so here the "lowering" is the
step's inputs and state as ``meta`` tensors (``models/steps.py``
``input_specs``, ``params_specs``) and a sharding is the port's partition
tuple (``models/sharding.py`` ``param_shardings`` under ``sharding_ctx``
with the cell's rules and overrides; ``batch_shardings`` below). From
them a cell gives:

- ``memory_analysis.argument_size_in_bytes``: the bytes of every input
  and state leaf's shard on one device, summed (JAX's compiled
  ``argument_size_in_bytes``, the same quantity);
- ``flop_counter_flops``: the step's FLOPs by
  ``torch.utils.flop_counter.FlopCounterMode`` over the step run on
  ``meta`` (matrix products and attention as the eager code computes
  them, rematerialisation included), and ``flop_counter_flops_per_device``
  that count split evenly over the mesh. This is not JAX's
  ``hlo_flops_per_device`` (a trip-count-aware count of the partitioned
  HLO), hence the new name;
- ``fits_h100_80gb``: whether the arguments alone fit one H100's 80 GB of
  HBM3 (:data:`H100_HBM_BYTES`).

JAX's ``temp_size_in_bytes``, ``hlo_hbm_bytes_per_device`` and
``collectives`` are left out: they are read from a compiled program, and
none exists here (each cell's JSON says so under ``not_measured``).

The dry run touches no device, as JAX's touches only forced host devices:
every tensor is on ``meta``. That is why it takes no ``--device``.

The MalStone cells (``--malstone``, ``--malstone-only``) give the
per-node argument bytes of the paper's B10 log (10 billion records) on
the same meshes, every device one node. A 256- or 512-node lowering of
the MalStone step has no eager counterpart (ROADMAP.md Queue 1 item 9f),
so their temporaries, FLOPs and collectives are not given.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--multi-pod | --both-meshes] \\
        [--malstone | --malstone-only] [--out results/dryrun_torch]

With no ``--arch`` or ``--shape`` it runs every arch and shape, so
``--both-meshes --malstone`` runs every cell.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Optional, Sequence

import torch

from repro_torch.common import tree as tr
from repro_torch.configs import ALIASES, get_config
from repro_torch.launch.mesh import batch_axes, make_production_mesh
from repro_torch.models import steps as S
from repro_torch.models.sharding import (
    MeshShape,
    param_shardings,
    sharding_ctx,
)
from repro_torch.models.steps import (
    SHAPES,
    InputShape,
    input_specs,
    shape_applicable,
)
from repro_torch.optim import AdamWConfig, OptState

# grok's optimizer state only fits a single 256-chip pod with bf16 moments
# (DESIGN.md §6); everything else uses fp32 moments.
MOMENT_DTYPE = {"grok-1-314b": "bfloat16"}

# One H100 SXM5's device memory: 80 GB of HBM3 (NVIDIA H100 Tensor Core
# GPU data sheet).
H100_HBM_BYTES = 80 * 10**9
H100_HBM_SOURCE = "NVIDIA H100 Tensor Core GPU data sheet: H100 SXM 80GB HBM3"

NOT_COMPILED = ("eager PyTorch compiles no program to read it from "
                "(JAX reads it from the compiled HLO)")
NOT_MEASURED = {"temp_size_in_bytes": NOT_COMPILED,
                "hlo_hbm_bytes_per_device": NOT_COMPILED,
                "collectives": NOT_COMPILED}


def _opt_cfg(cfg):
    return AdamWConfig(moment_dtype=MOMENT_DTYPE.get(cfg.name, "float32"))


def batch_shardings(spec_tree, mesh: MeshShape, global_batch: int,
                    baxes=None):
    """Shard the leading dim equal to global_batch over (pod, data) — or
    the explicitly supplied axes; replicate everything else. A tree like
    ``spec_tree`` of partition tuples."""
    baxes = tuple(a for a in (baxes or batch_axes(mesh)) if a in mesh)
    bsize = math.prod(mesh[a] for a in baxes)

    def one(leaf):
        shape = tuple(leaf.shape)
        if (global_batch > 1 and shape and shape[0] == global_batch
                and global_batch % bsize == 0):
            return (baxes,)
        if (global_batch > 1 and len(shape) >= 2
                and shape[0] != global_batch and shape[1] == global_batch
                and global_batch % bsize == 0):
            # stacked-layer cache leaves: [R, B, ...]
            return (None, baxes)
        return ()

    return tr.tree_unflatten(spec_tree,
                             [one(x) for x in tr.tree_leaves(spec_tree)])


def state_shardings(cfg, mesh: MeshShape, with_opt: bool):
    """Partition tuples for TrainState (params + optimizer moments share
    the param layout; the step counter is replicated)."""
    axes = S.params_axes(cfg)
    pspecs = S.params_specs(cfg, with_opt=with_opt,
                            opt_cfg=_opt_cfg(cfg) if with_opt else None)
    if not with_opt:
        return param_shardings(pspecs, axes, mesh)
    return S.TrainState(
        params=param_shardings(pspecs.params, axes, mesh),
        opt=OptState(step=(), mu=param_shardings(pspecs.opt.mu, axes, mesh),
                     nu=param_shardings(pspecs.opt.nu, axes, mesh)))


def _shape_of(shape_name) -> InputShape:
    return (shape_name if isinstance(shape_name, InputShape)
            else SHAPES[shape_name])


def step_and_args(cfg, shape_name):
    """``(step, args)``: the cell's step and its arguments as ``meta``
    tensors. ``shape_name`` names one of ``SHAPES`` or is an
    ``InputShape``."""
    sh = _shape_of(shape_name)
    ispec = input_specs(cfg, sh)
    if sh.kind == "train":
        opt_cfg = _opt_cfg(cfg)
        return (S.make_train_step(cfg, opt_cfg),
                (S.params_specs(cfg, with_opt=True, opt_cfg=opt_cfg), ispec))
    p_spec = S.params_specs(cfg, with_opt=False)
    if sh.kind == "prefill":
        prefix = cfg.num_patches if cfg.family == "vlm" else 0
        return (S.make_prefill_step(cfg, max_len=sh.seq_len + prefix + 8),
                (p_spec, ispec))
    args = (p_spec, ispec["token"], ispec["cache"])
    if cfg.is_encoder_decoder:
        args += (ispec["enc_out"],)
    return S.make_decode_step(cfg), args


def build_lowerable(cfg, shape_name, mesh: MeshShape, baxes=None):
    """Returns (fn, example_args, in_shardings) for the cell's step: the
    arguments on ``meta``, the shardings partition tuples in the same
    structure."""
    sh = _shape_of(shape_name)
    fn, args = step_and_args(cfg, sh)
    if sh.kind == "train":
        return fn, args, (state_shardings(cfg, mesh, with_opt=True),
                          batch_shardings(args[1], mesh, sh.global_batch,
                                          baxes))
    p_sh = state_shardings(cfg, mesh, with_opt=False)
    if sh.kind == "prefill":
        return fn, args, (p_sh, batch_shardings(args[1], mesh,
                                                sh.global_batch))
    return fn, args, (p_sh,) + tuple(
        batch_shardings(a, mesh, sh.global_batch) for a in args[1:])


def _at(tree, path: str):
    """The subtree of ``tree`` at a ``tree_flatten_with_paths`` path."""
    for key in path.split("/") if path else ():
        if isinstance(tree, dict):
            tree = tree[key]
        elif hasattr(type(tree), "_fields"):
            tree = getattr(tree, key)
        else:
            tree = tree[int(key)]
    return tree


def shard_shape(shape: Sequence[int], spec: tuple,
                mesh: MeshShape) -> tuple:
    """One device's shard of a ``shape`` tensor under partition ``spec``
    (trailing dims unnamed are whole)."""
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        size = math.prod(mesh[a] for a in axes)
        if out[i] % size:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {axes} ({size})")
        out[i] //= size
    return tuple(out)


def leaf_shards(args, shardings, mesh: MeshShape) -> list:
    """``(path, tensor, spec, shard shape)`` for every argument leaf, paths
    as ``common/tree.py`` names them (JAX's)."""
    out = []
    for path, leaf in tr.tree_flatten_with_paths(args):
        spec = _at(shardings, path)
        out.append((path, leaf, spec, shard_shape(leaf.shape, spec, mesh)))
    return out


def argument_bytes(args, shardings, mesh: MeshShape) -> int:
    """The bytes of every argument leaf's shard on one device."""
    return sum(math.prod(shard) * leaf.element_size()
               for _, leaf, _, shard in leaf_shards(args, shardings, mesh))


def _count_flops(cfg, sh: InputShape) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    fn, args = step_and_args(cfg, sh)
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


# the two short sequences an attention-free model's count is taken at
AFFINE_SEQS = (64, 128)


def _affine(points, x: int) -> int:
    """The value at ``x`` of the line through ``points`` (one point: its
    value), in integers; raises if the line has no integer slope."""
    if len(points) == 1:
        return points[0][1]
    (x1, f1), (x2, f2) = points
    slope, rest = divmod(f2 - f1, x2 - x1)
    if rest:
        raise ValueError(f"FLOPs {f1} at {x1} and {f2} at {x2}: no integer "
                         f"slope, so not affine")
    return f1 + (x - x1) * slope


@functools.lru_cache(maxsize=None)
def step_flops(cfg, shape_name, *, one_repetition: bool = True) -> int:
    """The FLOPs of the cell's step by ``FlopCounterMode`` over the step
    run on ``meta`` (the same on every mesh).

    With ``one_repetition``, a stacked model (its layer pattern repeated
    n > 2 times) is counted at one and at two repetitions: the difference
    is one repetition's FLOPs (the other repetitions run the same ops on
    the same shapes), so the total is ``one + (n - 1) * (two - one)``,
    exactly. An attention-free model (``cfg.is_attention_free``: each
    counted product acts on one token, or on a fixed window of them) is
    also counted at two short sequences, :data:`AFFINE_SEQS`, since its
    count is affine in the sequence length; rwkv6-7b's per-token loop,
    about a millisecond a token and layer on ``meta``, then takes seconds
    at ``prefill_32k`` instead of minutes."""
    sh = _shape_of(shape_name)
    period = cfg.uniform_period
    n_rep = cfg.num_layers // period if period < cfg.num_layers else 1
    if not one_repetition:
        return _count_flops(cfg, sh)
    reps = (1, 2) if n_rep > 2 else (n_rep,)
    seqs = (AFFINE_SEQS if cfg.is_attention_free and sh.kind != "decode"
            and sh.seq_len > AFFINE_SEQS[1] else (sh.seq_len,))
    by_rep = []
    for r in reps:
        c = (dataclasses.replace(cfg, num_layers=r * period) if r != n_rep
             else cfg)
        by_rep.append((r, _affine(
            [(q, _count_flops(c, dataclasses.replace(sh, seq_len=q)))
             for q in seqs], sh.seq_len)))
    return _affine(by_rep, n_rep)


def _parse_overrides(items):
    out = []
    for it in items or ():
        name, _, ax = it.partition("=")
        if ax.lower() in ("none", ""):
            val = None
        elif "," in ax:
            val = tuple(a for a in ax.split(",") if a)
        else:
            val = ax
        out.append((name, val))
    return tuple(out)


def _fits(per_device: int) -> dict:
    return {"fits_h100_80gb": per_device <= H100_HBM_BYTES,
            "h100_hbm_bytes": H100_HBM_BYTES,
            "h100_hbm_source": H100_HBM_SOURCE}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, verbose: bool = True,
             param_overrides=(), act_overrides=(), q_chunk: int = 0) -> dict:
    cell = f"{arch_id}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    out_path = out_dir / f"{cell}.json"
    cfg = get_config(arch_id)
    if q_chunk:
        cfg = dataclasses.replace(cfg, attn_q_chunk=q_chunk)

    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        result = {"cell": cell, "status": "skipped", "reason": reason}
        out_path.write_text(json.dumps(result, indent=2))
        return result

    mesh = make_production_mesh(multi_pod=multi_pod)
    num_devices = math.prod(mesh.values())
    t0 = time.time()
    try:
        with sharding_ctx(
                mesh,
                param_overrides=tuple(cfg.sharding_rules) + tuple(
                    param_overrides),
                act_overrides=tuple(cfg.act_sharding_rules) + tuple(
                    act_overrides)):
            bx = None
            for nm, val in act_overrides:
                if nm == "batch":
                    bx = (val,) if isinstance(val, str) else val
            _, args, shardings = build_lowerable(cfg, shape_name, mesh,
                                                 baxes=bx)
            per_device = argument_bytes(args, shardings, mesh)
        t_build = time.time() - t0
        t1 = time.time()
        flops = step_flops(cfg, shape_name)
        t_flops = time.time() - t1
    except Exception as e:
        result = {"cell": cell, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-3000:]}
        out_path.write_text(json.dumps(result, indent=2))
        if verbose:
            print(f"[FAIL] {cell}: {e}", flush=True)
        return result

    result = {
        "cell": cell,
        "arch": arch_id,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "status": "ok",
        "num_devices": num_devices,
        "build_s": round(t_build, 2),
        "flops_s": round(t_flops, 2),
        "memory_analysis": {"argument_size_in_bytes": per_device},
        "flop_counter_flops": flops,
        "flop_counter_flops_per_device": flops / num_devices,
        **_fits(per_device),
        "model_params_total": cfg.num_params_total,
        "model_params_active": cfg.num_params_active,
        "not_measured": NOT_MEASURED,
    }
    out_path.write_text(json.dumps(result, indent=2))
    if verbose:
        print(f"[OK] {cell}: args/dev={per_device:.4g}B "
              f"flops/dev={flops / num_devices:.4g} "
              f"fits_h100={result['fits_h100_80gb']} "
              f"({t_build:.1f}+{t_flops:.1f}s)", flush=True)
    return result


MALSTONE_CLASSES = {
    # paper Table 2: B-10 = 10 billion 100-byte records (1 TB)
    "B10": dict(num_records=10_000_000_000, num_sites=120_000,
                statistic="B"),
    "A10": dict(num_records=10_000_000_000, num_sites=120_000,
                statistic="A"),
}
# The log columns the four backends read, each int32 (common/types.py
# EventLog). The mark is joined already (paper §4), so entity_id is not
# read; XLA drops that unread argument, which gives JAX's 12 bytes a record.
MALSTONE_COLUMNS = ("site_id", "timestamp", "mark")
MALSTONE_BACKENDS = ("streams", "sphere", "mapreduce", "mapreduce_combiner")


def run_malstone_cell(backend: str, klass: str, multi_pod: bool,
                      out_dir: pathlib.Path) -> dict:
    """The paper's own workload on the production mesh, every device one
    node: the per-node argument bytes of its log."""
    if backend not in MALSTONE_BACKENDS:
        raise ValueError(backend)
    cell = f"malstone-{klass}-{backend}__{'pod2' if multi_pod else 'pod1'}"
    out_path = out_dir / f"{cell}.json"
    mesh = make_production_mesh(multi_pod=multi_pod)
    parts = math.prod(mesh[a] for a in ("pod", "data", "model")
                      if a in mesh)
    spec = MALSTONE_CLASSES[klass]
    per_node = spec["num_records"] // parts
    record_bytes = len(MALSTONE_COLUMNS) * torch.int32.itemsize
    per_device = per_node * record_bytes
    result = {
        "cell": cell, "status": "ok", "arch": "malstone",
        "backend": backend, "klass": klass, "multi_pod": multi_pod,
        "num_devices": parts,
        "records_global": spec["num_records"],
        "num_sites": spec["num_sites"],
        "records_per_node": per_node,
        "columns": list(MALSTONE_COLUMNS),
        "memory_analysis": {"argument_size_in_bytes": per_device},
        **_fits(per_device),
        "not_measured": {
            k: (f"a {parts}-node lowering of the MalStone step has no "
                f"eager counterpart (ROADMAP.md Queue 1 item 9f)")
            for k in ("output_size_in_bytes", "temp_size_in_bytes",
                      "hlo_flops_per_device", "hlo_hbm_bytes_per_device",
                      "collectives")},
    }
    out_path.write_text(json.dumps(result, indent=2))
    print(f"[OK] {cell}: args/node={per_device}B "
          f"({per_node:,} records of {record_bytes} bytes)", flush=True)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="arch id (dashed or underscored); default: all")
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="input shape; default: all four")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--malstone", action="store_true",
                    help="also price the paper's workload (4 backends)")
    ap.add_argument("--malstone-only", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--param-override", action="append", default=[],
                    help="logical=axis rule override (axis 'none' to drop)")
    ap.add_argument("--act-override", action="append", default=[])
    ap.add_argument("--q-chunk", type=int, default=0,
                    help="override attention q_chunk (seq-parallel align)")
    args = ap.parse_args(argv)
    p_over = _parse_overrides(args.param_override)
    a_over = _parse_overrides(args.act_override)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = [args.arch] if args.arch else list(ALIASES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    if not args.malstone_only:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    cell = (f"{arch}__{shape}__{'pod2' if mp else 'pod1'}")
                    path = out_dir / f"{cell}.json"
                    if args.skip_existing and path.exists():
                        prev = json.loads(path.read_text())
                        if prev.get("status") in ("ok", "skipped"):
                            print(f"[SKIP-CACHED] {cell}", flush=True)
                            continue
                    res = run_cell(arch, shape, mp, out_dir,
                                   param_overrides=p_over,
                                   act_overrides=a_over,
                                   q_chunk=args.q_chunk)
                    if res["status"] == "error":
                        failures += 1
    if args.malstone or args.malstone_only:
        for backend in MALSTONE_BACKENDS:
            for mp in meshes:
                cell = (f"malstone-B10-{backend}__"
                        f"{'pod2' if mp else 'pod1'}")
                path = out_dir / f"{cell}.json"
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") == "ok":
                        print(f"[SKIP-CACHED] {cell}", flush=True)
                        continue
                run_malstone_cell(backend, "B10", mp, out_dir)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
