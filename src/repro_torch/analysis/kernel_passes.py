"""Kernel passes: launch-geometry invariants of the seven CUDA kernels.

Counterpart of ``repro/analysis/kernel_passes.py``. There, PK001-PK003
read each Pallas call's grid and BlockSpecs; here the same questions are
asked of *launch plans*. Each kernel package's ``ops.py`` exports
``launch_plan(...)`` (one ``Launch`` per ``<<<...>>>`` its C entry point
makes, the host arithmetic mirrored in Python) and ``analysis_cases()``
(the shapes to check it at). This module also reads the CUDA sources as
text, for each kernel's ``__launch_bounds__`` and each
``cudaFuncSetAttribute(<kernel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
...)``, evaluating plain ``constexpr int`` constants only. No kernel is
built or launched: the passes run on the CPU, and ``chip_smoke.py`` holds
the plans against the card's own launch records.

- **KG001**: a grid or block the launch cannot take: a block over 1024
  threads, over its ``__launch_bounds__`` or not a multiple of 32; a grid
  dimension over Hopper's limit; an empty grid for a non-empty input (the
  plans give no launch where the entry point launches none); or a tile
  kernel's grid that does not cover every record or site.
- **KG002**: an element offset the kernel forms past the index type it
  uses for that array (each case declares the type per array, read from
  the source). A real finding is fixed by having the wrapper refuse the
  shape with a ``ValueError``.
- **KG003**: dynamic shared memory over 48 KB with no opt-in in the
  source for that kernel (or none set before the launch); static plus
  dynamic over 227 KB; or ``minBlocks x (static + dynamic + the 1 KB the
  card reserves a block)`` over the SM's 228 KB, so the occupancy its
  ``__launch_bounds__`` promises cannot happen.

PK004 (races between grid steps) has no static counterpart: CUDA blocks
run in no order, and each kernel's result is held bit-equal to its plain
version on the card instead.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import pathlib
import re
from typing import Optional

from repro_torch.analysis import registry as lim
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import AnalysisContext, register_pass
from repro_torch.kernels._launch import H100_SMS

CSRC = pathlib.Path(__file__).resolve().parents[1] / "kernels" / "csrc"
_KERNEL_PACKAGES = ("segment_hist", "count_scatter", "powerlaw_sample",
                    "windowed_ratio")
INDEX_LIMITS = {"int32": 2**31 - 1, "uint32": 2**32 - 1, "int64": 2**63 - 1}

_CONSTEXPR = re.compile(r"constexpr\s+(?:int|unsigned|long long)\s+(\w+)\s*"
                        r"=\s*([^;]+);")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\(([^)]*)\)"
                     r"\s*)?(\w+)\s*\(")
_OPT_IN = re.compile(r"cudaFuncSetAttribute\(\s*([\w:]+)\s*,\s*"
                     r"cudaFuncAttributeMaxDynamicSharedMemorySize")
# a named namespace, to the comment that closes it
_NAMESPACE = re.compile(r"namespace\s+(\w+)\s*\{(.*?)\}\s*//\s*namespace\s+"
                        r"\1\b", re.S)


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """What the kernel passes read from one ``.cu`` file."""

    name: str
    constants: dict          # constexpr name -> int (the plain ones)
    bounds: dict             # kernel -> (max threads, min blocks or None)
    opt_in: frozenset        # kernels with a dynamic-shared-memory opt-in

    @property
    def kernels(self) -> set:
        return set(self.bounds)


def _eval_int(expr: str, constants: dict) -> Optional[int]:
    """A plain integer expression of literals and earlier constants, or
    None (casts, ``sizeof``, calls: not evaluated)."""
    expr = re.sub(r"(\d+)(?:LL|ll|u|U)\b", r"\1", expr.strip())
    try:
        tree = ast.parse(expr, mode="eval")
    except SyntaxError:
        return None
    ops = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
           ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: int(a / b),
           ast.FloorDiv: lambda a, b: int(a / b),
           ast.Mod: lambda a, b: a % b, ast.LShift: lambda a, b: a << b}

    def ev(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name) and node.id in constants:
            return constants[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in ops:
            return ops[type(node.op)](ev(node.left), ev(node.right))
        raise ValueError(ast.dump(node))

    try:
        return ev(tree.body)
    except (ValueError, ZeroDivisionError):
        return None


def parse_source(text: str, name: str = "") -> KernelSource:
    """The constants, ``__launch_bounds__`` and opt-ins of a CUDA source.
    A kernel inside a named namespace (closed by ``}  // namespace
    <name>``) is keyed by its qualified name, ``join::sample_kernel``."""
    constants = {}
    for const, expr in _CONSTEXPR.findall(text):
        value = _eval_int(expr, constants)
        if value is not None:
            constants[const] = value
    scopes = [(m.start(2), m.end(2), m.group(1))
              for m in _NAMESPACE.finditer(text)]
    bounds = {}
    for m in _GLOBAL.finditer(text):
        args, kernel = m.groups()
        # a kernel of a named namespace by its qualified name
        kernel = "".join(f"{ns}::" for a, b, ns in scopes
                         if a <= m.start() < b) + kernel
        if not args:
            bounds[kernel] = (None, None)
            continue
        vals = [_eval_int(a, constants) for a in args.split(",")]
        if None in vals:
            raise ValueError(f"{name}: __launch_bounds__({args}) of {kernel} "
                             f"is not a plain constant expression")
        bounds[kernel] = (vals[0], vals[1] if len(vals) > 1 else None)
    return KernelSource(name, constants, bounds,
                        frozenset(_OPT_IN.findall(text)))


def read_sources(csrc=CSRC) -> dict:
    """``{source name: KernelSource}`` of every ``.cu`` under ``csrc``."""
    return {p.stem: parse_source(p.read_text(), p.name)
            for p in sorted(pathlib.Path(csrc).glob("*.cu"))}


def kernel_analysis_cases() -> list:
    """All ``analysis_cases()`` of the four kernel packages: dicts of
    ``name``, ``source`` (the ``.cu`` file's stem), ``shape``, ``plan``
    (``sm_count -> [Launch]``), ``run`` (``device ->`` one wrapper call),
    ``index_types`` and ``static_smem``."""
    cases = []
    for pkg in _KERNEL_PACKAGES:
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        cases.extend(mod.analysis_cases())
    return cases


def check_launch(launch, case: dict, source: KernelSource) -> list:
    """KG001-KG003 over one planned launch of ``case``."""
    target = f"kernels:{case['name']}"
    k = launch.kernel
    findings = []

    def add(rule, where, message, fix_hint):
        findings.append(Finding(rule=rule, severity="error", target=target,
                                location=f"{k}/{where}", message=message,
                                fix_hint=fix_hint))

    if k not in source.bounds:
        add("KG001", "source",
            f"the plan launches {k}, which {source.name} does not define",
            "name the kernel as its __global__ function is named")
        return findings
    max_threads, min_blocks = source.bounds[k]

    # KG001: the block
    threads = launch.block[0] * launch.block[1] * launch.block[2]
    bound = min(lim.MAX_THREADS_PER_BLOCK, max_threads or 2**31)
    if threads > bound or threads % lim.WARP_SIZE or threads < 1:
        add("KG001", "block",
            f"block {launch.block} has {threads} threads: over the "
            f"{bound} its __launch_bounds__ and the card allow, or not a "
            f"whole number of warps",
            "size the block from the kernel's own kThreads constant")
    # KG001: the grid
    gx, gy, gz = launch.grid
    if min(gx, gy, gz) < 1:
        add("KG001", "grid",
            f"grid {launch.grid} is empty for a non-empty input: the "
            f"launch is refused (or runs nothing) where the entry point "
            f"must run",
            "return before the launch for an empty input, or fix the "
            "grid arithmetic")
    elif gx > lim.MAX_GRID_X or max(gy, gz) > lim.MAX_GRID_YZ:
        add("KG001", "grid",
            f"grid {launch.grid} is past Hopper's limits (x up to "
            f"{lim.MAX_GRID_X}, y and z up to {lim.MAX_GRID_YZ}): the "
            f"launch is refused",
            "have the wrapper refuse the shape, or fold the axis into a "
            "loop inside the block")
    for axis, (items, per_block) in zip("xyz", launch.covers):
        blocks = launch.grid["xyz".index(axis)]
        if blocks * per_block < items:
            add("KG001", f"grid.{axis}",
                f"{blocks} blocks of {per_block} along {axis} reach "
                f"{blocks * per_block} of {items} records or sites: the "
                f"last {items - blocks * per_block} are never computed",
                "round the block count up (ceil division)")

    # KG002: offsets against the declared index type of each array
    types = case["index_types"].get(k, {})
    for array, offset in launch.offsets.items():
        kind = types.get(array)
        if kind not in INDEX_LIMITS:
            add("KG002", array,
                f"no index type declared for {array} of {k}",
                "declare it in the ops.py INDEX_TYPES table, read from the "
                "source")
        elif offset > INDEX_LIMITS[kind]:
            add("KG002", array,
                f"{k} forms offsets up to {offset} into {array} in "
                f"{kind} (at most {INDEX_LIMITS[kind]}): the offset wraps "
                f"and the kernel reads or writes out of bounds",
                "have the wrapper refuse the shape with a ValueError, or "
                "form the offset in 64 bits")

    # KG003: shared memory
    static = case["static_smem"].get(k, 0)
    dyn = launch.dynamic_smem
    if dyn > lim.SMEM_DEFAULT and (k not in source.opt_in
                                   or launch.opt_in is None
                                   or launch.opt_in < dyn):
        add("KG003", "smem",
            f"{dyn} bytes of dynamic shared memory, over "
            f"{lim.SMEM_DEFAULT} with no opt-in of that size before the "
            f"launch: the launch is refused",
            "call cudaFuncSetAttribute(kernel, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) first")
    if static + dyn > lim.SMEM_PER_BLOCK_OPTIN:
        add("KG003", "smem",
            f"{static} static + {dyn} dynamic bytes of shared memory, "
            f"over the {lim.SMEM_PER_BLOCK_OPTIN} a block may have",
            "shrink the tile, or have the wrapper refuse the shape")
    if min_blocks and min_blocks * (static + dyn
                                    + lim.SMEM_RESERVED_PER_BLOCK) \
            > lim.SMEM_PER_SM:
        add("KG003", "occupancy",
            f"__launch_bounds__ promises {min_blocks} blocks an SM, but "
            f"{min_blocks} x ({static} + {dyn} + "
            f"{lim.SMEM_RESERVED_PER_BLOCK}) bytes of shared memory are "
            f"over the SM's {lim.SMEM_PER_SM}",
            "lower minBlocks, or the shared memory a block takes")
    return findings


def check_case(case: dict, sources: Optional[dict] = None) -> list:
    """Plan one case for an H100 SXM's SMs and run KG001-KG003 on its
    launches.

    Exposed separately so tests can feed seeded-bug cases (a plan that
    misses a tile, a 64 KB launch with no opt-in) straight in.
    """
    sources = sources if sources is not None else read_sources()
    target = f"kernels:{case['name']}"
    source = sources.get(case["source"])
    if source is None:
        return [Finding(
            rule="KG001", severity="error", target=target, location="source",
            message=f"no CUDA source {case['source']}.cu",
            fix_hint="name the case's source as its file is named")]
    try:
        launches = case["plan"](H100_SMS)
    except ValueError as exc:
        return [Finding(
            rule="KG001", severity="error", target=target, location="plan",
            message=f"the wrapper refuses the case's shape: {exc}",
            fix_hint="check the case at a shape the wrapper takes")]
    findings = []
    for launch in launches:
        findings.extend(check_launch(launch, case, source))
    return findings


# ------------------------------------------------------------- on the card
def card_attributes(source: str) -> dict:
    """What the card reports for each kernel of ``source`` (its library's
    ``kernel_attributes``: static shared bytes, registers, largest block)."""
    from repro_torch.kernels.count_scatter import ops as cs_ops
    from repro_torch.kernels.powerlaw_sample import ops as ps_ops
    from repro_torch.kernels.segment_hist import ops as sh_ops
    from repro_torch.kernels.windowed_ratio import ops as wr_ops

    if source == "count_scatter":
        return cs_ops.attributes()
    if source == "powerlaw_sample":
        return ps_ops.attributes()
    if source.startswith("segment_hist"):
        return sh_ops.attributes(source)
    return wr_ops.attributes(source)


def kernel_name(profiled: str) -> str:
    """``count_tiles_kernel`` of the profiler's ``(anonymous namespace)::
    count_tiles_kernel(int const*, ...)``; a kernel of a namespace nested
    in the anonymous one keeps that namespace (``join::sample_kernel``)."""
    return profiled.split("(", 2)[-2].split(")::", 1)[-1].strip() \
        if profiled.startswith("(") else profiled.split("(")[0].rsplit(
            "::", 1)[-1]


def card_launches(case: dict, device, kernels: set, trace_path) -> list:
    """Run the case's wrapper once under ``torch.profiler`` and return the
    launch records of ``kernels`` in order: ``{kernel, grid, block,
    smem, registers}`` as the profiler (kineto, from CUPTI) gives them;
    its ``shared memory`` is static plus dynamic.

    Raises where the trace lacks the kernel record of a launch it saw:
    once a process's first profiled session is a minute or so old, the
    profiler drops the first kernel records of each session
    (``tools/profiler_record_probe.py``). Take the records in a fresh
    process instead (:func:`card_launches_in_child`).
    """
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        case["run"](device)
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    launched = {e["args"].get("correlation") for e in events
                if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")}
    kernel_events = [e for e in events if e.get("cat") == "kernel"]
    dropped = launched - {e["args"].get("correlation")
                          for e in kernel_events}
    if dropped:
        raise RuntimeError(
            f"{case['name']}: the profiler dropped {len(dropped)} of "
            f"{len(launched)} kernel records; take them in a fresh "
            f"process (card_launches_in_child)")
    out = []
    for e in sorted(kernel_events, key=lambda e: e["ts"]):
        name = kernel_name(e["name"])
        if name not in kernels:
            continue
        args = e.get("args", {})
        out.append({"kernel": name, "grid": tuple(args["grid"]),
                    "block": tuple(args["block"]),
                    "smem": args["shared memory"],
                    "registers": args["registers per thread"]})
    return out


def card_launches_in_child() -> dict:
    """:func:`card_launches` of every analysis case in a fresh process
    that profiles nothing else (``python -m
    repro_torch.analysis.card_launches``): ``{case name: records}``."""
    import json
    import os
    import subprocess
    import sys
    import tempfile

    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "records.json"
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.card_launches",
             "--out", str(out)],
            capture_output=True, text=True, timeout=600, env=env)
        if r.returncode != 0:
            raise RuntimeError(f"the launch-record child exited "
                               f"{r.returncode}:\n{r.stderr[-3000:]}")
        records = json.loads(out.read_text())
    return {name: [{**rec, "grid": tuple(rec["grid"]),
                    "block": tuple(rec["block"])} for rec in recs]
            for name, recs in records.items()}


# a thread is given at least this many registers: the profiler reports
# what was given (on an H100, direct_kernel compiles to 14 and is given 16)
MIN_REGISTERS = 16


def compare_with_card(case: dict, records: list, attrs: dict,
                      sm_count: int) -> list:
    """The differences between a case's launch plan, for a card of
    ``sm_count`` SMs, and that card's launch records (``card_launches``)
    and kernel attributes (``card_attributes``): grid, block, static +
    dynamic shared memory, registers, and the static-shared table of its
    ``ops.py``. Empty when they agree."""
    plan = case["plan"](sm_count)
    diffs = []
    if [l.kernel for l in plan] != [r["kernel"] for r in records]:
        return [f"{case['name']}: planned {[l.kernel for l in plan]}, the "
                f"card launched {[r['kernel'] for r in records]}"]
    for launch, rec in zip(plan, records):
        k = launch.kernel
        static = case["static_smem"][k]
        want = {"grid": launch.grid, "block": launch.block,
                "smem": static + launch.dynamic_smem,
                "registers": max(attrs[k]["registers"], MIN_REGISTERS)}
        for key, value in want.items():
            if rec[key] != value:
                diffs.append(f"{case['name']}: {k} {key} {rec[key]} on the "
                             f"card, {value} planned")
        if attrs[k]["static_smem"] != static:
            diffs.append(f"{case['name']}: {k} has {attrs[k]['static_smem']}"
                         f" static shared bytes on the card, {static} in "
                         f"the ops.py table")
    return diffs


@register_pass("launch-geometry", "kernels", ("KG001", "KG002", "KG003"),
               doc="grid, block, index-type and shared-memory invariants of "
                   "the seven CUDA kernels' launch plans")
def kernels_pass(ctx: AnalysisContext) -> list:
    sources = read_sources()
    findings = []
    for case in kernel_analysis_cases():
        findings.extend(check_case(case, sources))
    return findings
