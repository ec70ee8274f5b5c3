"""Driver passes: run every driver eagerly at a tiny size and audit it.

Counterpart of ``repro/analysis/jaxpr_passes.py``. The JAX package traces
each driver to a jaxpr and reads the staged program; eager PyTorch stages
nothing, so the port runs each driver once, at JAX's tiny but
structurally faithful geometry (a multi-round shuffle, a multi-chunk
scan, padded sites), on the context's device (the CLI's ``--device``:
the card unless the caller asks for the CPU), and watches it run:

- **DR001**: a target raises.
- **DR002**: a field of ``HistogramState``, the backend carry or
  ``ShuffleStats`` changes dtype across a fold, or differs from its
  declared dtype (int32 tensors, and the ints ``capacity``, ``rounds``
  and ``chunks_folded``). This is the bug class of JAX's JX002: a stray
  promotion silently widens the carry, and in a gang the ranks'
  collectives then disagree on their dtype.
- **DR004**: host syncs over the budget the target declares. On the CPU a
  ``TorchFunctionMode`` counts the calls that wait for the device on the
  card (``item``, ``tolist``, ``__bool__``, ``__int__``, ``__index__``,
  ``__float__``, ``cpu``, a ``to`` onto the CPU from another device,
  ``numpy``, ``nonzero`` and boolean-mask indexing), and a patch counts
  ``torch.cuda.synchronize`` and ``Stream.synchronize``. Each budget is
  stated beside its target with its reason. On the card the family
  also runs under
  ``torch.cuda.set_sync_debug_mode("warn")`` and reports the card's count
  of synchronizing operations beside the recorder's.

JAX's JX003 (a donated argument the executable did not alias) has no
counterpart: eager PyTorch donates no buffers, so no DR003 is registered.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import sys
import traceback
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import AnalysisContext, register_pass

# JAX's trace geometry (jaxpr_passes.py:37-41) at P = 4 nodes
TINY_SITES = 8
TINY_ENTITIES = 16
TINY_RECORDS_PER_SHARD = 16
TINY_CHUNK_RECORDS = 8
TINY_NUM_WEEKS = 8
TINY_PARTS = 4
LOG_SEED = 0

BACKENDS = ("streams", "sphere", "mapreduce", "mapreduce_combiner")
_LOG_ENGINES = ("oneshot", "streaming")
_SEED_ENGINES = ("generated", "generated_streaming")

# Tensor methods and torch functions that wait for the device when their
# tensor lies on the card
_SYNC_CALLS = frozenset({"item", "tolist", "__bool__", "__int__",
                         "__index__", "__float__", "numpy", "cpu",
                         "nonzero", "argwhere", "masked_select"})


# ------------------------------------------------------------ host syncs
class SyncCounter(TorchFunctionMode):
    """Counts, by call name, the torch calls that are host syncs on the
    card (see the module docstring), and ``torch.cuda.synchronize`` /
    ``Stream.synchronize`` while :func:`count_syncs` holds it.

    ``device_type`` "cuda" counts only calls on CUDA tensors (on the card,
    where a host tensor's read waits for nothing); None counts every call
    (on the CPU, where every tensor stands for one on the card). Calls made
    inside a kernel's plain version (a function named ``*_plain``, which
    the card replaces with a launch) are counted apart, in ``plain``.
    """

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        self.device_type = device_type
        self.counts = collections.Counter()
        self.plain = 0

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        call = None
        if name in _SYNC_CALLS:
            call = name
        elif name == "to" and args and isinstance(args[0], torch.Tensor):
            target = torch._C._nn._parse_to(*args[1:], **kwargs)[0]
            if (target is not None and target.type == "cpu"
                    and args[0].device.type != "cpu"):
                call = "to(cpu)"
        elif name == "__getitem__" and len(args) > 1 and _has_mask(args[1]):
            call = "mask index"
        if call is not None and self._counts(args):
            if _in_plain_version():
                self.plain += 1
            else:
                self.counts[call] += 1
        return func(*args, **kwargs)

    def _counts(self, args) -> bool:
        t = args[0] if args and isinstance(args[0], torch.Tensor) else None
        return (self.device_type is None or t is None
                or t.device.type == self.device_type)


def _in_plain_version() -> bool:
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.endswith("_plain"):
            return True
        frame = frame.f_back
    return False


def _has_mask(index) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


@contextlib.contextmanager
def count_syncs(device_type: Optional[str] = None):
    """Yield a :class:`SyncCounter` active for the block, with
    ``torch.cuda.synchronize`` and ``torch.cuda.Stream.synchronize``
    counted too."""
    counter = SyncCounter(device_type)
    real_sync = torch.cuda.synchronize
    real_stream_sync = torch.cuda.Stream.synchronize

    def sync(*args, **kwargs):
        counter.counts["cuda.synchronize"] += 1
        return real_sync(*args, **kwargs)

    def stream_sync(self, *args, **kwargs):
        counter.counts["Stream.synchronize"] += 1
        return real_stream_sync(self, *args, **kwargs)

    torch.cuda.synchronize = sync
    torch.cuda.Stream.synchronize = stream_sync
    try:
        with counter:
            yield counter
    finally:
        torch.cuda.synchronize = real_sync
        torch.cuda.Stream.synchronize = real_stream_sync


@contextlib.contextmanager
def card_sync_warnings():
    """On the card: yield a list that receives one entry per synchronizing
    operation ``torch.cuda.set_sync_debug_mode("warn")`` reports."""
    seen: list = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
        seen.extend(w for w in caught
                    if "synchronizing CUDA operation" in str(w.message))
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------- dtypes
# the declared type of every leaf: the carry, ShuffleStats' counters and
# HistogramState's carry are int32 tensors; ShuffleStats' capacity and
# rounds on a result, and the chunk cursor, are ints
_INT_FIELDS = ("capacity", "rounds", "chunks_folded")


def leaf_types(tree) -> dict:
    """``{path: dtype name or Python type name}`` of a state or stats."""
    from repro_torch.common.tree import tree_flatten_with_paths

    return {path: (str(leaf.dtype).replace("torch.", "")
                   if isinstance(leaf, torch.Tensor) else type(leaf).__name__)
            for path, leaf in tree_flatten_with_paths(tree)}


def declared_type(path: str, carry: bool) -> str:
    """The declared type of a leaf: inside a carry every leaf is an int32
    tensor (its ShuffleStats too, one value a node); on a result,
    ``capacity`` and ``rounds`` are ints, as is a state's cursor."""
    last = path.rsplit("/", 1)[-1]
    if last == "chunks_folded" or (not carry and last in _INT_FIELDS):
        return "int"
    return "int32"


def check_types(before: Optional[dict], after: dict, target: str,
                where: str, *, carry: bool = True) -> list:
    """DR002 over one fold (``before`` None: a result, no fold)."""
    findings = []
    for path, kind in after.items():
        want = declared_type(path, carry)
        old = None if before is None else before.get(path)
        if old is not None and old != kind:
            msg = (f"{path} changed from {old} to {kind} across {where}: "
                   f"a promotion crept into the fold")
        elif kind != want:
            msg = f"{path} is {kind}, declared {want}"
        else:
            continue
        findings.append(Finding(
            rule="DR002", severity="error", target=target,
            location=f"{where}/{path}", message=msg,
            fix_hint=("give every counter an explicit dtype=torch.int32 "
                      "(and sum with dtype=torch.int32); never mix in an "
                      "int64 tensor or a default-dtype constant")))
    return findings


@contextlib.contextmanager
def watch_folds(target: str, findings: list):
    """Patch ``core.streaming._accumulate_chunk`` (every fold of the
    streaming engine, the resumable runner and the service) to check its
    carry's types before and after each fold."""
    from repro_torch.core import streaming

    real = streaming._accumulate_chunk
    folds = [0]

    def fold(carry, *args, **kwargs):
        before = leaf_types(carry)
        out = real(carry, *args, **kwargs)
        findings.extend(check_types(before, leaf_types(out), target,
                                    f"fold#{folds[0]}"))
        folds[0] += 1
        return out

    streaming._accumulate_chunk = fold
    try:
        yield folds
    finally:
        streaming._accumulate_chunk = real


# --------------------------------------------------------------- targets
@dataclasses.dataclass
class DriverTarget:
    """A driver run: ``setup()`` makes its inputs (seeds, services, states;
    not counted), ``run(inputs)`` is what is watched, and ``budget(out)``
    gives the host syncs the run may make (from its result: the rounds
    its exchanges ran), for ``reason``."""

    run: Callable
    budget: Callable
    reason: str
    setup: Callable = lambda: None


def _tiny_log(device):
    from repro_torch.common.types import EventLog, SECONDS_PER_WEEK

    rng = np.random.default_rng(LOG_SEED)
    n = TINY_PARTS * TINY_RECORDS_PER_SHARD
    cols = {"site_id": rng.integers(0, TINY_SITES, n),
            "entity_id": rng.integers(0, TINY_ENTITIES, n),
            "timestamp": rng.integers(0, TINY_NUM_WEEKS * SECONDS_PER_WEEK,
                                      n),
            "mark": rng.integers(0, 2, n)}
    return EventLog(**{k: torch.tensor(v, dtype=torch.int32, device=device)
                       for k, v in cols.items()})


def _tiny_cfg():
    from repro_torch.malgen import MalGenConfig

    return MalGenConfig(num_sites=TINY_SITES, num_entities=TINY_ENTITIES)


def _rounds(out) -> int:
    """The rounds of a result's ShuffleStats, or the most of a state's
    per-node rounds; 0 without an exchange."""
    from repro_torch.core.backends import ShuffleStats
    from repro_torch.core.streaming import HistogramState

    if isinstance(out, HistogramState):
        carry = out.carry
        stats = carry[1] if isinstance(carry, tuple) else None
        return 0 if stats is None else int(stats.rounds.max())
    stats = out[1] if isinstance(out, tuple) and len(out) == 2 else None
    return int(stats.rounds) if isinstance(stats, ShuffleStats) else 0


# The budgets. On the card each of these is a wait for the queued work:
# - the exchange loop tests its gang-wide leftover on the host: one
#   global_count (int()) before the first round and one after each;
# - a result's exhaustion check reads its undelivered count once;
# - the streaming engine's snapshot reads capacity and rounds from the
#   per-node stats (post_scan_collective);
# - a service ingest hashes each node's chunk id into its Event-ID
#   namespace with a CPU int (a host tensor: counted here, no wait on
#   the card).
_EXCHANGE = "one global_count before the rounds and one a round"
_CHUNKS = TINY_RECORDS_PER_SHARD // TINY_CHUNK_RECORDS


def _engine_budget(engine: str, backend: str):
    """``(budget(out), reason)`` of an engine x backend run."""
    if backend != "mapreduce":
        return (lambda out: 0), "none: local combines and collectives only"
    if engine in ("oneshot", "generated"):
        return ((lambda out: _rounds(out) + 2),
                f"{_EXCHANGE}, and the exhaustion check's read")
    return ((lambda out: _CHUNKS * (_rounds(out) + 1) + 3),
            f"{_EXCHANGE}, for each of the {_CHUNKS} chunks (at most the "
            f"worst chunk's rounds each), the snapshot's reads of capacity "
            f"and rounds, and the exhaustion check's read")


def driver_targets(device) -> dict:
    """``name -> DriverTarget``: every engine x backend, the service's
    seed-mode ingest per backend, its snapshot and a query batch, and the
    language model's prefill with a decode step and its train step."""
    from repro_torch.core import run
    from repro_torch.malgen.seeding import make_seed

    device = torch.device(device)
    cfg = _tiny_cfg()
    targets = {}
    for engine in _LOG_ENGINES + _SEED_ENGINES:
        for backend in BACKENDS:
            kw = {}
            if engine in ("streaming", "generated_streaming"):
                kw["chunk_records"] = TINY_CHUNK_RECORDS
            if engine in _SEED_ENGINES:
                kw["records_per_shard"] = TINY_RECORDS_PER_SHARD

                def setup():
                    return make_seed(0, cfg, TINY_PARTS
                                     * TINY_RECORDS_PER_SHARD, device=device)
            else:
                def setup():
                    return _tiny_log(device)

            def go(source, engine=engine, backend=backend, kw=kw):
                return run(source, TINY_SITES if engine in _LOG_ENGINES
                           else None, nodes=TINY_PARTS, engine=engine,
                           backend=backend, cfg=cfg,
                           num_weeks=TINY_NUM_WEEKS, device=device,
                           return_shuffle_stats=True, **kw)

            budget, reason = _engine_budget(engine, backend)
            targets[f"drivers:{engine}/{backend}"] = DriverTarget(
                go, budget, reason, setup)
    targets.update(_serve_targets(device, cfg))
    targets.update(_lm_targets(device))
    return dict(sorted(targets.items()))


def _serve_targets(device, cfg) -> dict:
    from repro_torch.core.streaming import state_init
    from repro_torch.malgen.seeding import make_seed_streaming
    from repro_torch.serve import MalStoneService, batched_query

    num_chunks = TINY_PARTS * 2

    def service(backend):
        seed = make_seed_streaming(1, cfg, num_chunks, TINY_CHUNK_RECORDS,
                                   device=device)
        svc = MalStoneService(
            nodes=TINY_PARTS, num_sites=TINY_SITES,
            chunk_records=TINY_CHUNK_RECORDS, backend=backend,
            num_weeks=TINY_NUM_WEEKS, seed=seed, cfg=cfg,
            num_chunks=num_chunks, device=device)
        return svc, state_init(backend, svc.parts, svc.s_pad, svc.num_weeks,
                               svc.device)

    hashes = (f"the {TINY_PARTS} chunk hashes (host ints, no wait on the "
              f"card)")
    targets = {}
    for backend in BACKENDS:
        if backend == "mapreduce":
            budget = lambda out: TINY_PARTS + _rounds(out) + 1  # noqa: E731
            reason = f"{hashes}, and {_EXCHANGE}"
        else:
            budget, reason = (lambda out: TINY_PARTS), hashes
        targets[f"drivers:serve_ingest/{backend}"] = DriverTarget(
            lambda args: args[0].ingest_program(1)(args[1]), budget, reason,
            functools.partial(service, backend))

    def snapshot_setup():
        svc, state = service("mapreduce")
        return svc, svc.ingest_program(1)(state)

    def query_setup():
        n = 3
        g = torch.Generator().manual_seed(0)
        hist = torch.randint(0, 9, (TINY_SITES, TINY_NUM_WEEKS, 2),
                             generator=g, dtype=torch.int32)
        mask = torch.rand(n, TINY_NUM_WEEKS, generator=g) > 0.5
        return (hist.to(device), mask.to(device),
                torch.arange(n, dtype=torch.int32, device=device))

    targets["drivers:serve_snapshot/mapreduce"] = DriverTarget(
        lambda args: args[0].snapshot_program()(args[1]), lambda out: 2,
        "the snapshot's reads of capacity and rounds", snapshot_setup)
    targets["drivers:serve_query/ref"] = DriverTarget(
        lambda args: batched_query(args[0], args[1], args[1], args[2],
                                   max_top_k=2),
        lambda out: 0, "none: the answers stay on the device until wait()",
        query_setup)
    return targets


# The language model's serving and training steps, at gemma2's smoke
# config (a stacked layout, a local ring and a global cache, softcaps and
# the scaled embedding)
LM_ARCH = "gemma2_2b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN = 2, 20, 24


def _lm_targets(device) -> dict:
    from repro_torch.common.nodes import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decoding as D
    from repro_torch.models import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig

    cfg = get_smoke_config(LM_ARCH)

    def tokens():
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                             generator=g, dtype=torch.int32)
        return toks.to(resolve_device(device))

    def serve_setup():
        dev = resolve_device(device)
        params, _ = T.init_params(
            cfg, generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)
        return params, {"tokens": tokens()}

    def serve(args):
        params, batch = args
        logits, cache, enc_out = D.prefill(params, cfg, batch, LM_MAX_LEN)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
        return D.decode_step(params, cfg, tok.to(torch.int32), cache,
                             enc_out=enc_out)

    def train_setup():
        dev = resolve_device(device)
        state, _ = S.make_train_state(
            cfg, AdamWConfig(),
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
        toks = tokens()
        return state, {"tokens": toks, "labels": toks}

    step = S.make_train_step(cfg, AdamWConfig())
    return {
        f"drivers:lm_prefill_decode/{LM_ARCH}": DriverTarget(
            serve, lambda out: 0,
            "none: the cache's positions are 0-dim tensors read on the "
            "device, the greedy token never leaves it", serve_setup),
        f"drivers:lm_train_step/{LM_ARCH}": DriverTarget(
            lambda args: step(*args), lambda out: 0,
            "none: the loss, grad norm and learning rate stay on the "
            "device (the trainer reads the loss once, after the step)",
            train_setup),
    }


# ------------------------------------------------------------ the passes
@dataclasses.dataclass
class DriverRun:
    """One target's run: its output or exception, its host syncs (by
    call), the card's count where it ran there, and its DR002 findings."""

    out: object = None
    error: Optional[BaseException] = None
    syncs: dict = dataclasses.field(default_factory=dict)
    plain_syncs: int = 0
    card_syncs: Optional[int] = None
    findings: list = dataclasses.field(default_factory=list)


def run_driver(name: str, target: DriverTarget, device) -> DriverRun:
    """Run one target under the sync counter and the fold watcher (and,
    on the card, the sync debug mode)."""
    result = DriverRun()
    card = torch.device(device).type == "cuda"
    try:
        inputs = target.setup()
    except Exception as exc:  # noqa: BLE001 - DR001 reports it
        result.error = exc
        return result
    if card:
        torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        seen = stack.enter_context(card_sync_warnings()) if card else None
        counter = stack.enter_context(
            count_syncs("cuda" if card else None))
        stack.enter_context(watch_folds(name, result.findings))
        try:
            result.out = target.run(inputs)
        except Exception as exc:  # noqa: BLE001 - DR001 reports it
            result.error = exc
    if card:
        torch.cuda.synchronize()
        result.card_syncs = len(seen)
    result.syncs = dict(counter.counts)
    result.plain_syncs = counter.plain
    return result


def _runs(ctx: AnalysisContext) -> dict:
    """Run every target once; cached on the context."""
    if "driver_runs" not in ctx.cache:
        ctx.cache["driver_targets"] = driver_targets(ctx.device)
        ctx.cache["driver_runs"] = {
            name: run_driver(name, t, ctx.device)
            for name, t in ctx.cache["driver_targets"].items()}
        for name, r in ctx.cache["driver_runs"].items():
            card = ("" if r.card_syncs is None
                    else f"; {r.card_syncs} reported by the card")
            ctx.note(f"{name}: {sum(r.syncs.values())} host syncs "
                     f"({r.plain_syncs} more in plain versions){card}")
    return ctx.cache["driver_runs"]


@register_pass("driver-run", "drivers", ("DR001",),
               doc="every engine x backend driver and the service's "
                   "programs run at the tiny geometry")
def run_pass(ctx: AnalysisContext) -> list:
    findings = []
    for name, r in _runs(ctx).items():
        if r.error is not None:
            lines = traceback.format_exception_only(r.error)
            findings.append(Finding(
                rule="DR001", severity="error", target=name, location="run",
                message=f"driver raised: {lines[-1].strip()}",
                fix_hint="run the target alone to see the traceback"))
    return findings


@register_pass("driver-dtypes", "drivers", ("DR002",),
               doc="HistogramState, carry and ShuffleStats keep their "
                   "declared dtypes across every fold")
def dtype_pass(ctx: AnalysisContext) -> list:
    from repro_torch.core.backends import ShuffleStats
    from repro_torch.core.streaming import HistogramState

    findings = []
    for name, r in _runs(ctx).items():
        findings.extend(r.findings)
        out = r.out
        if isinstance(out, HistogramState):
            findings.extend(check_types(None, leaf_types(out), name,
                                        "state", carry=True))
        elif isinstance(out, tuple) and len(out) == 2 \
                and isinstance(out[1], ShuffleStats):
            findings.extend(check_types(None, leaf_types(out[1]), name,
                                        "stats", carry=False))
    return findings


@register_pass("driver-syncs", "drivers", ("DR004",),
               doc="host syncs of every driver within the budget its "
                   "target declares")
def sync_pass(ctx: AnalysisContext) -> list:
    findings = []
    runs = _runs(ctx)
    for name, r in runs.items():
        if r.error is not None:
            continue
        target = ctx.cache["driver_targets"][name]
        total = sum(r.syncs.values())
        budget = target.budget(r.out)
        if total > budget:
            calls = ", ".join(f"{k} x{v}" for k, v in sorted(r.syncs.items()))
            findings.append(Finding(
                rule="DR004", severity="error", target=name,
                location="syncs",
                message=(f"{total} host syncs ({calls}) over the target's "
                         f"budget of {budget} ({target.reason})"),
                fix_hint=("keep the value on the device, or read it back "
                          "once after the loop; if the sync is needed, "
                          "raise the budget with its reason")))
    return findings
