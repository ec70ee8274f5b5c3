"""K8, the combiner's histogram-block exchange
(``repro_torch.kernels.combine_blocks``), and the combiner's path through
the port, on the CPU.

- The plain version (the wrapper on CPU tensors) equals an int64 sum of
  every sender's block wrapped to int32, and the torch path it replaces
  (``nodes.all_to_all`` plus ``nodes.psum``), at odd shapes and past 2^31.
- The wrapper refuses what K8 does not take; its launch plan and vector
  width follow the entry point's arithmetic.
- The combiner through the streaming engine (P = 4, 3 steps, 64 sites)
  equals sphere's histogram and the benchmark's reference, exactly; the
  block exchange is a ``combiner.blocks`` span inside ``stream.fold`` and
  ``combiner.block_bytes`` counts (P - 1) S W 8 bytes a fold.
- ``tools/trace_cell.py``'s two combiner readings on a synthetic window.

K8 itself runs only on the card: ``tests/test_torch_cuda.py -m cuda``.
No JAX here.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.common import nodes, trace
from repro_torch.common.trace import Span
from repro_torch.common.types import EventLog
from repro_torch.core import api
from repro_torch.core.backends import mapreduce_combiner_histogram
from repro_torch.kernels import launch_counts
from repro_torch.kernels._launch import H100_SMS, dim3
from repro_torch.kernels.combine_blocks import ops as cb
from repro_torch.malgen import MalGenConfig, make_seed_streaming

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _path in (ROOT, ROOT / "tools"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

import trace_cell  # noqa: E402


def _blocks_case(seed, p, s_local, w, low, high):
    rng = np.random.default_rng(seed)
    local = rng.integers(low, high, size=(p, p * s_local, w, 2),
                         dtype=np.int64)
    carry = rng.integers(low, high, size=(p, s_local, w, 2), dtype=np.int64)
    return local, carry


def _wrap32(x):
    return ((x + 2**31) % 2**32 - 2**31).astype(np.int32)


def _expected(local, carry):
    """carry[d, i] + sum_src local[src, i P + d], in int64, wrapped."""
    p, s, w, _ = local.shape
    want = carry.copy()
    for d in range(p):
        for i in range(s // p):
            want[d, i] += local[:, i * p + d].sum(axis=0)
    return _wrap32(want)


@pytest.mark.parametrize("p,s_local,w,low,high", [
    (1, 5, 3, -100, 100),            # one node: the carry plus its histogram
    (3, 7, 5, -1000, 1000),          # odd nodes, sites and weeks
    (4, 13, 52, 0, 2**31 - 1),       # sums far past 2^31
    (8, 3, 1, -2**31, 2**31 - 1),    # the whole int32 range, both signs
])
def test_plain_equals_the_wrapped_sum_and_the_torch_path(p, s_local, w, low,
                                                         high):
    local, carry = _blocks_case(p * 100 + w, p, s_local, w, low, high)
    want = _expected(local, carry)
    lt = torch.from_numpy(local.astype(np.int32))
    ct = torch.from_numpy(carry.astype(np.int32))
    blocks = lt.reshape(p, s_local, p, w, 2).transpose(1, 2)
    torch_path = ct + nodes.psum(nodes.all_to_all(blocks), dim=1)
    got = cb.combine_blocks(lt, ct.clone())
    assert torch.equal(got, torch.from_numpy(want))
    assert torch.equal(got, torch_path)
    assert torch.equal(cb.combine_blocks_plain(lt, ct.clone()), got)
    if high > 2**30:
        # the int64 sum leaves int32 and the result wraps
        assert np.abs(local.sum(axis=0)).max() > 2**31


def test_the_wrapper_adds_in_place_and_launches_nothing_on_the_cpu():
    local = torch.ones(4, 8, 3, 2, dtype=torch.int32)
    carry = torch.full((4, 2, 3, 2), 5, dtype=torch.int32)
    before = cb.combine_blocks.launches
    out = cb.combine_blocks(local, carry)
    assert out is carry and int(carry.min()) == int(carry.max()) == 9
    assert cb.combine_blocks.launches == before


def test_the_counter_is_kept_out_of_launch_counts():
    """The benchmark's traced runs look each name of ``launch_counts()``
    up in their table of kernel symbols, which has no entry for K8; K8's
    symbol holds none of that table's fragments."""
    sys.path.insert(0, str(ROOT))
    from malbench import harness

    assert not any("combine" in name for name in launch_counts())
    symbol = ("(anonymous namespace)::combine_blocks_kernel(int const*, "
              "int*, int, int, int, int, int)")
    for fragments in harness.KERNEL_SYMBOLS.values():
        assert not any(f in symbol for f in fragments)
    assert cb.KERNELS == ("combine_blocks_kernel",)


def test_the_wrapper_refuses_what_k8_does_not_take():
    local = torch.zeros(4, 8, 3, 2, dtype=torch.int32)
    carry = torch.zeros(4, 2, 3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cb.combine_blocks(local.long(), carry)
    with pytest.raises(ValueError, match="contiguous"):
        cb.combine_blocks(local, carry.transpose(1, 2))
    with pytest.raises(ValueError, match="multiple of P"):
        cb.combine_blocks(torch.zeros(3, 8, 3, 2, dtype=torch.int32),
                          torch.zeros(3, 2, 3, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of P"):
        cb.combine_blocks(local, torch.zeros(4, 3, 3, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="overlaps"):
        buf = torch.zeros(4 * 8 * 3 * 2, dtype=torch.int32)
        cb.combine_blocks(buf.view(4, 8, 3, 2), buf[:48].view(4, 2, 3, 2))
    meta = torch.empty(1, 2**31 // 104 + 1, 52, 2, dtype=torch.int32,
                       device="meta")
    with pytest.raises(ValueError, match="2\\^31 - 1"):
        cb.combine_blocks(meta, torch.empty_like(meta))


def test_launch_plan_at_the_cells_shapes():
    """8 nodes of 120,000 sites over 52 weeks: 3,120,000 vectors of 16
    bytes over a persistent grid of 4 blocks an SM; 8-byte vectors at an
    odd week count, 4-byte ones off an 8-byte boundary."""
    (k8,) = cb.launch_plan(8, 15_000, 52, H100_SMS)
    assert k8.kernel == "combine_blocks_kernel"
    assert k8.grid == dim3(4 * H100_SMS) and k8.block == dim3(256)
    assert k8.offsets["carry"] == 120_000 * 104 // 4 - 1
    assert k8.offsets["local"] == 8 * 3_120_000 - 1
    assert cb.vector_ints(0, 512, 52) == 4
    assert cb.vector_ints(0, 512, 51) == 2
    assert cb.vector_ints(8, 512, 52) == 2
    assert cb.vector_ints(4, 512, 52) == 1
    (small,) = cb.launch_plan(2, 3, 1, H100_SMS, vec=1)
    assert small.grid == dim3(1) and small.offsets["vectors"] == 11 + 256
    with pytest.raises(ValueError):
        cb.launch_plan(1, 2**31 // 104 + 1, 52, H100_SMS)


# ----------------------------------------------- the combiner's path
P, STEPS, SITES, CHUNK = 4, 3, 64, 512
CFG = MalGenConfig(num_sites=SITES, num_entities=1000)
SEED = 2**31 + 401


def _job(backend):
    seed = make_seed_streaming(SEED, CFG, P * STEPS, CHUNK, device="cpu")
    return api.run(seed, nodes=P, engine="streaming", cfg=CFG,
                   num_chunks=P * STEPS, chunk_records=CHUNK,
                   backend=backend, statistic="B", device="cpu")


def test_the_combiner_streams_to_spheres_answer_and_the_reference():
    from malbench import check
    from malbench.reference import spm as ref_spm

    got, sphere = _job("mapreduce_combiner"), _job("sphere")
    config = {"malgen": {k: getattr(CFG, k) for k in (
        "num_sites", "num_entities", "marked_site_fraction", "alpha",
        "p_mark", "mark_delay", "span_seconds", "marked_event_fraction")},
        "num_weeks": 52, "nodes": P, "steps": STEPS, "chunk_records": CHUNK,
        "plan": {"capacity_factor": 2.0}}
    hist = check.fold_reference(SEED, config, "cpu")["hist"]
    rho, total, marked = ref_spm.malstone_b(hist, "float32")
    for out in (got, sphere):
        assert torch.equal(out.total, total.to(torch.int32))
        assert torch.equal(out.marked, marked.to(torch.int32))
        assert torch.equal(out.rho.view(torch.int32),
                           rho.to(torch.float32).view(torch.int32))
    assert int(got.total[:, -1].sum()) == P * STEPS * CHUNK


def test_the_exchange_is_a_span_in_the_fold_with_its_bytes_counted():
    trace.start()
    try:
        _job("mapreduce_combiner")
    finally:
        spans, counters = trace.stop()
    blocks = [s for s in spans if s.name == "combiner.blocks"]
    assert len(blocks) == STEPS
    assert all(spans[s.parent].name == "stream.fold" for s in blocks)
    s_pad = SITES       # 64 sites split over 4 nodes: no padding
    assert counters["combiner.block_bytes"] == STEPS * (P - 1) * s_pad * 52 * 8
    # at the cell's shapes, 8 nodes and 120,000 sites
    assert (8 - 1) * 120_000 * 52 * 8 == 349_440_000


def test_a_given_carry_is_added_into_in_place():
    rng = np.random.default_rng(5)
    n = 300
    log = EventLog(
        site_id=torch.from_numpy(rng.integers(0, 16, (2, n), dtype=np.int32)),
        entity_id=torch.zeros(2, n, dtype=torch.int32),
        timestamp=torch.from_numpy(rng.integers(0, 3 * 604800, (2, n),
                                                dtype=np.int32)),
        mark=torch.from_numpy(rng.integers(0, 2, (2, n), dtype=np.int32)))
    fresh = mapreduce_combiner_histogram(log, 16, 4)
    carry = torch.full_like(fresh, 2**31 - 1)
    out = mapreduce_combiner_histogram(log, 16, 4, carry=carry)
    assert out is carry
    want = torch.from_numpy(_wrap32(fresh.numpy().astype(np.int64)
                                    + 2**31 - 1))
    assert torch.equal(out, want)
    assert int(fresh[..., 0].sum()) == 2 * n


def test_trace_cell_reads_the_combiners_span_and_counter():
    step = "malbench.job/run.job/stream.step"
    spans = [Span("stream.step", 0, 10, None, 0),
             Span("stream.fold", 2, 9, 0),
             Span("combiner.blocks", 6, 8, 1),
             Span("stream.step", 10, 20, None, 1),
             Span("stream.fold", 12, 19, 3),
             Span("combiner.blocks", 16, 18, 4)]
    paths = {"device_s_by_span_path": {
        f"{step}/stream.fold": 0.005,
        f"{step}/stream.fold/combiner.blocks": 0.0004},
        "device_ops_by_span_path": {
            f"{step}/stream.fold/combiner.blocks": 2}}
    counters = {"combiner.block_bytes": 2 * 349_440_000}
    m = trace_cell.span_metrics(spans, counters, None, paths,
                                records=2 * 8 * 2**23)
    dev = m["combiner.blocks_device_ms_per_step"]
    assert dev["value"] == pytest.approx(0.2) and dev["unit"] == "ms/step"
    per = m["combiner.block_bytes_per_record"]
    assert per["value"] == pytest.approx(349_440_000 / 67_108_864)
    assert per["folds"] == 2
    # neither reading where the combiner did not run
    others = trace_cell.span_metrics(spans[:2], {}, None, paths, records=1)
    assert not {"combiner.blocks_device_ms_per_step",
                "combiner.block_bytes_per_record"} & set(others)
