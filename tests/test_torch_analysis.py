"""The port's static checker suite (``repro_torch.analysis``).

- Each rule fires on its seeded bug, and the registry and the findings
  schema behave as the JAX package's (``TestFindingsSchema`` and
  ``TestRegistry`` of ``tests/test_analysis.py``).
- The live suite is clean against the committed baseline
  (``results/analysis_baseline_torch.json``), and the CLI exits 0.
- Against JAX: the port's LN001 over ``src/repro`` gives JAX's keys; the
  kernel case names include JAX's ``kernel_analysis_cases()``; the port's
  ``expected_shuffle_rounds`` equals JAX's over the live plans; and the
  rounds the recorder counts at P = 4 equal JAX's ``ShuffleStats.rounds``
  on the same log. The P = 4 JAX side needs 4 host devices, so it runs in
  a subprocess: this file run as a script (``python
  tests/test_torch_analysis.py OUT.json``).
- The wrappers refuse the shapes the analysis found their kernels cannot
  take (meta tensors: nothing is allocated).
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

if __name__ == "__main__":
    from repro.common.env import force_host_devices

    force_host_devices(4)

import jax
import numpy as np
import pytest

from repro.common.types import EventLog as JaxLog
from repro.common.types import ExchangePlan as JaxPlan
from repro.core import run as jax_run

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import collective_passes as cp  # noqa: E402


def _jax_plan(plan):
    return JaxPlan(impl=plan.impl, capacity_factor=plan.capacity_factor,
                   max_shuffle_rounds=plan.max_shuffle_rounds)


def _jax_rounds_main(out_path):
    """The P = 4 JAX side: every live target with an exchange, on the
    recorder's log -> ``{target: ShuffleStats.rounds}``."""
    assert jax.device_count() == cp.PARTS, jax.devices()
    mesh = jax.make_mesh((cp.PARTS,), ("data",))
    log = JaxLog(**{k: jax.numpy.asarray(v) for k, v in cp.live_log().items()})
    out = {}
    for name, (plan, kw) in cp.live_plans().items():
        if kw["backend"] != "mapreduce":
            continue
        kw = dict(kw)
        kw.pop("backend")
        _, stats = jax_run(log, cp.SITES, mesh=mesh, backend="mapreduce",
                           num_weeks=cp.WEEKS, plan=_jax_plan(plan),
                           return_shuffle_stats=True, **kw)
        out[name] = int(stats.rounds)
    pathlib.Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    _jax_rounds_main(sys.argv[1])
    sys.exit(0)

import torch  # noqa: E402

from repro.analysis import kernel_passes as jax_kernel_passes  # noqa: E402
from repro.analysis import lint as jax_lint  # noqa: E402
from repro.analysis.registry import AnalysisContext as JaxContext  # noqa: E402
from repro.core.plan import expected_shuffle_rounds as jax_rounds  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    DEVICE_FAMILIES,
    FAMILIES,
    RULES,
    AnalysisContext,
    Finding,
    diff_against_baseline,
    iter_passes,
    load_report,
    register_pass,
    sort_findings,
    write_report,
)
from repro_torch.analysis import cli  # noqa: E402
from repro_torch.analysis import driver_passes as dp  # noqa: E402
from repro_torch.analysis import kernel_passes as kp  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402
from repro_torch.analysis import registry  # noqa: E402
from repro_torch.core.plan import expected_shuffle_rounds  # noqa: E402
from repro_torch.kernels._launch import H100_SMS, Launch, dim3  # noqa: E402
from repro_torch.kernels.count_scatter import ops as cs  # noqa: E402
from repro_torch.kernels.powerlaw_sample import ops as ps  # noqa: E402
from repro_torch.kernels.segment_hist import ops as sh  # noqa: E402
from repro_torch.kernels.windowed_ratio import ops as wr  # noqa: E402

SOURCES = kp.read_sources()


# --------------------------------------------------------------- schema
class TestFindingsSchema:
    def f(self, **kw):
        base = dict(rule="KG001", severity="error", target="t",
                    location="loc", message="m", fix_hint="h")
        base.update(kw)
        return Finding(**base)

    def test_key_excludes_message(self):
        a = self.f(message="run 1: 42 bytes")
        b = self.f(message="run 2: 99 bytes")
        assert a.key == b.key == "KG001::t::loc"

    def test_bad_severity_rejected(self):
        with pytest.raises(ValueError, match="severity"):
            self.f(severity="catastrophic")

    def test_report_roundtrip(self, tmp_path):
        fs = [self.f(), self.f(rule="CL002", severity="warning",
                               location="psum#0")]
        path = tmp_path / "report.json"
        write_report(fs, path)
        loaded = load_report(path)
        assert loaded == sort_findings(fs)
        assert [x.severity for x in loaded] == ["error", "warning"]
        assert json.loads(path.read_text())["schema"] == \
            "repro_torch.analysis/1"

    def test_load_missing_is_empty(self, tmp_path):
        assert load_report(tmp_path / "nope.json") == []

    def test_load_rejects_the_jax_packages_schema(self, tmp_path):
        """A JAX report is never read as the port's."""
        path = tmp_path / "bad.json"
        path.write_text(json.dumps({"schema": "repro.analysis/1",
                                    "findings": []}))
        with pytest.raises(ValueError, match="schema"):
            load_report(path)
        with pytest.raises(ValueError, match="schema"):
            load_report(ROOT / "results" / "analysis_baseline.json")

    def test_baseline_diff(self):
        old = [self.f(location="kept"), self.f(location="gone")]
        cur = [self.f(location="kept"), self.f(location="fresh")]
        diff = diff_against_baseline(cur, old)
        assert [x.location for x in diff.new] == ["fresh"]
        assert [x.location for x in diff.known] == ["kept"]
        assert diff.fixed == ("KG001::t::gone",)
        assert diff.gate_failed
        assert not diff_against_baseline(old, old).gate_failed


class TestRegistry:
    def test_every_pass_rule_documented(self):
        for p in iter_passes():
            for rule in p.rules:
                assert rule in RULES, (p.name, rule)

    def test_all_families_covered(self):
        assert {p.family for p in iter_passes()} == set(FAMILIES)
        assert FAMILIES == ("drivers", "kernels", "collectives", "lint")

    def test_every_rule_has_a_pass(self):
        """And no DR003: eager PyTorch donates no buffers."""
        declared = {r for p in iter_passes() for r in p.rules}
        assert declared == set(RULES)
        assert "DR003" not in RULES

    def test_unknown_family_rejected(self):
        with pytest.raises(ValueError, match="unknown analysis families"):
            iter_passes(["jaxpr"])

    def test_undocumented_rule_rejected_at_registration(self):
        with pytest.raises(ValueError, match="undocumented"):
            register_pass("bogus", "lint", ("XX999",))(lambda ctx: [])

    def test_duplicate_name_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            register_pass("lint-asserts", "lint", ("LN001",))(lambda c: [])

    def test_hopper_limits_are_compute_capability_9_0s(self):
        assert (registry.MAX_THREADS_PER_BLOCK, registry.MAX_GRID_X,
                registry.MAX_GRID_YZ) == (1024, 2**31 - 1, 65535)
        assert (registry.SMEM_DEFAULT, registry.SMEM_PER_BLOCK_OPTIN,
                registry.SMEM_PER_SM) == (49152, 232448, 233472)


# --------------------------------------------------------------- kernels
def _case(source, *launches, index_types=None, static=None):
    mod = {"count_scatter": cs, "powerlaw_sample": ps,
           "windowed_ratio": wr, "windowed_ratio_masked": wr}.get(source, sh)
    return {"name": f"seeded/{source}", "source": source,
            "plan": lambda sms: list(launches),
            "index_types": index_types or mod.INDEX_TYPES,
            "static_smem": static or mod.STATIC_SMEM_BYTES}


def _rules(findings):
    return sorted({(f.rule, f.location) for f in findings})


class TestKernelPasses:
    def test_sources_are_read(self):
        assert set(SOURCES) == {"count_scatter", "segment_hist",
                                "segment_hist_packed",
                                "windowed_ratio_masked", "powerlaw_sample",
                                "windowed_ratio"}
        assert SOURCES["windowed_ratio_masked"].bounds[
            "masked_window_ratio_kernel"] == (256, 3)
        assert SOURCES["powerlaw_sample"].bounds["sample_kernel"] == (512, 3)
        assert SOURCES["windowed_ratio"].bounds[
            "windowed_ratio_kernel"] == (256, 8)
        assert SOURCES["count_scatter"].bounds["count_tiles_kernel"] == (
            None, None)
        assert SOURCES["count_scatter"].opt_in == {"scatter_tiles_kernel"}
        assert SOURCES["segment_hist"].opt_in == {"hot_sites_kernel"}
        assert SOURCES["windowed_ratio"].opt_in == set()

    def test_plain_constants_only(self):
        src = kp.parse_source(
            "constexpr int kA = 4;\nconstexpr int kB = 2 * kA + 1;\n"
            "constexpr int kC = kA * (int)sizeof(int);\n"
            "__global__ void __launch_bounds__(kB) f(int* x) {}\n")
        assert src.constants == {"kA": 4, "kB": 9}
        assert src.bounds == {"f": (9, None)}
        with pytest.raises(ValueError, match="plain constant"):
            kp.parse_source("__global__ void __launch_bounds__(kZ) g() {}")

    def test_kernels_of_a_named_namespace_take_its_name(self):
        """K6's join pass keeps K6's kernel names inside ``join``: the
        source's tables key them apart from the plain ones."""
        src = kp.parse_source(
            "namespace {\n__global__ void __launch_bounds__(512, 3) k() {}\n"
            "namespace join {\n__global__ void __launch_bounds__(512, 2) "
            "k() {}\n__global__ void d() {}\n}  // namespace join\n"
            "void h() { cudaFuncSetAttribute(join::k, "
            "cudaFuncAttributeMaxDynamicSharedMemorySize, 1); }\n"
            "}  // namespace\n")
        assert src.bounds == {"k": (512, 3), "join::k": (512, 2),
                              "join::d": (None, None)}
        assert src.opt_in == {"join::k"}
        k6 = SOURCES["powerlaw_sample"]
        assert k6.bounds["join::sample_kernel"] == (512, 2)
        assert set(k6.bounds) == set(ps.KERNELS) == set(ps.INDEX_TYPES) \
            == set(ps.STATIC_SMEM_BYTES)
        assert kp.kernel_name(
            "(anonymous namespace)::join::sample_kernel((anonymous "
            "namespace)::join::Rows, float const*, int const*, int, int, "
            "int, bool)") == "join::sample_kernel"

    def test_seeded_64kb_launch_without_opt_in_fires_kg003(self):
        """A 64 KB launch of a kernel whose source never opts in, and of
        one that does but did not before this launch."""
        no_opt = Launch("count_tiles_kernel", dim3(1, 1), dim3(256), 65536,
                        opt_in=65536)
        not_set = Launch("scatter_tiles_kernel", dim3(1, 1), dim3(256),
                         65536)
        set_ok = Launch("scatter_tiles_kernel", dim3(1, 1), dim3(256),
                        65536, opt_in=65536)
        for bad in (no_opt, not_set):
            found = kp.check_case(_case("count_scatter", bad), SOURCES)
            assert _rules(found) == [("KG003", f"{bad.kernel}/smem")]
        assert kp.check_case(_case("count_scatter", set_ok),
                             SOURCES) == []

    def test_seeded_smem_over_the_block_and_the_sm_fires_kg003(self):
        big = Launch("hot_sites_kernel", dim3(1), dim3(1024), 232448,
                     opt_in=232448)
        found = kp.check_case(_case("segment_hist", big), SOURCES)
        assert _rules(found) == [("KG003", "hot_sites_kernel/smem")]
        # 3 blocks promised (K6's launch bounds) of 80 KB do not fit 228 KB
        occ = Launch("sample_kernel", dim3(1), dim3(512), 80 * 1024,
                     opt_in=80 * 1024)
        found = kp.check_case(_case("powerlaw_sample", occ), SOURCES)
        assert _rules(found) == [("KG003", "sample_kernel/occupancy")]

    def test_seeded_grid_missing_the_last_tile_fires_kg001(self):
        n, rows = 3 * cs.TILE + 1, 2
        short = Launch("count_tiles_kernel", dim3(n // cs.TILE, rows),
                       dim3(256), 36, covers=((n, cs.TILE), (rows, 1)))
        found = kp.check_case(_case("count_scatter", short), SOURCES)
        assert _rules(found) == [("KG001", "count_tiles_kernel/grid.x")]
        ok = cs.count_tiles_launch(rows, n, 9)
        assert ok[0].grid == dim3(4, rows)
        assert kp.check_case(_case("count_scatter", *ok), SOURCES) == []

    @pytest.mark.parametrize("block,grid", [
        (dim3(2048), dim3(1)),          # over the card's 1024
        (dim3(512), dim3(1)),           # over scatter's launch bounds
        (dim3(200), dim3(1)),           # not whole warps
        (dim3(256), dim3(1, 65536)),    # grid y over 65,535
        (dim3(256), dim3(0, 1)),        # empty
    ])
    def test_seeded_bad_block_or_grid_fires_kg001(self, block, grid):
        bad = Launch("scatter_tiles_kernel", grid, block, 1024)
        found = kp.check_case(_case("count_scatter", bad), SOURCES)
        assert {f.rule for f in found} == {"KG001"}

    def test_seeded_offset_past_2_31_fires_kg002(self):
        bad = Launch("sample_kernel", dim3(1), dim3(512), ps.SHARED_BYTES,
                     offsets={"draws": 2**31})
        found = kp.check_case(_case("powerlaw_sample", bad), SOURCES)
        assert _rules(found) == [("KG002", "sample_kernel/draws")]
        undeclared = Launch("sample_kernel", dim3(1), dim3(512),
                            ps.SHARED_BYTES, offsets={"other": 1})
        found = kp.check_case(_case("powerlaw_sample", undeclared),
                              SOURCES)
        assert _rules(found) == [("KG002", "sample_kernel/other")]

    @pytest.mark.parametrize("module,bound,case,old", [
        (ps, "MAX_DRAWS", "powerlaw_sample/most_draws", 2**31 - 1),
        (wr, "MAX_MASKED_SITES", "windowed_ratio/masked_most_sites",
         2**31 - 1),
    ])
    def test_the_old_wrapper_bounds_fire_kg002(self, monkeypatch, module,
                                               bound, case, old):
        """The findings the repairs fixed: at the shapes the wrappers took
        before, K6 forms a draw's end i + 4 past int32 and K5's host forms
        num_sites + 63 past it."""
        monkeypatch.setattr(module, bound, old)
        found = [f for c in module.analysis_cases() if c["name"] == case
                 for f in kp.check_case(c, SOURCES)]
        assert {f.rule for f in found} == {"KG002"}

    def test_old_k7_week_and_k5_query_bounds_fire_kg002(self, monkeypatch):
        monkeypatch.setattr(wr, "MAX_WEEKS", 2**31 - 1)
        monkeypatch.setattr(wr, "MAX_RUN_ROWS", 2**40)
        for source, plan in (
                ("windowed_ratio",
                 lambda sms: wr.launch_plan(1, 2**30, sms)),
                ("windowed_ratio_masked",
                 lambda sms: wr.masked_launch_plan(2**30, 64, 1))):
            case = {**_case(source), "plan": plan}
            assert {f.rule for f in kp.check_case(case, SOURCES)} == \
                {"KG002"}

    def test_old_count_scatter_rows_fire_kg001(self, monkeypatch):
        monkeypatch.setattr(cs, "MAX_ROWS", 2**20)
        case = {**_case("count_scatter"),
                "plan": lambda sms: cs.launch_plan(65536, cs.TILE, 8)}
        found = kp.check_case(case, SOURCES)
        assert _rules(found) == [("KG001", "count_tiles_kernel/grid"),
                                 ("KG001", "scatter_tiles_kernel/grid")]

    def test_case_names_include_jaxs(self):
        jax_names = {c["name"] for c in
                     jax_kernel_passes.kernel_analysis_cases()}
        names = [c["name"] for c in kp.kernel_analysis_cases()]
        assert len(jax_names) == 6 and jax_names <= set(names)
        assert len(names) == len(set(names))
        assert set(names) - jax_names == {
            "count_scatter/main_path", "count_scatter/max_dests",
            "count_scatter/longest_row", "count_scatter/max_rows",
            "segment_hist/main_path", "segment_hist/other_backends",
            "segment_hist/longest_row", "segment_hist/packed_longest_row",
            "powerlaw_sample/main_path", "powerlaw_sample/direct_limit",
            "powerlaw_sample/table_limit", "powerlaw_sample/most_draws",
            "powerlaw_sample/join_marked", "powerlaw_sample/join_unmarked",
            "powerlaw_sample/join_direct_limit",
            "windowed_ratio/nodedoctor", "windowed_ratio/masked_two_chunks",
            "windowed_ratio/most_sites",
            "windowed_ratio/masked_most_sites"}

    def test_main_path_cases_launch_the_main_paths_shapes(self):
        cases = {c["name"]: c for c in kp.kernel_analysis_cases()}

        def plan(name):
            return cases[name]["plan"](H100_SMS)

        k1, k2 = plan("count_scatter/main_path")
        assert k1.grid == k2.grid == dim3(2048, 8)
        k2_1025 = plan("count_scatter/max_dests")[1]
        assert k2_1025.dynamic_smem == 73800 == k2_1025.opt_in
        guide, sample = plan("powerlaw_sample/main_path")
        assert (guide.grid, sample.grid) == (dim3(391), dim3(396))
        assert [l.kernel for l in plan("powerlaw_sample/direct_limit")] == [
            "direct_kernel"]
        # the step's unmarked half: 7,549,747 records from one int past a
        # 16-byte boundary, a head of 3 and 1,887,436 whole groups
        guide, join = plan("powerlaw_sample/join_unmarked")
        assert (guide.kernel, join.kernel) == ("guide_kernel",
                                               "join::sample_kernel")
        assert join.grid == dim3(2 * H100_SMS)
        assert join.offsets["draws"] == 3 + 4 * 1_887_436 == 7_549_747
        assert [l.kernel for l in plan("powerlaw_sample/join_direct_limit")
                ] == ["join::direct_kernel"]
        assert plan("windowed_ratio/nodedoctor")[0].grid == dim3(1)

    def test_plans_match_records_taken_on_an_h100(self):
        """The profiler's records of these shapes on an H100 80GB HBM3
        (grid, block, static + dynamic shared bytes): K1/K2 on [2, 10000]
        to 1025 destinations, K3 and K4 on [2, 10000] at W = 52, K7 on
        [300, 52, 2], K5 with 5 queries over it, K6 on 2^18 and 1,000
        draws under 1,000 sites."""
        got = (cs.launch_plan(2, 10000, 1024)
               + sh.packed_launch_plan(2, 10000, num_sites_local=50,
                                       num_partitions=2, sm_count=132)
               + sh.launch_plan(2, 10000, num_sites=100, sm_count=132)
               + wr.launch_plan(300, 52, 132)
               + wr.masked_launch_plan(5, 300, 52)
               + ps.launch_plan(1 << 18, 1000, 132)
               + ps.launch_plan(1000, 1000, 132))
        static = {**cs.STATIC_SMEM_BYTES, **sh.STATIC_SMEM_BYTES,
                  **wr.STATIC_SMEM_BYTES, **ps.STATIC_SMEM_BYTES}
        card = [("count_tiles_kernel", (3, 2, 1), 256, 4100),
                ("scatter_tiles_kernel", (3, 2, 1), 256, 73800),
                ("hot_sites_kernel", (2, 1, 1), 1024, 133136),
                ("packed_hist_kernel", (5, 1, 1), 512, 34832),
                ("hot_sites_kernel", (2, 1, 1), 1024, 133136),
                ("segment_hist_kernel", (5, 1, 1), 512, 34832),
                ("windowed_ratio_kernel", (38, 1, 1), 256, 0),
                ("mask_runs_kernel", (2, 1, 1), 256, 0),
                ("masked_window_ratio_kernel", (5, 1, 1), 256, 28240),
                ("guide_kernel", (4, 1, 1), 256, 0),
                ("sample_kernel", (128, 1, 1), 512, 32784),
                ("direct_kernel", (4, 1, 1), 256, 0)]
        assert [(l.kernel, l.grid, l.block[0],
                 static[l.kernel] + l.dynamic_smem) for l in got] == card

    def test_live_kernels_clean(self):
        assert kp.kernels_pass(AnalysisContext(device=None)) == []

    @pytest.mark.skipif(torch.cuda.is_available(),
                        reason="checks the refusal where there is no card")
    def test_card_records_child_refuses_without_a_card(self):
        """The fresh process that takes the card's launch records runs on
        the card or nowhere: without one it exits non-zero, and the
        caller raises with its message."""
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kp.card_launches_in_child()

    def test_kernel_names_from_the_profiler(self):
        assert kp.kernel_name("(anonymous namespace)::count_tiles_kernel("
                              "int const*, int*, long long, int, int)") == \
            "count_tiles_kernel"
        assert kp.kernel_name("void at::native::reduce_kernel<512>(int)") \
            == "reduce_kernel<512>"


class TestRepairedWrappers:
    """Shapes the wrappers took and their kernels cannot: each is refused
    now, before anything is allocated or launched (meta tensors)."""

    def meta(self, *shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def test_k6_refuses_past_2_31_minus_4_draws(self):
        cdf = self.meta(10, dtype=torch.float32)
        with pytest.raises(ValueError, match="2\\^31 - 4"):
            ps.powerlaw_sample(self.meta(2**31 - 3, dtype=torch.float32),
                               cdf)
        with pytest.raises(ValueError):
            ps.launch_plan(2**31 - 3, 10, H100_SMS)
        plan = ps.launch_plan(ps.MAX_DRAWS, 10, H100_SMS)
        assert plan[1].offsets["draws"] == 2**31 - 4

    def test_k7_refuses_2_30_weeks(self):
        with pytest.raises(ValueError, match="2\\^30"):
            wr.windowed_ratio(self.meta(1, 2**30, 2))
        assert wr.launch_plan(1, wr.MAX_WEEKS, H100_SMS)[0].offsets[
            "hist (in a row)"] == 2**31 - 1

    def test_k5_refuses_sites_and_queries_past_its_int_arithmetic(self):
        masks = self.meta(1, 1, dtype=torch.bool)
        with pytest.raises(ValueError, match="2\\^31 - 64"):
            wr.masked_window_ratio(self.meta(2**31 - 63, 1, 2), masks, masks)
        many = self.meta(2**30, 1, dtype=torch.bool)
        with pytest.raises(ValueError, match="run lists"):
            wr.masked_window_ratio(self.meta(64, 1, 2), many, many)
        wr.masked_launch_plan((2**31 - 8) // 2, 64, 1)

    def test_k1_k2_refuse_more_rows_than_grid_y(self):
        rows = self.meta(cs.MAX_ROWS + 1, 16)
        with pytest.raises(ValueError, match="grid's"):
            cs.count_scatter(rows, rows, 4)
        cs.launch_plan(cs.MAX_ROWS, 16, 4)


# ----------------------------------------------------------- collectives
def _rec(op, dtype="int32", shape=(4,), **kw):
    return cp.CollectiveRecord(op=op, dtype=dtype, shape=shape, **kw)


def _exchange(*rounds, stats_rounds=None):
    """An exchange's records: the initial count, then each round's ops."""
    recs = [_rec("exchange"), _rec("global_count")]
    for ops in rounds:
        recs.append(_rec("round"))
        recs.extend(_rec(op) for op in ops)
    end = len(rounds) if stats_rounds is None else stats_rounds
    recs.append(_rec("exchange_end", rounds=end, records=16, parts=4))
    return recs


class TestCollectivePasses:
    def test_a_lossless_exchange_is_clean(self):
        recs = _exchange(["all_to_all", "global_count"],
                         ["all_to_all", "global_count"])
        assert cp.check_records(recs, "t") == []

    def test_seeded_round_without_global_count_fires_cl001(self):
        recs = _exchange(["all_to_all", "global_count"], ["all_to_all"],
                         ["all_to_all", "global_count"])
        found = cp.check_records(recs, "t")
        assert _rules(found) == [("CL001", "exchange#0/round1")]
        # a count before the all_to_all does not end the round
        recs = _exchange(["global_count", "all_to_all"])
        assert _rules(cp.check_records(recs, "t")) == [
            ("CL001", "exchange#0/round0")]

    def test_seeded_live_loop_without_its_count_fires_cl001(self,
                                                             monkeypatch):
        """The mapreduce loop with its per-round global_count replaced by
        a local one."""
        from repro_torch.common import nodes
        from repro_torch.core.backends import mapreduce

        real = mapreduce.exchange_and_reduce

        @functools.wraps(real)
        def local_counts(*args, **kwargs):
            counts = iter(range(2))
            orig = nodes.global_count

            def first_only(x, group=None):
                if next(counts, 1):
                    return int(x.sum())
                return orig(x, group)

            monkeypatch.setattr(nodes, "global_count", first_only)
            try:
                return real(*args, **kwargs)
            finally:
                monkeypatch.setattr(nodes, "global_count", orig)

        monkeypatch.setattr(mapreduce, "exchange_and_reduce", local_counts)
        records, plan, rounds = cp.run_target("mapreduce/counting", "cpu")
        found = cp.check_records(records, "t", plan=plan,
                                 stats_rounds=rounds)
        assert {f.rule for f in found} == {"CL001"}

    def test_seeded_staging_in_one_process_fires_cl002(self):
        recs = [_rec("psum", gloo=True, world=1)]
        assert _rules(cp.check_records(recs, "t")) == [("CL002", "psum#0")]
        assert cp.check_records([_rec("psum", gloo=True, world=2)],
                                "t") == []

    def test_seeded_round_counts_fire_cl003(self):
        from repro_torch.common.types import ExchangePlan

        recs = _exchange(["all_to_all", "global_count"], stats_rounds=2)
        assert _rules(cp.check_records(recs, "t")) == [
            ("CL003", "exchange#0")]
        plan = ExchangePlan(capacity_factor=0.5, max_shuffle_rounds=1)
        recs = _exchange(*[["all_to_all", "global_count"]] * 2)
        assert _rules(cp.check_records(recs, "t", plan=plan)) == [
            ("CL003", "exchange#0/bound")]
        recs = _exchange(["all_to_all", "global_count"])
        assert _rules(cp.check_records(recs, "t", stats_rounds=3)) == [
            ("CL003", "stats")]

    def test_seeded_unknown_dtype_fires_cl004(self):
        recs = [_rec("all_to_all", dtype="complex64")]
        assert _rules(cp.check_records(recs, "t")) == [
            ("CL004", "dtype:complex64")]

    def test_seeded_differing_ranks_fire_cl005(self):
        same = [_rec("global_count"), _rec("all_to_all")]
        other = [_rec("global_count"), _rec("all_to_all", shape=(8,))]
        assert cp.check_gang({"x": [same, list(same)]}) == []
        found = cp.check_gang({"x": [same, other],
                               "y": [same, same[:1]]})
        assert sorted((f.rule, f.target, f.location) for f in found) == [
            ("CL005", "collectives:gang/x", "rank1"),
            ("CL005", "collectives:gang/y", "rank1")]

    def test_the_recorder_sees_every_round(self):
        records, plan, rounds = cp.run_target("mapreduce/counting", "cpu")
        ops = [r.op for r in records]
        assert ops.count("round") == rounds == 3
        assert ops.count("all_to_all") == 3
        assert ops.count("global_count") == 4
        assert not any(r.gloo for r in records)

    def test_the_recorder_restores_the_collectives(self):
        from repro_torch.common import nodes
        from repro_torch.core.backends import mapreduce

        before = (nodes.psum, nodes._gloo, mapreduce.ship_round)
        with cp.record_collectives():
            assert nodes.psum is not before[0]
        assert (nodes.psum, nodes._gloo, mapreduce.ship_round) == before

    def test_expected_rounds_equal_jaxs(self):
        for plan, _ in cp.live_plans().values():
            for records in (cp.RECORDS_PER_NODE, cp.CHUNK_RECORDS, 16):
                assert expected_shuffle_rounds(plan, records, cp.PARTS) == \
                    jax_rounds(_jax_plan(plan), records, cp.PARTS)

    def test_recorded_rounds_equal_jaxs_shuffle_stats_at_p4(self, tmp_path):
        out = tmp_path / "rounds.json"
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
            "PYTHONPATH", "")
        env.pop("XLA_FLAGS", None)
        proc = subprocess.run([sys.executable, __file__, str(out)],
                              env=env, capture_output=True, text=True,
                              timeout=240)
        assert proc.returncode == 0, proc.stderr[-4000:]
        want = json.loads(out.read_text())
        assert set(want) == {n for n, (_, kw) in cp.live_plans().items()
                             if kw["backend"] == "mapreduce"}
        for name, rounds in want.items():
            records, _, stats_rounds = cp.run_target(name, "cpu")
            marked = [r for r in records if r.op == "round"]
            ends = [r.rounds for r in records if r.op == "exchange_end"]
            assert stats_rounds == max(ends) == rounds, name
            if "streaming" not in name:
                assert len(marked) == rounds, name


# ---------------------------------------------------------------- drivers
class TestDriverPasses:
    def test_sync_counter_counts_the_host_reads(self):
        x = torch.arange(6)
        with dp.count_syncs() as c:
            int(x.sum())
            bool(x[0] > 0)
            x.tolist()
            x[x > 2]
            torch.nonzero(x)
            x.numpy()
            x.cpu()
            x + 1
        assert c.counts == {"__int__": 1, "__bool__": 1, "tolist": 1,
                            "mask index": 1, "nonzero": 1, "numpy": 1,
                            "cpu": 1}

    def test_plain_versions_are_counted_apart(self):
        dest = torch.randint(0, 3, (2, 100), dtype=torch.int32)
        with dp.count_syncs() as c:
            cs.count_scatter(dest, dest, 2)
        assert c.total == 0 and c.plain > 0

    def test_on_the_card_only_cuda_tensors_count(self):
        with dp.count_syncs("cuda") as c:
            int(torch.arange(3).sum())
        assert c.total == 0

    def test_seeded_item_in_the_round_loop_fires_dr004(self, monkeypatch):
        from repro_torch.core.backends import mapreduce

        real = mapreduce.ship_round

        def chatty(words_sorted, *args, **kwargs):
            words_sorted[:, :1].sum().item()
            return real(words_sorted, *args, **kwargs)

        monkeypatch.setattr(mapreduce, "ship_round", chatty)
        ctx = AnalysisContext(device="cpu")
        found = dp.sync_pass(ctx)
        assert {f.target for f in found} >= {"drivers:oneshot/mapreduce",
                                            "drivers:streaming/mapreduce"}
        assert {f.rule for f in found} == {"DR004"}
        assert "item x" in found[0].message

    def test_seeded_int64_promotion_in_a_carry_fires_dr002(self,
                                                           monkeypatch):
        from repro_torch.core import streaming

        real = streaming._accumulate_chunk

        def promote(carry, chunk, backend, *args, **kwargs):
            out = real(carry, chunk, backend, *args, **kwargs)
            # (a 0-dim int64 operand would not promote an int32 tensor)
            return out.to(torch.int64) if backend == "streams" else out

        monkeypatch.setattr(streaming, "_accumulate_chunk", promote)
        found = dp.dtype_pass(AnalysisContext(device="cpu"))
        targets = {f.target for f in found}
        assert "drivers:streaming/streams" in targets
        assert {f.rule for f in found} == {"DR002"}
        assert any("changed from int32 to int64" in f.message
                   for f in found)

    def test_declared_types(self):
        assert dp.check_types(None, {"carry/0": "int32",
                                     "chunks_folded": "int"}, "t", "state")\
            == []
        found = dp.check_types(None, {"rounds": "int32"}, "t", "stats",
                               carry=False)
        assert _rules(found) == [("DR002", "stats/rounds")]

    def test_seeded_raise_fires_dr001(self, monkeypatch):
        from repro_torch.core.backends import mapreduce

        def boom(*args, **kwargs):
            raise RuntimeError("seeded")

        monkeypatch.setattr(mapreduce, "ship_round", boom)
        found = dp.run_pass(AnalysisContext(device="cpu"))
        assert "drivers:oneshot/mapreduce" in {f.target for f in found}
        assert all(f.rule == "DR001" and "seeded" in f.message
                   for f in found)

    def test_targets_cover_every_engine_and_backend(self):
        names = set(dp.driver_targets("cpu"))
        assert len(names) == 24
        for engine in ("oneshot", "streaming", "generated",
                       "generated_streaming"):
            for backend in dp.BACKENDS:
                assert f"drivers:{engine}/{backend}" in names
        assert {"drivers:serve_snapshot/mapreduce",
                "drivers:serve_query/ref",
                "drivers:lm_prefill_decode/gemma2_2b",
                "drivers:lm_train_step/gemma2_2b"} <= names

    def test_the_cli_never_falls_back_from_cuda(self, monkeypatch):
        """--device cuda without a card: every driver raises (DR001), the
        gate fails, nothing runs on the CPU instead."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        ctx = AnalysisContext(device="cuda")
        found = dp.run_pass(ctx)
        assert len(found) == 24
        assert all("device='cpu'" in f.message or "CUDA" in f.message
                   for f in found)


# ----------------------------------------------------------------- serve
def test_service_programs_are_the_services_own_steps():
    """``ingest_program(k)`` on a state equals ``ingest_chunks(k)`` on the
    resident one, and ``snapshot_program()`` equals ``snapshot()``."""
    from repro_torch.core.streaming import state_init
    from repro_torch.malgen import MalGenConfig, make_seed_streaming
    from repro_torch.serve import MalStoneService

    cfg = MalGenConfig(num_sites=24, num_entities=64)
    seed = make_seed_streaming(3, cfg, 8, 32, device="cpu")
    svc = MalStoneService(nodes=2, num_sites=24, chunk_records=32,
                          backend="mapreduce", seed=seed, cfg=cfg,
                          num_chunks=8, device="cpu")
    state = state_init("mapreduce", 2, svc.s_pad, svc.num_weeks, "cpu")
    state = svc.ingest_program(3)(state)
    svc.ingest_chunks(2)
    svc.ingest_chunks(1)
    hist, stats = svc.snapshot_program()(state)
    want_hist, want_stats = svc.snapshot()
    assert state.chunks_folded == svc.chunks_folded == 3
    assert torch.equal(hist[:24], want_hist)
    assert stats._asdict().keys() == want_stats._asdict().keys()
    for f in ("sent", "overflow", "residual", "bytes_exchanged"):
        assert torch.equal(getattr(stats, f), getattr(want_stats, f))
    with pytest.raises(ValueError, match="overruns"):
        svc.ingest_program(2)(state_init("mapreduce", 2, svc.s_pad,
                                         svc.num_weeks, "cpu")._replace(
            chunks_folded=3))


# ------------------------------------------------------------------ lint
class TestLintPass:
    def test_seeded_assert_fires_ln001(self, tmp_path):
        pkg = tmp_path / "pkg"
        pkg.mkdir()
        (pkg / "mod.py").write_text(
            '"""doc: assert in a docstring does not count."""\n'
            "# assert in a comment neither\n"
            "def f(x):\n"
            "    assert x > 0, 'positive'\n"
            "    return x\n")
        found = lint.asserts_pass(AnalysisContext(device=None,
                                                  src_root=str(pkg)))
        assert [(f.rule, f.target, f.location) for f in found] == [
            ("LN001", "lint:pkg/mod.py", "L4")]

    def test_port_lint_gives_jaxs_keys_over_the_jax_package(self):
        src = str(ROOT / "src" / "repro")
        port = lint.asserts_pass(AnalysisContext(device=None, src_root=src))
        ref = jax_lint.asserts_pass(JaxContext(src_root=src))
        assert [f.key for f in port] == [f.key for f in ref]


# ---------------------------------------------------------------- the gate
def test_live_suite_is_clean_against_the_committed_baseline(capsys):
    baseline = load_report(ROOT / "results" / "analysis_baseline_torch.json")
    assert baseline == []
    assert cli.main(["--target", "all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "gate: OK" in out and "0 new" in out


def test_cli_usage_errors_exit_2(capsys):
    assert cli.main(["--target", "jaxpr"]) == 2
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "tpu"])
    assert exc.value.code == 2


def test_cli_runs_programs_on_the_card_unless_asked(monkeypatch, capsys):
    """Without ``--device``, the families that run programs take the card,
    as every entry point of the port does: without one the CLI exits 2
    before any pass runs, and never falls back to the CPU. The kernel and
    lint families run no program and need no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(cli, "run_passes",
                        lambda fams, ctx: ran.append(ctx.device) or [])
    for family in DEVICE_FAMILIES:
        assert cli.main(["--target", family]) == 2
        assert "no CUDA device" in capsys.readouterr().err
    assert ran == []
    assert cli.main(["--target", "kernels,lint"]) == 0
    assert cli.main(["--target", "drivers", "--device", "cpu"]) == 0
    assert ran == [None, torch.device("cpu")]
    with pytest.raises(TypeError):
        AnalysisContext()


def test_cli_update_baseline_and_report(tmp_path):
    base, report = tmp_path / "b.json", tmp_path / "r.json"
    assert cli.main(["--target", "lint", "--baseline", str(base),
                     "--update-baseline"]) == 0
    assert load_report(base) == []
    assert cli.main(["--target", "kernels", "--report", str(report),
                     "--no-baseline"]) == 0
    assert load_report(report) == []
