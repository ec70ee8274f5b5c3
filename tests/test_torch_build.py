"""How the port's CUDA kernels are built (``kernels/_build.py``), on the
CPU: nothing here runs nvcc."""

import re

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.count_scatter import ops as cs_ops
from repro_torch.kernels.powerlaw_sample import ops as ps_ops
from repro_torch.kernels.windowed_ratio import ops as wr_ops

TOOLS = _build.CSRC.parents[3] / "tools"


def test_kernels_build_for_sm_90a_without_fast_math():
    """The rho bits of K5 and K7 and the CDF searches of K6 depend on IEEE
    division and comparisons; fast math would flush denormals and take
    approximate divides. Hopper's own target keeps wgmma and setmaxnreg
    available."""
    flags = _build.NVCC_FLAGS
    i = flags.index("-gencode")
    assert flags[i + 1] == "arch=compute_90a,code=sm_90a"
    for bad in ("--use_fast_math", "-use_fast_math", "--ftz=true",
                "-ftz=true", "--prec-div=false", "-prec-div=false",
                "--prec-sqrt=false", "-prec-sqrt=false"):
        assert bad not in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)


def test_every_kernel_source_is_built():
    on_disk = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert on_disk == set(_build.SOURCES)


def test_library_name_follows_the_source_and_the_flags(monkeypatch):
    """An edited source or changed flags give a new library name, so a
    stale build is never loaded."""
    before = _build.library_path("segment_hist")
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("--use_fast_math",))
    assert _build.library_path("segment_hist") != before
    monkeypatch.undo()
    assert _build.library_path("segment_hist") == before
    assert (_build.library_path("segment_hist").parent == _build.BUILD_DIR)


def _c_entry_points(name: str, path=None) -> dict:
    """Argument kinds of each ``extern "C" int`` function of a source: "p"
    pointer, "q" long long, "i" int."""
    src = (path or _build.CSRC / f"{name}.cu").read_text()
    return {fn: "".join("p" if "*" in a else "q" if a.split()[0] == "long"
                        else "i" for a in args.split(",") if a.strip())
            for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src)}


@pytest.mark.parametrize("name,signatures", [
    ("count_scatter", cs_ops.SIGNATURES),
    ("windowed_ratio_masked", wr_ops.MASKED_SIGNATURES),
    ("powerlaw_sample", ps_ops.SIGNATURES),
    ("windowed_ratio", wr_ops.SIGNATURES)])
def test_ctypes_declarations_match_the_c_entry_points(name, signatures):
    """K1/K2's, K5's, K6's and K7's wrappers declare what their sources
    take: a wrong declaration passes a cut pointer or shifts the arguments
    (K5's takes the run lists' scratch since it encodes the masks on the
    card, K6's its guide table's)."""
    got = _c_entry_points(name)
    got.pop("powerlaw_sample_scratch", None)     # no arguments
    assert got == signatures


def test_first_designs_are_declared_as_their_source_takes_them():
    """``tools/first_designs.py`` binds each first design by hand (another
    checkout's package may lack ``_build.bind``); its declarations match
    ``tools/csrc/first_designs.cu``."""
    src = (TOOLS / "first_designs.py").read_text()
    declared = dict(re.findall(r'\("(\w+_first)", "([pqi]*)"\)', src))
    assert declared == _c_entry_points(
        "first_designs", TOOLS / "csrc" / "first_designs.cu")
    assert {"powerlaw_sample_first", "windowed_ratio_first"} <= set(declared)


def test_the_record_tile_matches_the_kernel():
    """K1 and K2 tile the records by ``ops.TILE``; the plain versions and
    the glue between the kernels use the same tile."""
    src = (_build.CSRC / "count_scatter.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src)
               .group(1)) == cs_ops.TILE == 4096
