"""How the port's CUDA kernels are built (``kernels/_build.py``), on the
CPU: nothing here runs nvcc."""

from repro_torch.kernels import _build


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
