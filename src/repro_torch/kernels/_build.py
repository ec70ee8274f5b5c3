"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles, on its first CUDA use, into its own
shared library with a plain C interface (``-gencode
arch=compute_90a,code=sm_90a -O3``, no fast math). One ``nvcc`` runs per
source, all started together. The libraries go into
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3]
             / "build" / "repro_torch_kernels")
SOURCES = ("count_scatter", "segment_hist", "segment_hist_packed",
           "windowed_ratio_masked", "powerlaw_sample", "windowed_ratio",
           "combine_blocks", "ship_buckets")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "CUDA kernels are built from src/repro_torch/kernels/csrc/ on "
            "first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel.

    Returns ``{name: ptxas report}`` for the sources built by this call
    (empty when all were already built). Raises with nvcc's output if a
    build fails.
    """
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, library_path(name))   # atomic: readers never see
        reports[name] = out                   # a half-written library
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return reports


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    build_all()
    return ctypes.CDLL(str(library_path(name)))


def kernel_attributes(lib: ctypes.CDLL, kernels: tuple) -> dict:
    """``{kernel: {static_smem, registers, max_threads, max_dynamic_smem}}``
    as the card reports them (``cudaFuncGetAttributes``, through the
    source's ``kernel_attributes`` entry point), for the kernels of one
    source in its order."""
    out = (ctypes.c_int * 4)()
    attrs = {}
    for k, name in enumerate(kernels):
        err = lib.kernel_attributes(k, ctypes.addressof(out))
        if err != 0:
            raise RuntimeError(f"kernel_attributes({name}): CUDA error {err}")
        attrs[name] = dict(zip(("static_smem", "registers", "max_threads",
                                "max_dynamic_smem"), out))
    return attrs


def bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    """Declare each entry point's arguments ("p" pointer, "q" int64, "i"
    int32, in order) and its int32 result."""
    kinds = {"p": ctypes.c_void_p, "q": ctypes.c_longlong, "i": ctypes.c_int}
    for name, sig in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[k] for k in sig]
        fn.restype = ctypes.c_int
    return lib
