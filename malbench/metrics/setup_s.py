"""setup_s: process start to window start (import, CUDA, the kernel
libraries, the seed, the program's objects, the warm-up)."""


def read(run):
    return {"value": run.setup_s}
