"""repro_torch.bench — the port's MalStone timing subsystem (counterpart of
``repro/bench``). Import the modules directly:

- ``timing``   — the timing protocol: warm-up floor and steady-state probe,
  the card synchronised before each clock read, median / min-of-k with
  dispersion.
- ``registry`` — named scenarios (the MalStone grid, the shuffle sweeps,
  the kernel pairs, MalGen phases, end-to-end rows, sweeps and serving)
  under the JAX package's names and params.
- ``schema``   — the ``BENCH_<name>.json`` document (writer, loader,
  validator), shared with the JAX package.
- ``run``      — ``python -m repro_torch.bench.run --preset smoke`` CLI.
- ``compare``  — ``python -m repro_torch.bench.compare a.json b.json``:
  diff two documents (of either package), exit nonzero on regression.
"""
