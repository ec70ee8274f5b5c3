"""MalStone benchmark of the PyTorch and CUDA port (``repro_torch``).

``python malbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line. Configurations, traffic mixes and per-layer
metrics are files found by name: ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``metrics/<metric>.py``.
"""
