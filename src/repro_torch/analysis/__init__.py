"""The port's static checker suite (counterpart of ``repro.analysis``).

Four pass families over the live tree:

- ``drivers``     -- run every engine x backend and the service's
  programs eagerly at a tiny size, on the context's device, and audit the
  run: it raises (DR001), a carry or ShuffleStats field changes dtype
  (DR002), host syncs over a declared budget (DR004);
- ``kernels``     -- each CUDA kernel's launch plan at the analysis cases'
  shapes, against Hopper's limits and the sources' launch bounds and
  opt-ins (KG001-KG003); no kernel is built or launched;
- ``collectives`` -- the recorded collectives of every exchange, and of a
  gang of 2 processes over gloo (CL001-CL005);
- ``lint``        -- source-tree invariants (LN001).

Run ``python -m repro_torch.analysis --target all``; the gate diffs the
findings against ``results/analysis_baseline_torch.json``. This package
imports only the light schema and registry modules: the pass modules load
when passes run.
"""

from repro_torch.analysis.findings import (
    BaselineDiff,
    Finding,
    diff_against_baseline,
    load_report,
    sort_findings,
    write_report,
)
from repro_torch.analysis.registry import (
    DEVICE_FAMILIES,
    FAMILIES,
    RULES,
    AnalysisContext,
    AnalysisPass,
    iter_passes,
    register_pass,
    run_passes,
)

__all__ = [
    "BaselineDiff", "Finding", "diff_against_baseline", "load_report",
    "sort_findings", "write_report", "DEVICE_FAMILIES", "FAMILIES", "RULES",
    "AnalysisContext", "AnalysisPass", "iter_passes",
    "register_pass", "run_passes",
]
