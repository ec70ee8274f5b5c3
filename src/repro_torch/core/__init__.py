from repro_torch.core.api import ENGINES, run
from repro_torch.core.runner import (
    malstone_run,
    malstone_run_generated,
    malstone_run_generated_streaming,
    malstone_run_partitioned,
    malstone_run_streaming,
    malstone_single_device,
    pad_log_to,
)
from repro_torch.core.resume import (
    RecoveryReport,
    ResumableRunner,
    ResumeOutcome,
    malstone_run_resumable,
)

__all__ = ["ENGINES", "RecoveryReport", "ResumableRunner", "ResumeOutcome",
           "malstone_run", "malstone_run_generated",
           "malstone_run_generated_streaming", "malstone_run_partitioned",
           "malstone_run_resumable", "malstone_run_streaming",
           "malstone_single_device", "pad_log_to", "run"]
