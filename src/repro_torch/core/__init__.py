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

__all__ = ["ENGINES", "malstone_run", "malstone_run_generated",
           "malstone_run_generated_streaming", "malstone_run_partitioned",
           "malstone_run_streaming", "malstone_single_device",
           "pad_log_to", "run"]
