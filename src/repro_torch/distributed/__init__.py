"""Distributed substrate: pipeline parallelism over stages.

Counterpart of ``repro/distributed/``.
"""

from repro_torch.distributed.pipeline import PipelineConfig, pipeline_apply

__all__ = ["pipeline_apply", "PipelineConfig"]
