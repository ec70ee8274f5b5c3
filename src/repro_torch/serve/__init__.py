"""MalStone as a service: the resident, incrementally updated query engine.

- ``engine``: :class:`MalStoneService` keeps the streaming engine's
  ``HistogramState`` resident on the device, folds record chunks into it
  (equal to the streaming run) and answers batched queries; submit / wait /
  stats client surface.
- ``queries``: :class:`QuerySpec` (A / B / B-fixed over monitor windows,
  top-k, drill-down), encoding to week masks, ``batched_query`` (K5 on the
  card) and answer decoding.
"""

from repro_torch.serve.engine import (
    MalStoneService,
    ServiceStats,
    ingest_slices,
)
from repro_torch.serve.queries import (
    QueryAnswer,
    QueryBatch,
    QuerySpec,
    batched_query,
    decode_answers,
    default_query_mix,
    encode_query_batch,
    growing_window_specs,
    query_masks,
)

__all__ = [
    "MalStoneService",
    "ServiceStats",
    "ingest_slices",
    "QueryAnswer",
    "QueryBatch",
    "QuerySpec",
    "batched_query",
    "decode_answers",
    "default_query_mix",
    "encode_query_batch",
    "growing_window_specs",
    "query_masks",
]
