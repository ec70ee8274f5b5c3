from repro_torch.kernels.segment_hist.ops import (
    segment_hist,
    segment_hist_eventlog,
    segment_hist_packed_words,
    segment_hist_packed_words_plain,
    segment_hist_plain,
)
from repro_torch.kernels.segment_hist.ref import segment_hist_ref

__all__ = ["segment_hist", "segment_hist_eventlog",
           "segment_hist_packed_words", "segment_hist_packed_words_plain",
           "segment_hist_plain", "segment_hist_ref"]
