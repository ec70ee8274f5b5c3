"""Overlap-pipelined streaming: hide the exchange behind the next chunk's
generation.

Counterpart of ``repro/core/overlap.py``. The streaming engine
(``malstone_run_streaming``) runs each step strictly in order: chunk k's
MalGen generation, then its exchange and reduce (for ``mapreduce``, the
multi-round record shuffle, whose round loop reads a count back to the
host every round), then chunk k+1. This module drives the same per-chunk
steps from the host, double-buffered:

- ``_chunk(k)``  — every local node's chunk ``d * cpd + k`` as one
  ``[P_local, C]`` step (``generate_chunks``; in a gang of processes, the
  nodes of the runner's ``group``, whose collectives run over the gang);
- ``fold``       — one :func:`~repro_torch.core.streaming.fold_chunk`
  step (the per-chunk exchange + reduce), the carry updated in place;
- ``snapshot``   — :func:`~repro_torch.core.streaming.snapshot`.

On the card, ``overlap=True`` generates on a second CUDA stream: chunk
k+1's generation is enqueued there before chunk k's fold is enqueued on
the caller's current stream, which waits for an event recorded after the
chunk's generation. While the fold's round loop blocks the host on its
counts, the generation already in flight runs beside it. ``overlap=False``
makes the same calls on the same streams, synchronising after every
generation and every fold, so the schedule is the only variable between
the two timings.

Node d folds chunks ``d*cpd .. d*cpd+cpd-1`` in order, the schedule of
``streaming_histogram_generate``, through the same ``fold_chunk`` and
``merge_stats``, so the histogram and every ``ShuffleStats`` field equal
the streaming engine's exactly, with either value of ``overlap``. A
chunk's random draws come from generators seeded by its chunk id, so they
do not depend on the stream that makes them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.nodes import NodeGroup, group_of, resolve_device
from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
from repro_torch.core.runner import (
    _finalize,
    _pad_sites,
    _raise_if_exhausted,
)
from repro_torch.core.streaming import (
    STREAM_BACKENDS,
    fold_chunk,
    snapshot,
    state_init,
)
from repro_torch.malgen.generator import generate_chunks


class OverlapStreamingRunner:
    """Double-buffered seed-mode streaming over ``nodes`` nodes.

    Build once per (nodes, backend, chunk geometry) and call ``run`` as
    often as needed (the bench loop): the generation stream is made once.
    ``seed`` comes from ``make_seed_streaming`` at ``chunk_records``;
    ``num_chunks`` is the global chunk count and must divide over the
    nodes. The runner works on the card unless ``device="cpu"`` is given,
    over the nodes of ``group`` (default: all ``nodes``).
    """

    def __init__(self, seed, cfg, *, nodes: int, num_chunks: int,
                 chunk_records: int, num_sites: Optional[int] = None,
                 backend: str = "streams", num_weeks: int = WEEKS_PER_YEAR,
                 plan: Optional[ExchangePlan] = None, device=None,
                 group: Optional[NodeGroup] = None):
        if backend not in STREAM_BACKENDS:
            raise ValueError(
                f"unknown streaming backend {backend!r};"
                f" have {STREAM_BACKENDS}")
        if num_chunks % nodes != 0:
            raise ValueError(
                f"num_chunks ({num_chunks}) must divide over the"
                f" {nodes} nodes")
        self.plan = plan or ExchangePlan()
        self.device = resolve_device(device)
        self.seed, self.cfg = seed.to(self.device), cfg
        self.nodes, self.backend, self.num_weeks = nodes, backend, num_weeks
        self.group = group_of(group, nodes)
        self.chunk_records = chunk_records
        self.num_sites = num_sites or cfg.num_sites
        self.cpd = num_chunks // nodes
        self.s_pad = _pad_sites(self.num_sites, nodes)
        self._gen_stream = None

    # ---------------------------------------------------------------- steps
    def _chunk(self, k: int):
        """Step k's ``[P_local, C]`` chunk: local node d's chunk ``d * cpd
        + k``."""
        first = self.group.first
        return generate_chunks(
            self.seed, self.cfg,
            [d * self.cpd + k for d in range(first, first + self.group.local)],
            self.chunk_records)

    def _fold(self, state, chunk):
        return fold_chunk(state, chunk, backend=self.backend,
                          s_pad=self.s_pad, num_weeks=self.num_weeks,
                          plan=self.plan, group=self.group)

    def _generate_on(self, stream, k: int, reader):
        """Enqueue step k's generation on ``stream``; return the chunk and
        an event recorded after it. Its columns are marked as used by the
        ``reader`` stream, so the caching allocator does not hand their
        memory to a later generation before the fold that reads them has
        run."""
        with torch.cuda.stream(stream):
            chunk = self._chunk(k)
            ready = torch.cuda.Event()
            ready.record(stream)
        for col in chunk:
            if col is not None:
                col.record_stream(reader)
        return chunk, ready

    def _run_on_streams(self, state, overlap: bool):
        main = torch.cuda.current_stream(self.device)
        if self._gen_stream is None:
            self._gen_stream = torch.cuda.Stream(self.device)
        gen = self._gen_stream
        gen.wait_stream(main)       # the seed and the zero carry
        if overlap:
            chunk, ready = self._generate_on(gen, 0, main)
            for k in range(self.cpd):
                nxt = (self._generate_on(gen, k + 1, main)
                       if k + 1 < self.cpd else None)
                main.wait_event(ready)
                state = self._fold(state, chunk)
                # depth bound: chunk k+2 is not enqueued before fold k has
                # run, so at most two chunks are in flight
                main.synchronize()
                if nxt is not None:
                    chunk, ready = nxt
        else:
            for k in range(self.cpd):
                chunk, ready = self._generate_on(gen, k, main)
                gen.synchronize()
                main.wait_event(ready)
                state = self._fold(state, chunk)
                main.synchronize()
        return state

    # ------------------------------------------------------------------ run
    def run(self, *, overlap: bool = True):
        """One full pass over all chunks -> ``(histogram[s_pad, W, 2],
        stats)`` (the global ShuffleStats for ``mapreduce``, else None).

        On the card, ``overlap=True`` double-buffers over two CUDA streams
        (generation on the runner's own stream, folds on the caller's
        current one) and ``overlap=False`` runs the same calls strictly
        serialised. On the CPU, which has no streams, both run the serial
        order. Every ordering folds the same chunks in the same per-node
        order, so the results are bit-identical.
        """
        state = state_init(self.backend, self.nodes, self.s_pad,
                           self.num_weeks, self.device, self.group)
        if self.device.type == "cuda":
            state = self._run_on_streams(state, overlap)
        else:
            for k in range(self.cpd):
                state = self._fold(state, self._chunk(k))
        return snapshot(state, backend=self.backend, s_pad=self.s_pad,
                        num_weeks=self.num_weeks, group=self.group)

    def run_result(self, statistic: str = "B", *, overlap: bool = True):
        """``run`` + finalize: ``(SpmResult, stats)`` over the unpadded
        sites, with the lossless-shuffle guard applied."""
        hist, stats = self.run(overlap=overlap)
        if self.backend == "mapreduce":
            _raise_if_exhausted(stats)
        return _finalize(hist[:self.num_sites], statistic), stats
