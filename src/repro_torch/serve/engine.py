"""MalStone as a service: a resident, incrementally updated query engine.

Counterpart of ``repro/serve/engine.py``. ``MalStoneService`` keeps the
streaming engine's :class:`~repro_torch.core.streaming.HistogramState`
resident on the device and folds record chunks into it with the same
per-chunk dataflow as the streaming drivers, so after any sequence of
ingests the snapshot histogram (and mapreduce's accumulated
``ShuffleStats``) equals ``malstone_run_streaming`` over the same chunks.
Queries never touch the carry: a batch of
:class:`~repro_torch.serve.queries.QuerySpec` is encoded into mask rows and
answered by ``batched_query`` over the resident snapshot (one launch of
K5).

Two ingest sources, as in ``malstone_run_streaming``:

- **log mode**: ``ingest(chunk)`` folds a flat chunk of ``nodes *
  chunk_records`` records (node d takes block d); ``ingest_slices`` cuts a
  whole log into exactly the (node, chunk) grouping the streaming engine
  uses, so chunk-by-chunk ingest reproduces its run, ``ShuffleStats.rounds
  = max over chunks`` included.
- **seed mode**: ``ingest_chunks(k)`` regenerates the next ``k`` chunks of
  every node from the streaming seed (node d folds chunks ``[d * cpn +
  done, d * cpn + done + k)``), so no records cross the host.

``submit`` encodes a batch, launches its work on the current stream,
records an event behind it (on the card) and returns a ticket at once;
``wait`` waits for that event, then copies the answers to the host, so the
wait for the device and the copy are two parts. The P nodes are the
leading axis of the state on one device: the constructor takes ``nodes=``
where the JAX service takes a mesh. ``ingest_program(k)`` and
``snapshot_program()`` are the counterparts of the JAX service's jitted
programs: plain ``state -> state`` (and ``state -> (histogram, stats)``)
callables that the service itself runs and that ``repro_torch.analysis``'s
driver passes run on a state of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import torch

from repro_torch.common import nodes as nodes_lib
from repro_torch.common import trace
from repro_torch.common.types import EventLog, ExchangePlan, WEEKS_PER_YEAR
from repro_torch.core.runner import (
    _finalize,
    _pad_sites,
    _raise_if_exhausted,
    pad_log_to,
)
from repro_torch.core.streaming import (
    HistogramState,
    STREAM_BACKENDS,
    fold_chunk,
    fold_chunk_range,
    snapshot,
    state_init,
    state_zeros_host,
)
from repro_torch.serve.queries import (
    QueryBatch,
    QuerySpec,
    answers_to_host,
    batched_query,
    encode_query_batch,
    split_answers,
)


def ingest_slices(log: EventLog, parts: int,
                  chunk_records: int) -> Iterator[EventLog]:
    """Cut a flat log into flat ingest chunks in the streaming engine's
    (node, chunk) grouping: node d holds the contiguous shard ``log[d *
    per_node:(d+1) * per_node]``, and ingest chunk j joins, in node order,
    every node's j-th chunk of ``chunk_records`` rows. Short logs are
    padded with invalid rows, as ``malstone_run_streaming`` pads them."""
    stride = parts * chunk_records
    per_node = -(-log.num_records // stride) * chunk_records
    log = pad_log_to(log, per_node * parts)
    steps = per_node // chunk_records
    cols = log.map(lambda c: c.reshape(parts, steps, chunk_records))
    for j in range(steps):
        yield cols.map(lambda c: c[:, j].reshape(-1))


@dataclasses.dataclass
class ServiceStats:
    """Service accounting (``MalStoneService.stats()``); no device wait."""

    chunks_folded: int            # per-node chunk cursor
    records_ingested: int         # rows folded over all nodes (with padding)
    ingest_calls: int
    batches_submitted: int
    batches_answered: int
    queries_submitted: int        # QuerySpecs over all batches
    queries_answered: int
    pending: int                  # batches submitted and not yet waited


@dataclasses.dataclass
class _PendingBatch:
    batch: QueryBatch
    outputs: tuple                # device tensors, work in flight
    done: Optional[torch.cuda.Event] = None   # recorded behind the work


class MalStoneService:
    """Always-on incremental MalStone engine over ``nodes`` nodes on one
    device (the card unless ``device="cpu"``).

    ``seed`` / ``cfg`` / ``num_chunks`` (a seed from
    ``make_seed_streaming``) enable seed-mode ingest (``ingest_chunks``);
    log-mode ``ingest`` is always available. ``plan`` configures the
    mapreduce exchange and the reducers, as in the drivers.
    """

    def __init__(self, *, nodes: int, num_sites: int, chunk_records: int,
                 backend: str = "streams", num_weeks: int = WEEKS_PER_YEAR,
                 seed=None, cfg=None, num_chunks: Optional[int] = None,
                 plan: Optional[ExchangePlan] = None, device=None):
        if backend not in STREAM_BACKENDS:
            raise ValueError(f"unknown streaming backend {backend!r}; "
                             f"have {STREAM_BACKENDS}")
        if chunk_records <= 0:
            raise ValueError(f"chunk_records must be > 0, got {chunk_records}")
        if nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {nodes}")
        self.device = nodes_lib.resolve_device(device)
        self.backend, self.plan = backend, plan or ExchangePlan()
        self.num_sites, self.num_weeks = num_sites, num_weeks
        self.chunk_records = chunk_records
        self.parts = nodes
        self.s_pad = _pad_sites(num_sites, nodes)
        self._fold_kw = dict(backend=backend, s_pad=self.s_pad,
                             num_weeks=num_weeks, plan=self.plan)

        self.seed, self.cfg, self.cpd = None, cfg, None
        if seed is not None or cfg is not None or num_chunks is not None:
            if seed is None or cfg is None or num_chunks is None:
                raise ValueError("seed-mode ingest needs all of seed=, cfg= "
                                 "and num_chunks=")
            if num_chunks % nodes:
                raise ValueError(f"num_chunks ({num_chunks}) must divide "
                                 f"over the {nodes} nodes")
            self.seed = seed.to(self.device)
            self.cpd = num_chunks // nodes

        self._state = self._zero_state()
        # snapshot cache: refreshed lazily, invalidated by ingest and reset
        self._dirty = True
        self._hist = None            # device [num_sites, W, 2] snapshot
        self._last_shuffle_stats = None

        self._records_ingested = 0
        self._ingest_calls = 0
        self._queries_submitted = 0
        self._queries_answered = 0
        self._batches_submitted = 0
        self._batches_answered = 0
        self._next_ticket = 0
        self._pending: dict = {}

    # ----------------------------------------------------------- state
    def _zero_state(self) -> HistogramState:
        return state_init(self.backend, self.parts, self.s_pad,
                          self.num_weeks, self.device)

    def reset(self) -> None:
        """Zero the resident state and the ingest accounting (the query
        counters survive)."""
        self._state = self._zero_state()
        self._records_ingested = 0
        self._ingest_calls = 0
        self._dirty = True

    @property
    def chunks_folded(self) -> int:
        """Chunks each node has folded."""
        return self._state.chunks_folded

    # ---------------------------------------------------------- ingest
    def ingest(self, chunk: EventLog) -> None:
        """Fold one flat chunk of ``nodes * chunk_records`` records (node d
        takes block d) into the resident state."""
        expected = self.parts * self.chunk_records
        if chunk.site_id.dim() != 1 or chunk.num_records != expected:
            raise ValueError(
                f"ingest chunk has shape {tuple(chunk.site_id.shape)}; this "
                f"service folds {expected} records per ingest ({self.parts} "
                f"nodes x {self.chunk_records}); use ingest_slices / "
                f"ingest_log to cut a full log")
        with trace.span("serve.ingest", req=trace.seq("serve.ingest")):
            chunk = chunk._replace(valid=chunk.valid_mask()).map(
                lambda c: c.to(self.device).reshape(self.parts, -1))
            self._state = fold_chunk(self._state, chunk, **self._fold_kw)
        self._records_ingested += expected
        self._ingest_calls += 1
        self._dirty = True

    def ingest_log(self, log: EventLog) -> int:
        """Ingest every chunk of ``ingest_slices(log)``; returns how many."""
        n = 0
        for chunk in ingest_slices(log, self.parts, self.chunk_records):
            self.ingest(chunk)
            n += 1
        return n

    def ingest_chunks(self, k: int = 1) -> None:
        """Seed mode: regenerate and fold the next ``k`` chunks of every
        node (node d folds chunks ``[d * cpn + done, + k)``), so any
        schedule covering all ``cpn`` chunks equals the one-shot streaming
        run. One ``serve.ingest`` span."""
        with trace.span("serve.ingest", req=trace.seq("serve.ingest")):
            self._state = self.ingest_program(k)(self._state)
        self._records_ingested += k * self.parts * self.chunk_records
        self._ingest_calls += 1
        self._dirty = True

    # -------------------------------------------------------- snapshot
    def _refresh(self) -> torch.Tensor:
        """The resident snapshot, re-made (a ``serve.snapshot`` span) if an
        ingest landed since the last one; queries read this cached device
        histogram."""
        if self._dirty or self._hist is None:
            with trace.span("serve.snapshot"):
                hist, stats = self.snapshot_program()(self._state)
                _raise_if_exhausted(stats)
                self._last_shuffle_stats = stats
                self._hist = hist[:self.num_sites].contiguous()
                self._dirty = False
            trace.count("serve.snapshot_rebuilds")
        else:
            trace.count("serve.snapshot_hits")
        return self._hist

    def snapshot(self):
        """(histogram, shuffle_stats): the int32 ``[num_sites, W, 2]``
        histogram on the service's device and, for mapreduce, the
        chunk-accumulated global ``ShuffleStats`` (else ``None``), equal
        to ``malstone_run_streaming`` over the same chunks."""
        return self._refresh(), self._last_shuffle_stats

    def result(self, statistic: str = "B"):
        """The resident snapshot finalized as a full ``SpmResult``."""
        return _finalize(self._refresh(), statistic)

    # --------------------------------------------------------- queries
    def submit(self, specs: Sequence[QuerySpec]) -> int:
        """Encode a query batch and launch its work; returns a ticket at
        once (the device works on while the host goes on). One
        ``serve.submit`` span (``req`` the ticket)."""
        ticket = self._next_ticket
        with trace.span("serve.submit", req=ticket):
            with trace.span("query.encode", req=ticket):
                batch = encode_query_batch(specs, self.num_weeks,
                                           self.num_sites)
            hist = self._refresh()

            def dev(x):
                return torch.from_numpy(x).to(self.device)

            with trace.span("query.launch", req=ticket):
                # pageable uploads: the first waits for the stream's queue
                with trace.span("query.upload", req=ticket):
                    masks = (dev(batch.num_masks), dev(batch.den_masks),
                             dev(batch.sites))
                outputs = batched_query(hist, *masks,
                                        max_top_k=batch.max_top_k)
                done = None
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
        self._next_ticket += 1
        self._pending[ticket] = _PendingBatch(batch=batch, outputs=outputs,
                                              done=done)
        self._batches_submitted += 1
        self._queries_submitted += len(batch.specs)
        return ticket

    def wait(self, ticket: int) -> list:
        """The decoded ``QueryAnswer`` list of one ticket: waits for its
        device work (``host.sync.query_done``), copies the answers to the
        host (``query.copy``) and splits them (``query.decode``), in one
        ``serve.wait`` span (``req`` the ticket)."""
        pending = self._pending.pop(ticket, None)
        if pending is None:
            raise KeyError(f"unknown or already-collected ticket {ticket!r}")
        with trace.span("serve.wait", req=ticket):
            if pending.done is not None:
                trace.host_wait(pending.done, "query_done")
            with trace.span("query.copy", req=ticket):
                host = answers_to_host(pending.outputs)
            trace.count("query.copy_bytes", sum(a.nbytes for a in host))
            with trace.span("query.decode", req=ticket):
                answers = split_answers(pending.batch, host)
        self._batches_answered += 1
        self._queries_answered += len(answers)
        return answers

    def wait_all(self) -> dict:
        """Drain every ticket in flight -> {ticket: answers}."""
        return {t: self.wait(t) for t in sorted(self._pending)}

    def query(self, specs: Sequence[QuerySpec]) -> list:
        """``wait(submit(specs))``."""
        return self.wait(self.submit(specs))

    # ---------------------------------------------------- introspection
    def ingest_program(self, k: int = 1):
        """Seed-mode ingest as a plain ``state -> state`` callable: folds
        the next ``k`` chunks of every node after the state's cursor (JAX
        ``ingest_program``'s counterpart). ``ingest_chunks`` runs it on the
        resident state; pair it with :meth:`zero_state_host` (moved to the
        service's device) to run it on another."""
        if self.cpd is None:
            raise ValueError(
                "this service was built without seed=/cfg=/num_chunks=; "
                "seed-mode ingest is unavailable (use ingest/ingest_log)")
        if k <= 0:
            raise ValueError(f"k must be > 0, got {k}")

        def program(state: HistogramState) -> HistogramState:
            done = state.chunks_folded
            if done + k > self.cpd:
                raise ValueError(
                    f"ingest_chunks({k}) overruns the configured stream: "
                    f"{done} of {self.cpd} per-node chunks already folded")
            first = [d * self.cpd + done for d in range(self.parts)]
            return fold_chunk_range(state, self.seed, self.cfg, first, k,
                                    self.chunk_records, **self._fold_kw)

        return program

    def snapshot_program(self):
        """The snapshot as a plain ``state -> (histogram [s_pad, W, 2],
        ShuffleStats or None)`` callable (JAX ``snapshot_program``'s
        counterpart); the state stays as it is."""
        def program(state: HistogramState):
            return snapshot(state, backend=self.backend, s_pad=self.s_pad,
                            num_weeks=self.num_weeks)

        return program

    # ------------------------------------------------------- accounting
    def zero_state_host(self) -> HistogramState:
        """A zero ``HistogramState`` in this service's layout, on the
        CPU."""
        return state_zeros_host(self.backend, self.parts, self.s_pad,
                                self.num_weeks)

    def stats(self) -> ServiceStats:
        return ServiceStats(
            chunks_folded=self.chunks_folded,
            records_ingested=self._records_ingested,
            ingest_calls=self._ingest_calls,
            batches_submitted=self._batches_submitted,
            batches_answered=self._batches_answered,
            queries_submitted=self._queries_submitted,
            queries_answered=self._queries_answered,
            pending=len(self._pending),
        )
