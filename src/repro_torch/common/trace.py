"""The port's span and counter recorder: what a layer of the port spent on
the host, and what it counted, put down where the work happens.

Off by default. ``span(name, req=None)`` is a context manager; off, it is
one shared null context (no clock read, no allocation), and ``count`` does
nothing. ``start()`` clears the store and turns recording on; ``stop()``
turns it off and returns ``(spans, counters)``. Everything stays in memory;
nothing is written anywhere.

- A span is a :class:`Span` ``(name, start_ns, end_ns, parent, req)``. The
  times are ``time.time_ns()``, the clock ``torch.profiler``'s records of
  the card are held against, so a span can be laid over the device trace.
  ``parent`` is the index (in the returned list) of the span that was open
  around it on the same host thread, which gives each thread a tree.
  ``req`` ties the spans of one request together: a job's number, an
  ingest step's, a query batch's ticket.
- Counters are by name. The kernel wrappers' launches are not counted
  again: ``stop()`` adds ``launches.<wrapper>``, the difference of
  ``repro_torch.kernels.launch_counts()`` over the recording.
- Every read that makes the host wait for the card goes through
  :func:`host_read` (a device value to a Python int) or :func:`host_wait`
  (an event or a stream). On, each is a ``host.sync.<site>`` span and a
  count of ``host.syncs.<site>``; the value and the wait are the same on
  or off.

The spans of the layers (``run.*``, ``stream.*``, ``malgen.*``,
``shuffle.*``, ``serve.*``, ``query.*``, ``collective.*``) are named where
they are opened; ``tools/trace_cell.py`` lays them over a traced run of a
benchmark cell.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Optional

SYNC_SPAN = "host.sync."
SYNC_COUNT = "host.syncs."


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]     # index of the enclosing span, None at the top
    req: object = None        # the job, ingest step or ticket it serves


class _Open:
    """A span being recorded (``Recorder.span`` while on)."""

    __slots__ = ("rec", "name", "req", "store", "idx")

    def __init__(self, rec: "Recorder", name: str, req):
        self.rec, self.name, self.req = rec, name, req

    def __enter__(self):
        self.store, self.idx = self.rec._open(self.name, self.req)
        self.rec._stack().append(self)
        return self

    def __exit__(self, *exc):
        self.store[self.idx][2] = time.time_ns()
        stack = self.rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False


class Recorder:
    """The store of one process's spans and counters (``trace.RECORDER``;
    the module's functions act on it)."""

    def __init__(self):
        self.on = False
        self._spans: list = []       # [name, start, end, parent, req]
        self._counts: dict = {}
        self._seq: dict = {}
        self._launches: dict = {}
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _parent(self) -> Optional[int]:
        stack = self._stack()
        if stack and stack[-1].store is self._spans:
            return stack[-1].idx
        return None

    def _open(self, name: str, req):
        store = self._spans
        parent = self._parent()
        store.append([name, time.time_ns(), None, parent, req])
        return store, len(store) - 1

    def start(self) -> None:
        from repro_torch.kernels import launch_counts

        self._spans, self._counts, self._seq = [], {}, {}
        self._launches = launch_counts()
        self.on = True

    def stop(self) -> tuple:
        """``(spans, counters)`` since ``start()``; a span still open is
        cut at this call. Off again afterwards."""
        from repro_torch.kernels import launch_counts

        if not self.on:
            return [], {}
        end = time.time_ns()
        self.on = False
        spans = [Span(n, s, end if e is None else e, p, r)
                 for n, s, e, p, r in self._spans]
        counters = dict(self._counts)
        after = launch_counts()
        counters.update({f"launches.{k}": n - self._launches.get(k, 0)
                         for k, n in after.items()})
        self._spans, self._counts, self._seq = [], {}, {}
        return spans, counters

    def span(self, name: str, req=None):
        if not self.on:
            return _NULL
        return _Open(self, name, req)

    def record(self, name: str, start_ns: int, end_ns: int,
               req=None) -> None:
        """A span already timed by the caller, under the open span."""
        if self.on:
            self._spans.append([name, start_ns, end_ns, self._parent(), req])

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self._counts[name] = self._counts.get(name, 0) + n

    def seq(self, name: str) -> Optional[int]:
        """The number of the next ``name`` request since ``start()`` (0,
        1, ...); None when off."""
        if not self.on:
            return None
        k = self._seq.get(name, 0)
        self._seq[name] = k + 1
        return k


_NULL = contextlib.nullcontext()
RECORDER = Recorder()


def start() -> None:
    """Clear the store and record from now on."""
    RECORDER.start()


def stop() -> tuple:
    """Stop recording: ``(spans, counters)`` since ``start()``."""
    return RECORDER.stop()


def span(name: str, req=None):
    """``with span("stream.step", req=i): ...`` records the block."""
    return RECORDER.span(name, req)


def record(name: str, start_ns: int, end_ns: int, req=None) -> None:
    RECORDER.record(name, start_ns, end_ns, req)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def seq(name: str) -> Optional[int]:
    return RECORDER.seq(name)


def host_read(x, site: str) -> int:
    """``int(x)`` of a one-element tensor: on the card the host waits for
    the work queued before it. Recorded as a ``host.sync.<site>`` span and
    counted as ``host.syncs.<site>``."""
    if not RECORDER.on:
        return int(x)
    with RECORDER.span(SYNC_SPAN + site):
        value = int(x)
    RECORDER.count(SYNC_COUNT + site)
    return value


def host_wait(waitable, site: str) -> tuple:
    """``waitable.synchronize()`` (a CUDA event or stream): the host waits
    for the work recorded before it. Returns the clock reads around the
    wait, ``(start_ns, end_ns)``, which the span takes too."""
    t0 = time.time_ns()
    waitable.synchronize()
    t1 = time.time_ns()
    if RECORDER.on:
        RECORDER.record(SYNC_SPAN + site, t0, t1)
        RECORDER.count(SYNC_COUNT + site)
    return t0, t1
