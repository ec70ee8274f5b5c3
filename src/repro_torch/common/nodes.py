"""The P nodes of the JAX mesh as a leading ``[P]`` axis, in one process or
over a gang of processes.

The JAX package runs one program per mesh device and joins them with
``jax.lax`` collectives. The port holds a process's nodes in one tensor
whose axis 0 is the node. A :class:`NodeGroup` says which nodes those are:
all P of them in one process (the default), or, in a gang of N processes
joined by ``torch.distributed`` (``repro_torch.launch.coordinator``), the
contiguous block ``[rank * P/N, (rank+1) * P/N)``. Each collective is a
tensor op over the local axis, and in a gang also a gloo collective:

- ``all_to_all`` of ``[P_local, P_dst, C]`` buckets is a transpose (in a
  gang: the buckets regrouped by destination rank, ``all_to_all_single``,
  and reassembled in sender order);
- ``psum`` is a sum over axis 0 in int64, ``all_reduce``d in int64 in a
  gang, then wrapped to int32 as the int32 JAX psum wraps (gloo's int32
  sum is not guaranteed to wrap, so it is never asked for one);
- ``psum_scatter`` (tiled) is that sum cut into P contiguous blocks, of
  which a process keeps its own, and ``all_gather`` of contiguous blocks a
  gather plus a reshape;
- ``all_gather`` of the strided owned blocks plus the unstride of
  ``runner.py:174-176`` is a gather, a permute and a reshape;
- ``ppermute`` (JAX's ``lax.ppermute``: node ``dst`` receives node
  ``src``'s row for each pair, every other node zeros) copies rows within
  a process and sends the rest point to point;
- ``broadcast`` hands every process one node's tensor.

Gloo's support for CUDA tensors differs between collectives and builds, so
a gang stages every collective through the host explicitly: a copy into
pinned memory, the gloo call on CPU tensors, and the copy back. The
group's :class:`ExchangeClock` adds up each part's host-clock time and the
bytes handed to gloo, each element at its dtype's width in
:data:`WIRE_BYTES`; the same clock reads are the recorder's spans
(``repro_torch.common.trace``) of the parts: the wait
(``host.sync.collective.wait``), ``collective.d2h``, ``collective.gloo``
and ``collective.h2d``. With one process none of this runs: every
function is exactly the tensor op it was.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.common import trace


# Bytes of one element handed to gloo, by dtype: the table ExchangeClock's
# bytes (and the bench's gang rows, which report them) count with. The
# static analysis (CL004) checks every collective's dtype is in it.
WIRE_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int8: 1, torch.int16: 2,
              torch.float16: 2, torch.bfloat16: 2, torch.int32: 4,
              torch.float32: 4, torch.int64: 8, torch.float64: 8}


def wire_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` takes on the wire (its dtype must be in
    :data:`WIRE_BYTES`)."""
    return t.numel() * WIRE_BYTES[t.dtype]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Never falls back to the CPU on its own."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' to run its plain PyTorch path")
    return device


@dataclasses.dataclass
class ExchangeClock:
    """Host-clock milliseconds of a gang's collectives, by part: waiting
    for the device work queued before a collective (``wait_ms``), the copy
    to pinned host memory (``d2h_ms``), the gloo call (``gloo_ms``) and the
    copy back (``h2d_ms``, synchronised); ``bytes`` handed to gloo by this
    process and ``calls`` made. The CPU device has no copies."""

    wait_ms: float = 0.0
    d2h_ms: float = 0.0
    gloo_ms: float = 0.0
    h2d_ms: float = 0.0
    bytes: int = 0
    calls: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """The nodes this process holds: node ``first + i`` is row i of its
    tensors, for i < ``local``.

    ``nodes`` is the global P; ``rank`` and ``world`` place this process
    in its gang (one process: rank 0 of 1), whose collectives run over the
    default ``torch.distributed`` group. The nodes split evenly over the
    processes.
    """

    nodes: int
    rank: int = 0
    world: int = 1
    clock: ExchangeClock = dataclasses.field(
        default_factory=ExchangeClock, compare=False, repr=False)

    def __post_init__(self):
        if self.nodes < 1 or self.world < 1 or self.nodes % self.world:
            raise ValueError(f"{self.nodes} nodes do not split evenly over "
                             f"{self.world} processes")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} out of range for "
                             f"{self.world} processes")

    @property
    def local(self) -> int:
        """The nodes this process holds."""
        return self.nodes // self.world

    @property
    def first(self) -> int:
        """The global index of this process's first node."""
        return self.rank * self.local

    @property
    def distributed(self) -> bool:
        return self.world > 1

    def node_ids(self, device) -> torch.Tensor:
        """``[local, 1]`` global node index of each row."""
        return torch.arange(self.first, self.first + self.local,
                            device=device).unsqueeze(1)

    def rows(self, flat: torch.Tensor) -> torch.Tensor:
        """This process's ``[local, n]`` rows of a flat node-major column
        of ``nodes * n`` values (node d holding ``[d*n, (d+1)*n)``)."""
        return flat.reshape(self.nodes, -1)[self.first:self.first
                                            + self.local]


def group_of(group: Optional[NodeGroup], nodes: int) -> NodeGroup:
    """``group``, or one process holding all ``nodes`` nodes; a given
    group must be over ``nodes`` nodes."""
    if group is None:
        return NodeGroup(nodes)
    if group.nodes != nodes:
        raise ValueError(f"a group over {group.nodes} nodes, not {nodes}")
    return group


def group_of_rows(group: Optional[NodeGroup], rows: int) -> NodeGroup:
    """The group of a tensor with ``rows`` node rows: ``group``, whose
    process must hold that many nodes, or one process holding ``rows``
    nodes."""
    if group is None:
        return NodeGroup(rows)
    if group.local != rows:
        raise ValueError(f"{rows} node rows, but this process holds "
                         f"{group.local} of the group's {group.nodes}")
    return group


def _to_host(x: torch.Tensor, clock: ExchangeClock) -> torch.Tensor:
    """A CPU copy of ``x`` for gloo (pinned on the card's side)."""
    if x.device.type != "cuda":
        return x.contiguous()
    stream = torch.cuda.current_stream(x.device)
    t0, t1 = trace.host_wait(stream, "collective.wait")
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    stream.synchronize()
    t2 = time.time_ns()
    trace.record("collective.d2h", t1, t2)
    clock.wait_ms += (t1 - t0) / 1e6
    clock.d2h_ms += (t2 - t1) / 1e6
    return host


def _to_device(host: torch.Tensor, device: torch.device,
               clock: ExchangeClock) -> torch.Tensor:
    if device.type != "cuda":
        return host
    t0 = time.time_ns()
    out = host.to(device, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    t1 = time.time_ns()
    trace.record("collective.h2d", t0, t1)
    clock.h2d_ms += (t1 - t0) / 1e6
    return out


def _gloo(call, group: NodeGroup, nbytes: int) -> None:
    t0 = time.time_ns()
    call()
    t1 = time.time_ns()
    trace.record("collective.gloo", t0, t1)
    group.clock.gloo_ms += (t1 - t0) / 1e6
    group.clock.bytes += nbytes
    group.clock.calls += 1


def _all_reduce_sum(x: torch.Tensor, group: NodeGroup) -> torch.Tensor:
    host = _to_host(x, group.clock)      # x is the caller's own sum
    _gloo(lambda: dist.all_reduce(host), group, wire_bytes(host))
    return _to_device(host, x.device, group.clock)


def _host_like(host: torch.Tensor) -> torch.Tensor:
    return torch.empty(host.shape, dtype=host.dtype,
                       pin_memory=host.is_pinned())


def _gather_rows(x: torch.Tensor, group: NodeGroup) -> torch.Tensor:
    """``[local, ...]`` on every process -> ``[P, ...]`` in node order."""
    host = _to_host(x, group.clock)
    parts = [_host_like(host) for _ in range(group.world)]
    _gloo(lambda: dist.all_gather(parts, host), group, wire_bytes(host))
    return _to_device(torch.cat(parts), x.device, group.clock)


def all_to_all(buckets: torch.Tensor,
               group: Optional[NodeGroup] = None) -> torch.Tensor:
    """``[P_local, P_dst, ...]`` -> ``[P_local(dst), P_src, ...]``: node d
    receives bucket d of every sender, in sender order."""
    if group is None or not group.distributed:
        return buckets.transpose(0, 1).contiguous()
    loc, tail = group.local, buckets.shape[2:]
    # [world (destination rank), local (sender), local (destination), ...]
    send = buckets.reshape(loc, group.world, loc, *tail).transpose(
        0, 1).contiguous()
    host = _to_host(send, group.clock)
    recv = _host_like(host)
    _gloo(lambda: dist.all_to_all_single(recv, host), group,
          wire_bytes(host))
    recv = _to_device(recv, buckets.device, group.clock)
    # [world (sender rank), local (sender), local (mine), ...]
    return recv.reshape(group.nodes, loc, *tail).transpose(0, 1).contiguous()


def psum(x: torch.Tensor, dim: int = 0,
         group: Optional[NodeGroup] = None) -> torch.Tensor:
    """Sum of int32 values over the node axis ``dim``, wrapping modulo 2^32
    as the int32 JAX psum does. With a distributed ``group`` the sum also
    runs over every process's nodes (an int64 ``all_reduce``)."""
    s = x.sum(dim=dim, dtype=torch.int64)
    if group is not None and group.distributed:
        s = _all_reduce_sum(s, group)
    return (torch.remainder(s + 2**31, 2**32) - 2**31).to(torch.int32)


def psum_scatter(x: torch.Tensor,
                 group: Optional[NodeGroup] = None) -> torch.Tensor:
    """Tiled reduce-scatter over axis 1: ``[P_local, S, ...]`` ->
    ``[P_local, S/P, ...]``, node d keeping the contiguous block ``[d*S/P,
    (d+1)*S/P)`` of the int32-wrapping sum over all nodes."""
    group = group_of_rows(group, x.shape[0])
    s = x.shape[1]
    if s % group.nodes:
        raise ValueError(f"psum_scatter: {s} rows do not split over "
                         f"{group.nodes} nodes")
    blocks = psum(x, group=group).reshape(group.nodes, s // group.nodes,
                                          *x.shape[2:])
    return blocks[group.first:group.first + group.local]


def all_gather(blocks: torch.Tensor,
               group: Optional[NodeGroup] = None) -> torch.Tensor:
    """``[P_local, B, ...]`` contiguous blocks (node d holding rows
    ``[d*B, (d+1)*B)``) -> the full ``[P*B, ...]`` tensor."""
    if group is not None and group.distributed:
        blocks = _gather_rows(blocks, group)
    return blocks.reshape(-1, *blocks.shape[2:])


def all_gather_unstride(owned: torch.Tensor,
                        group: Optional[NodeGroup] = None) -> torch.Tensor:
    """``[P_local, S/P, W, 2]`` strided owned blocks (local row i of node d
    is global site ``i * P + d``) -> the full ``[S, W, 2]`` histogram."""
    if group is not None and group.distributed:
        owned = _gather_rows(owned, group)
    p, s_local = owned.shape[:2]
    return owned.transpose(0, 1).reshape(p * s_local, *owned.shape[2:])


def global_count(x: torch.Tensor, group: Optional[NodeGroup] = None) -> int:
    """``int(x.sum())`` over every process's ``x``: the count a loop over
    all nodes tests, the same on every process of a gang."""
    total = trace.host_read(x.sum(dtype=torch.int64), "global_count")
    if group is None or not group.distributed:
        return total
    t = torch.tensor([total], dtype=torch.int64)
    _gloo(lambda: dist.all_reduce(t), group, wire_bytes(t))
    return int(t[0])


def ring(nodes: int) -> list:
    """JAX's ring permutation over ``nodes`` nodes: ``(i, (i + 1) % n)``."""
    return [(i, (i + 1) % nodes) for i in range(nodes)]


def _check_perm(perm, nodes: int) -> None:
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: a node sends or receives twice in "
                         f"{list(perm)}")
    if not all(0 <= n < nodes for n in srcs + dsts):
        raise ValueError(f"ppermute: {list(perm)} names a node outside "
                         f"[0, {nodes})")


def ppermute(x: torch.Tensor, perm: Optional[Sequence[tuple]] = None,
             group: Optional[NodeGroup] = None) -> torch.Tensor:
    """``[P_local, ...]`` -> ``[P_local, ...]``: for each ``(src, dst)`` of
    ``perm`` (global node indices, JAX's ring ``(i, (i+1) % P)`` if None)
    node ``dst``'s row is node ``src``'s; a node no pair sends to gets
    zeros, as under ``lax.ppermute``. Every process must pass the same
    ``perm``. In a gang a pair within a process is a copy; a pair across
    processes is a gloo send and receive of the row, staged through the
    host, and the clock counts the bytes this process sends."""
    group = group_of_rows(group, x.shape[0])
    perm = ring(group.nodes) if perm is None else [tuple(p) for p in perm]
    _check_perm(perm, group.nodes)
    mine = range(group.first, group.first + group.local)
    out = torch.zeros_like(x)
    sends, recvs = [], []
    for src, dst in perm:
        if src in mine and dst in mine:
            out[dst - group.first] = x[src - group.first]
        elif src in mine:
            sends.append((src, dst))
        elif dst in mine:
            recvs.append((src, dst))
    if not (sends or recvs):
        return out
    host_out = [(dst, _to_host(x[src - group.first], group.clock))
                for src, dst in sends]
    host_in = [(src, dst, torch.empty(x.shape[1:], dtype=x.dtype,
                                      pin_memory=x.device.type == "cuda"))
               for src, dst in recvs]

    def exchange():
        # a message is tagged with its destination node; a node's rank is
        # node // local
        works = [dist.isend(t, dst=dst // group.local, tag=dst)
                 for dst, t in host_out]
        works += [dist.irecv(t, src=src // group.local, tag=dst)
                  for src, dst, t in host_in]
        for w in works:
            w.wait()

    _gloo(exchange, group, sum(wire_bytes(t) for _, t in host_out))
    for _, dst, t in host_in:
        out[dst - group.first] = _to_device(t, x.device, group.clock)
    return out


def broadcast(x: torch.Tensor, node: int,
              group: Optional[NodeGroup] = None) -> torch.Tensor:
    """The ``x`` of the process that holds node ``node``, on every
    process (each passes a tensor of the same shape and dtype). With one
    process, ``x`` itself."""
    if group is None or not group.distributed:
        return x
    if not 0 <= node < group.nodes:
        raise ValueError(f"broadcast: node {node} outside "
                         f"[0, {group.nodes})")
    host = _to_host(x, group.clock)
    src = node // group.local
    _gloo(lambda: dist.broadcast(host, src=src), group, wire_bytes(host))
    return _to_device(host, x.device, group.clock)
