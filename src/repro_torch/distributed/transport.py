"""The collectives XLA emits for the reference's pipeline, as
``torch.distributed`` calls: the port's transport across processes.

The executor (``core/pipeline.py``) talks to one object per mesh axis, each
hosting some ranks of its axis behind a list interface: in process,
``LocalRing`` (pipe) and ``models.common.LocalGroup`` (tp, data) host every
rank; here each process hosts one, its own:

* :class:`DistRing` (the pipe axis): ``shift(sent, step)`` sends the hosted
  rank's value to its ring successor ``(k + step) % K`` and returns what
  its predecessor sent, through ``dist.batch_isend_irecv`` (the
  reference's ``ppermute``).  A small header goes first, so a rank that
  has nothing to send (an idle tick) sends ``None``; ``all_reduce`` sums
  over the ring's ranks.
* :class:`DistGroup` (tp, data): ``all_reduce`` is ``dist.all_reduce``
  over the axis's subgroup; as a tensor-parallel group it is Megatron's
  ``g`` (sum forward, identity backward: every rank's cotangent of the
  replicated sum is the same), and ``region`` its ``f`` (identity forward,
  the cotangents summed over the axis backward).

:func:`mesh_groups` builds them from a ``torch.distributed.DeviceMesh`` laid
over a :class:`~repro_torch.launch.mesh.Mesh`, once the process group
exists (:func:`init_process_group`: gloo for CPU tensors, NCCL for CUDA
ones).  Axes of size 1 get no group (the executor hosts their one rank).
Its ``"world"`` entry is a :class:`DistGroup` over every process of the
run, which the stage-sharded state needs beside the axes: the clip norm's
sum (``all_reduce``), a checkpoint's ``gather`` of every process's blocks
on rank 0 (``dist.gather``: a sum would turn a stored ``-0.0`` into
``+0.0``) and its ``barrier``.
Every training schedule runs on a ring hosting one rank per process: the
explicit-backward ones by their backward units, the forward-only ones by
the transposed tick table (``core/pipeline.py``), whose sends and receives
all sit in the tick interpreter, none inside an autograd backward.

:class:`ThreadRing` is the in-process stand-in for one pipe rank per
process: K threads, each hosting one rank behind ``DistRing``'s interface
(``ranks == (k,)``, ``shift``, ``all_reduce``), so the path that crosses
processes runs in one process, on the CPU or on one card.  A
:class:`ThreadRank` is its own world (``gather``, ``barrier``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Mesh

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
_HEADER = 6            # has-value flag, dtype index, up to four dims (-1 past the last)


def init_process_group(address: str, rank: int, world_size: int,
                       backend: Optional[str] = None) -> str:
    """``dist.init_process_group`` at ``address`` (``tcp://host:port``);
    ``backend`` gloo or nccl (default: nccl when CUDA is available, else
    gloo).  Returns the backend."""
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=address, rank=rank, world_size=world_size)
    return backend


class _AllReduce(torch.autograd.Function):
    """Sum over the group forward; the cotangent passes unchanged."""

    @staticmethod
    def forward(ctx, x, pg):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Region(torch.autograd.Function):
    """Identity forward; the cotangent summed over the group backward."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.pg)
        return g, None


class DistGroup:
    """One process's rank of a mesh axis, or of the world: ``ranks ==
    (rank,)``, ``all_reduce([x]) -> [sum over the group]``, ``region(x) ->
    [x]``, ``gather(x, dst)`` (the group's values in rank order on its rank
    ``dst``, ``None`` elsewhere; every value of ``x``'s shape and dtype)
    and ``barrier()``.  ``device``: where its small tensors live (the CPU
    under gloo, the process's GPU under NCCL)."""

    def __init__(self, pg, size: int, rank: int, device: Optional[torch.device] = None):
        self.pg, self.size, self.rank = pg, size, rank
        self.ranks = (rank,)
        self.device = device
        self.members = dist.get_process_group_ranks(pg)

    def all_reduce(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        assert len(values) == 1, len(values)
        return [_AllReduce.apply(values[0], self.pg)]

    def region(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [_Region.apply(x, self.pg)]

    def gather(self, x: torch.Tensor, dst: int = 0) -> Optional[List[torch.Tensor]]:
        x = x.detach().contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)] if self.rank == dst else None
        dist.gather(x, out, dst=self.members[dst], group=self.pg)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.pg)

    def __repr__(self) -> str:
        return f"DistGroup(rank {self.rank} of {self.size})"


class DistRing(DistGroup):
    """One process's rank of the pipe axis: the ring ``shift`` and the
    group's ``all_reduce``.  ``members``: the global ranks of the axis's
    subgroup in ring order; ``device``: where headers and received values
    live (the CPU under gloo, the process's GPU under NCCL)."""

    def __init__(self, pg, size: int, rank: int, members: List[int], device: torch.device):
        super().__init__(pg, size, rank, device)
        self.members = list(members)

    def _batch(self, ops) -> None:
        """``(op, tensor, global peer)`` triples as one batch, waited on."""
        if ops:
            p2p = [dist.P2POp(op, t, peer, group=self.pg) for op, t, peer in ops]
            for req in dist.batch_isend_irecv(p2p):
                req.wait()

    def shift(self, sent: List[Optional[torch.Tensor]],
              step: int = 1) -> List[Optional[torch.Tensor]]:
        assert len(sent) == 1, len(sent)
        x = sent[0]
        dst = self.members[(self.rank + step) % self.size]
        src = self.members[(self.rank - step) % self.size]
        header = torch.zeros(_HEADER, dtype=torch.int64, device=self.device)
        if x is not None:
            assert x.dim() <= _HEADER - 2, x.shape
            header[0], header[1] = 1, _DTYPES.index(x.dtype)
            header[2:2 + x.dim()] = torch.tensor(x.shape)
            header[2 + x.dim():] = -1
        got = torch.empty_like(header)
        self._batch([(dist.isend, header, dst), (dist.irecv, got, src)])
        ops, recv = [], None
        if x is not None:
            ops.append((dist.isend, x.detach().contiguous(), dst))
        if int(got[0]):
            shape = [int(d) for d in got[2:] if d >= 0]
            recv = torch.empty(shape, dtype=_DTYPES[int(got[1])], device=self.device)
            ops.append((dist.irecv, recv, src))
        self._batch(ops)
        return [recv]

    def __repr__(self) -> str:
        return f"DistRing(rank {self.rank} of {self.size})"


def mesh_groups(mesh: Mesh, device: Optional[torch.device] = None) -> Dict[str, DistGroup]:
    """The process's group per mesh axis of size > 1 (``pipe`` a
    :class:`DistRing`, ``tp`` and ``data`` a :class:`DistGroup`), from a
    ``DeviceMesh`` over the world's ranks in the mesh's (row-major) order,
    and ``"world"``, a :class:`DistGroup` over the default process group.
    The world size must be ``mesh.size``."""
    from torch.distributed.device_mesh import DeviceMesh

    if "pod" in mesh.shape:
        raise ValueError("mesh_groups takes the axes pipe, tp and data (fold pod into data)")
    world = dist.get_world_size()
    assert world == mesh.size, (world, mesh)
    device = torch.device(device or ("cuda" if dist.get_backend() == "nccl" else "cpu"))
    dm = DeviceMesh(device.type, torch.arange(world).reshape(tuple(mesh.shape.values())),
                    mesh_dim_names=mesh.axis_names)
    out: Dict[str, DistGroup] = {}
    for axis, size in mesh.shape.items():
        if size == 1:
            continue
        pg = dm.get_group(axis)
        rank = dm.get_local_rank(axis)
        if axis == "pipe":
            out[axis] = DistRing(pg, size, rank, dist.get_process_group_ranks(pg), device)
        else:
            out[axis] = DistGroup(pg, size, rank, device)
    out["world"] = DistGroup(dist.group.WORLD, world, dist.get_rank(), device)
    return out


class _Gate:
    """A barrier of ``n`` threads (``threading.Barrier``'s ``wait`` and
    ``abort``) whose released waiters return even when it breaks right
    after: a rank that failed after the ring's last collective does not
    turn the others' completed wait into an error."""

    def __init__(self, n: int):
        self.n, self.count, self.gen, self.broken = n, 0, 0, False
        self.cond = threading.Condition()

    def wait(self, timeout: float) -> None:
        with self.cond:
            if self.broken:
                raise threading.BrokenBarrierError
            gen = self.gen
            self.count += 1
            if self.count == self.n:
                self.count, self.gen = 0, gen + 1
                self.cond.notify_all()
                return
            if not self.cond.wait_for(lambda: self.gen != gen or self.broken, timeout):
                self.broken = True
                self.cond.notify_all()
            if self.gen == gen:
                raise threading.BrokenBarrierError

    def abort(self) -> None:
        with self.cond:
            self.broken = True
            self.cond.notify_all()


class RingBroken(RuntimeError):
    """Raised in a :class:`ThreadRing` rank that waited on a rank which
    failed or never sent: the ring's first error is the cause."""


class ThreadRing:
    """The pipe axis's K ranks in one process, each hosted by a thread of
    its own: the stand-in for one rank per process (the counterpart of
    ``core/pipeline.py::LocalRing`` for that path).  ``run(fn)`` calls
    ``fn(rank)`` on K threads, ``rank`` a :class:`ThreadRank` with
    ``DistRing``'s interface, joins them and returns their results in rank
    order; the first exception of any thread is raised there.

    ``shift`` hands values through per-rank queues, each a copy (as a
    process boundary makes one), tagged with the sender's count of shifts
    in that direction: a receiver whose count differs raises, and one that
    waits longer than ``timeout`` seconds raises ``TimeoutError``; either
    error breaks the ring, so the other ranks raise :class:`RingBroken`
    rather than wait.  ``all_reduce`` sums the ranks' values in rank order
    (a bit-reproducible sum) and hands every rank the one result, which no
    rank may write into; ``gather`` hands rank ``dst`` every rank's value
    (a copy), ``barrier`` waits for every rank.

    On a card the threads share the current device and its default stream,
    so a value a thread enqueued is ready, in stream order, for the thread
    that reads it.  It hosts the pipe axis only: a tensor-parallel
    all-reduce inside a CUDA backward would wait on the device thread that
    PyTorch runs every thread's backward on."""

    def __init__(self, size: int, timeout: float = 120.0):
        self.size, self.timeout = size, timeout
        self._boxes = {(k, step): queue.Queue() for k in range(size) for step in (1, -1)}
        self._barrier = _Gate(size)
        self._slots: List[Any] = [None] * size
        self._broken = threading.Event()

    def rank(self, k: int) -> "ThreadRank":
        return ThreadRank(self, k)

    def _fail(self) -> None:
        self._broken.set()
        self._barrier.abort()

    def run(self, fn: Callable[["ThreadRank"], Any]) -> List[Any]:
        results: List[Any] = [None] * self.size
        errors: List[Optional[BaseException]] = [None] * self.size
        device = torch.cuda.current_device() if torch.cuda.is_available() else None

        def body(k: int) -> None:
            try:
                if device is not None:
                    torch.cuda.set_device(device)
                results[k] = fn(self.rank(k))
            except BaseException as e:  # noqa: BLE001 -- re-raised by run
                errors[k] = e
                self._fail()

        threads = [threading.Thread(target=body, args=(k,), name=f"pipe-rank-{k}")
                   for k in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = [e for e in errors if e is not None and not isinstance(e, RingBroken)]
        first = first or [e for e in errors if e is not None]
        if first:
            raise first[0]
        return results

    def __repr__(self) -> str:
        return f"ThreadRing({self.size})"


class ThreadRank:
    """One thread's rank of a :class:`ThreadRing`: ``ranks == (rank,)``;
    the ring is the run's whole world."""

    device = None

    def __init__(self, ring: ThreadRing, rank: int):
        self.ring, self.size, self.rank = ring, ring.size, rank
        self.ranks = (rank,)
        self._count = {1: 0, -1: 0}

    def _wait(self, what: str) -> None:
        try:
            self.ring._barrier.wait(self.ring.timeout)
        except threading.BrokenBarrierError:
            self.ring._fail()
            raise RingBroken(f"rank {self.rank}: {what} broken (a rank failed or timed "
                             f"out)") from None

    def barrier(self) -> None:
        self._wait("barrier")

    def gather(self, x: torch.Tensor, dst: int = 0) -> Optional[List[torch.Tensor]]:
        ring = self.ring
        ring._slots[self.rank] = x.detach().clone()
        self._wait("gather")                          # every rank's value is in
        out = list(ring._slots) if self.rank == dst else None
        self._wait("gather")                          # rank dst has taken them
        return out

    def shift(self, sent: List[Optional[torch.Tensor]], step: int = 1) -> List[Optional[torch.Tensor]]:
        assert len(sent) == 1 and step in (1, -1), (len(sent), step)
        ring, x = self.ring, sent[0]
        n = self._count[step]
        self._count[step] = n + 1
        if x is not None:
            x = x.detach().clone()
        ring._boxes[(self.rank + step) % self.size, step].put((n, x))
        box, src = ring._boxes[self.rank, step], (self.rank - step) % self.size
        deadline = time.monotonic() + ring.timeout
        while True:
            if ring._broken.is_set():
                raise RingBroken(f"rank {self.rank}: the ring broke while it waited for rank "
                                 f"{src} (shift {n}, step {step})")
            try:
                got_n, got = box.get(timeout=0.05)
                break
            except queue.Empty:
                if time.monotonic() > deadline:
                    ring._fail()
                    raise TimeoutError(
                        f"rank {self.rank}: no value from rank {src} within {ring.timeout} s "
                        f"(shift {n}, step {step}): a rank skipped a tick or failed") from None
        if got_n != n:
            ring._fail()
            raise RuntimeError(f"rank {self.rank}: shift {n} (step {step}) received rank {src}'s "
                               f"shift {got_n}: the ranks ran different tick tables")
        return [got]

    def all_reduce(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        assert len(values) == 1, len(values)
        ring = self.ring
        ring._slots[self.rank] = values[0]
        self._wait("all_reduce")                      # every rank's value is in
        if self.rank == 0:
            total = ring._slots[0]
            for v in ring._slots[1:]:
                total = total + v
            ring._slots[0] = total
        self._wait("all_reduce")                      # the sum is in slot 0
        total = ring._slots[0]
        self._wait("all_reduce")                      # every rank has read it
        return [total]

    def __repr__(self) -> str:
        return f"ThreadRank(rank {self.rank} of {self.size})"
