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
The forward-only schedules differentiate the whole tick loop with autograd,
which does not cross processes, so a ring hosting one rank serves the
explicit-backward schedules.
"""
from __future__ import annotations

from typing import Dict, List, Optional

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
    """One process's rank of a mesh axis: ``ranks == (rank,)``,
    ``all_reduce([x]) -> [sum over the axis]``, ``region(x) -> [x]``."""

    def __init__(self, pg, size: int, rank: int):
        self.pg, self.size, self.rank = pg, size, rank
        self.ranks = (rank,)

    def all_reduce(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        assert len(values) == 1, len(values)
        return [_AllReduce.apply(values[0], self.pg)]

    def region(self, x: torch.Tensor) -> List[torch.Tensor]:
        return [_Region.apply(x, self.pg)]

    def __repr__(self) -> str:
        return f"DistGroup(rank {self.rank} of {self.size})"


class DistRing(DistGroup):
    """One process's rank of the pipe axis: the ring ``shift`` and the
    group's ``all_reduce``.  ``members``: the global ranks of the axis's
    subgroup in ring order; ``device``: where headers and received values
    live (the CPU under gloo, the process's GPU under NCCL)."""

    def __init__(self, pg, size: int, rank: int, members: List[int], device: torch.device):
        super().__init__(pg, size, rank)
        self.members, self.device = list(members), device

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
    ``DeviceMesh`` over the world's ranks in the mesh's (row-major) order.
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
            out[axis] = DistGroup(pg, size, rank)
    return out
