"""The dry run's instruments over one traced step (``launch/dryrun.py``).

The reference lowers and compiles a step and reads XLA's memory and cost
analyses and the HLO's collectives.  The port runs its own step once on
``meta`` tensors, which allocates nothing, under these instruments:

* :class:`Account`, a ``TorchDispatchMode``: every new output storage is
  counted once, when an op that does not alias its inputs makes it, and
  freed when its last tensor dies (``weakref.finalize`` on the storage
  object, which lives exactly as long as the storage: ``untyped_storage()``
  hands back the one object of a storage, checked at start).  Sizes are
  rounded up to the CUDA caching allocator's 512-byte blocks.  What
  existed before the step (parameters, optimizer state, the batch) is
  registered as ``state`` (:meth:`Account.register_state`), at the bytes
  of the tensors given: the account is the step's bytes above it, less
  what the step frees of it (a trainer that rebinds its moments).  Each
  new storage gets a category: ``params``, ``opt_state``, ``grads`` and
  ``caches`` (tagged by the caller), ``saved`` (packed by ``saved_tensors_hooks``: what
  autograd keeps for the backward) or ``transient``.  The same mode
  counts FLOPs with ``torch.utils.flop_counter``'s registry (the formulas
  ``FlopCounterMode`` uses, without its decompositions, so the ops are the
  eager program's) plus the kernels' meta routes
  (``kernels/ops.py::META``), and bytes accessed: each op that does not
  alias reads its tensor inputs once and writes its outputs once, as one
  eager launch does.
* Pipe ranks in one process: everything is attributed to the rank whose
  unit runs (``_Plan.running``, set by the tick loop); in the autograd pass
  after a forward-only schedule's loop, to the rank whose saved tensor was
  last unpacked.  What no unit runs (the prologue, the head) is shared by
  every rank.  The state categories count at each device's share of their
  leaf (its placement).  :meth:`Account.peaks` replays the log of
  allocations and frees for each rank.
* :class:`RecordingGroup` and :class:`RecordingRing`: one rank of a mesh
  axis hosted alone, as one process of a process group would be, that
  records each collective's payload.  A group's ``all_reduce`` returns its
  one value (the trace needs shapes, not sums), its ``region`` all-reduces
  the gradient in the backward (Megatron's ``f``); the ring's ``shift``
  is :class:`~repro_torch.core.pipeline.LocalRing`'s, its sends counted per
  sending rank as collective-permutes.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.pipeline import LocalRing
from repro_torch.kernels import ops as kops
from repro_torch.launch.hlo_analysis import COLLECTIVE_MULT
from repro_torch.tree import tree_leaves

#: the CUDA caching allocator's block granularity (kMinBlockSize)
BLOCK = 512
CATEGORIES = ("params", "opt_state", "grads", "caches", "saved", "transient")
STATE = ("params", "opt_state", "grads", "caches")

_SHAPE_OPS = {torch.ops.aten.size.default, torch.ops.aten.stride.default,
              torch.ops.aten.numel.default, torch.ops.aten.dim.default,
              torch.ops.aten.is_contiguous.default,
              torch.ops.aten.storage_offset.default, torch.ops.prim.device.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class _Held:
    """What autograd keeps for one saved tensor, and the rank that saved it."""
    __slots__ = ("t", "rank")

    def __init__(self, t: torch.Tensor, rank):
        self.t, self.rank = t, rank


class Collectives:
    """Wire bytes per collective kind and sending rank (``None``: every
    rank), ring-weighted by :data:`COLLECTIVE_MULT`."""

    def __init__(self):
        self.bytes: Dict[str, Dict[Any, float]] = {k: defaultdict(float) for k in COLLECTIVE_MULT}

    def add(self, kind: str, nbytes: float, rank=None) -> None:
        self.bytes[kind][rank] += nbytes * COLLECTIVE_MULT[kind]

    def per_device(self, ranks) -> Dict[str, float]:
        """The largest rank's bytes of each kind (shared bytes on every rank)
        and their ``total``."""
        out = {}
        for kind, by in self.bytes.items():
            shared = by.get(None, 0.0)
            out[kind] = shared + max((by.get(r, 0.0) for r in ranks), default=0.0)
        out["total"] = sum(out.values())
        return out


class _Region(torch.autograd.Function):
    """Identity forward; the backward's gradient is the axis's all-reduce."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.group.record(g)
        return g, None


class RecordingGroup:
    """One rank (``ranks == (0,)``) of a mesh axis of ``size`` ranks, hosted
    alone: ``all_reduce([x]) -> [x]`` and ``region(x) -> [x]`` as
    ``distributed.transport.DistGroup`` does across processes, each payload
    recorded as an all-reduce in ``log`` (nothing on an axis of one rank)."""

    def __init__(self, size: int, log: Collectives, rank_fn: Callable = lambda: None):
        self.size, self.ranks, self.log, self.rank_fn = size, (0,), log, rank_fn
        self.calls = 0
        #: optional per-call weights: the share of call i's payload one
        #: device sends (a whole-model gradient leaf of which it holds a part)
        self.weights: Optional[List[float]] = None

    def record(self, x: torch.Tensor) -> None:
        if self.size > 1:
            w = self.weights[self.calls] if self.weights is not None else 1.0
            self.calls += 1
            self.log.add("all-reduce", _nbytes(x) * w, self.rank_fn())

    def all_reduce(self, values: list) -> list:
        assert len(values) == 1, len(values)
        self.record(values[0])
        return [values[0]]

    def region(self, x: torch.Tensor) -> list:
        return [_Region.apply(x, self) if self.size > 1 else x]

    def __repr__(self) -> str:
        return f"RecordingGroup(rank 0 of {self.size})"


class RecordingRing(LocalRing):
    """:class:`LocalRing` of ``n_ranks`` ranks whose every shift's sent
    values are recorded as collective-permutes of the sending rank.  A
    value sent under autograd (a forward-only schedule) has a cotangent
    of its size sent back by its receiver in the backward: recorded in
    ``derived`` (counted from the forward's sends, not traced)."""

    def __init__(self, n_ranks: int, log: Collectives, on_tick: Callable = lambda: None):
        super().__init__(n_ranks)
        self.log, self.on_tick = log, on_tick
        self.derived = Collectives()

    def shift(self, sent, step: int = 1):
        self.on_tick()
        for k, x in enumerate(sent):
            if x is None:
                continue
            self.log.add("collective-permute", _nbytes(x), k)
            if x.requires_grad and torch.is_grad_enabled():
                self.derived.add("collective-permute", _nbytes(x), (k + step) % self.n_ranks)
        return super().shift(sent, step)


class Account(TorchDispatchMode):
    """The live-bytes account, FLOPs and bytes of one traced step (see the
    module docstring).  ``plan``: a pipelined step's ``_Plan``, whose
    ``running`` rank the account reads; ``block``: allocation
    granularity."""

    def __init__(self, plan=None, block: int = BLOCK):
        super().__init__()
        self.plan, self.block = plan, block
        self.base = 0.0                              # the registered state's bytes
        self.live: Dict[int, int] = {}               # id(storage) -> serial
        self.size: List[int] = []
        self.owner: List[Any] = []
        self.cat: Dict[int, str] = {}
        self.share: Dict[int, float] = {}
        self.events: List[tuple] = []                # (serial, +1 | -1)
        self.flops: Dict[Any, float] = defaultdict(float)
        self.bytes: Dict[Any, float] = defaultdict(float)
        self.largest_off_meta = 0                    # the largest storage made off meta
        self.bwd_rank = None
        self.open = False
        self._kernel_seen = (0, 0)
        self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    # -------------------------------------------------------------- ranks
    def rank(self):
        if self.plan is not None and self.plan.running is not None:
            return self.plan.running
        return self.bwd_rank

    def new_tick(self) -> None:
        """Between ticks no unit runs and no backward is under way."""
        self.bwd_rank = None

    # ---------------------------------------------------------- the mode
    def __enter__(self):
        probe = torch.empty(1, device="meta")
        if probe.untyped_storage() is not probe.untyped_storage():
            raise RuntimeError("untyped_storage() returns a new object per call in this torch "
                               "build: the account cannot follow a storage's life")
        self.open = True
        self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        self._kernel_delta()
        super().__exit__(*exc)
        self._hooks.__exit__(*exc)
        self.open = False

    def _kernel_delta(self) -> None:
        seen = (sum(e["flops"] for e in kops.META.values()),
                sum(e["bytes"] for e in kops.META.values()))
        if seen != self._kernel_seen:
            rank = self.rank()
            self.flops[rank] += seen[0] - self._kernel_seen[0]
            self.bytes[rank] += seen[1] - self._kernel_seen[1]
            self._kernel_seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._kernel_delta()
        out = func(*args, **kwargs)
        if func in _SHAPE_OPS:
            return out
        rank = self.rank()
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[rank] += flop_registry[packet](*args, **kwargs, out_val=out)
        returns = func._schema.returns
        outs = out if len(returns) > 1 else (out,)
        view = False
        for ret, o in zip(returns, outs):
            if ret.alias_info is not None:          # a view, or written in place
                view = view or not ret.alias_info.is_write
                continue
            for t in _tensors(o):
                self._alloc(t, rank)
        if not view:
            self.bytes[rank] += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                                 + sum(_nbytes(t) for t in _tensors(out)))
        return out

    def _alloc(self, t: torch.Tensor, rank, nbytes: Optional[int] = None) -> Optional[int]:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return None
        nbytes = st.nbytes() if nbytes is None else nbytes
        if t.device.type != "meta":
            self.largest_off_meta = max(self.largest_off_meta, nbytes)
        serial = len(self.size)
        self.size.append(-(-nbytes // self.block) * self.block)
        self.owner.append(rank)
        self.live[key] = serial
        self.events.append((serial, 1))
        weakref.finalize(st, self._free, key, serial)
        return serial

    def register_state(self, tree, shares: Optional[Callable] = None) -> None:
        """Register the leaves of ``tree``, which exist before the step, as
        ``state`` at their own bytes (a view: the view's), each at the
        device's share ``shares(i)`` of leaf i.  Call before entering."""
        for i, t in enumerate(tree_leaves(tree)):
            if not isinstance(t, torch.Tensor):
                continue
            serial = self._alloc(t, None, _nbytes(t))
            if serial is not None:
                self.cat[serial] = "state"
                if shares is not None:
                    self.share[serial] = shares(i)
                self.base += self._weight(serial)

    def _free(self, key: int, serial: int) -> None:
        if self.live.get(key) == serial:
            del self.live[key]
        if self.open:
            self.events.append((serial, -1))

    # ----------------------------------------------- saved tensors, tags
    def _pack(self, t: torch.Tensor):
        serial = self.live.get(id(t.untyped_storage()))
        if serial is not None:
            self.cat.setdefault(serial, "saved")
        return _Held(t.detach(), self.rank())       # no reference to its grad_fn: no cycle

    def _unpack(self, held: _Held) -> torch.Tensor:
        if self.plan is None or self.plan.running is None:
            self.bwd_rank = held.rank
        return held.t

    def tag(self, tree, category: str, shares: Optional[Callable] = None) -> None:
        """Tag the storages of ``tree``'s leaves with ``category`` (state
        categories override ``saved``); ``shares(i)``: the share of leaf i
        that one device holds (its placement), 1 by default."""
        assert category in CATEGORIES, category
        for i, t in enumerate(tree_leaves(tree)):
            if not isinstance(t, torch.Tensor):
                continue
            serial = self.live.get(id(t.untyped_storage()))
            if serial is None or self.cat.get(serial) == "state":
                continue
            if category in STATE or serial not in self.cat:
                self.cat[serial] = category
            if shares is not None:
                self.share[serial] = shares(i)

    # ------------------------------------------------------------ results
    def _weight(self, serial: int) -> float:
        return self.size[serial] * self.share.get(serial, 1.0)

    def _owner(self, serial: int, whole: bool = False):
        # the state categories count at each device's share on every device
        if whole or self.cat.get(serial) in STATE + ("state",):
            return None
        return self.owner[serial]

    def peaks(self, ranks=(None,), whole: bool = False) -> Dict[Any, tuple]:
        """Per rank, ``(peak bytes above the state, event index)``: its own
        storages and the shared ones.  ``whole``: every storage on one
        device (the process's own peak); pass ``ranks`` ``(None,)``."""
        if whole:
            ranks = (None,)
        own = defaultdict(float)
        best = {r: (0.0, -1) for r in ranks}
        for idx, (serial, sign) in enumerate(self.events):
            owner = self._owner(serial, whole)
            own[owner] += sign * self._weight(serial)
            targets = ranks if owner is None else ((owner,) if owner in best else ())
            for r in targets:
                cur = own[None] + (own[r] if r is not None else 0.0) - self.base
                if cur > best[r][0]:
                    best[r] = (cur, idx)
        return best

    def breakdown(self, rank, index: int, whole: bool = False) -> Dict[str, float]:
        """Bytes by category of what ``rank`` holds just after event
        ``index`` (its peak's)."""
        alive = set()
        for serial, sign in self.events[:index + 1]:
            if sign > 0:
                alive.add(serial)
            else:
                alive.discard(serial)
        out = {c: 0.0 for c in CATEGORIES + ("state",)}
        for serial in alive:
            owner = self._owner(serial, whole)
            if owner is None or owner == rank:
                out[self.cat.get(serial, "transient")] += self._weight(serial)
        out["state"] -= self.base                   # what the step freed of the state: <= 0
        return out

    def per_device(self, ranks=(None,), whole: bool = False) -> Dict[str, float]:
        """FLOPs and bytes accessed of the largest rank (shared work on
        every rank); ``whole``: of everything."""
        def top(d):
            if whole:
                return sum(d.values())
            return d.get(None, 0.0) + max((d.get(r, 0.0) for r in ranks if r is not None),
                                          default=0.0)
        return {"flops": top(self.flops), "bytes_accessed": top(self.bytes)}
