"""Logical-axis sharding rules -> per-leaf placements (reference:
``repro/distributed/sharding.py``).

Every parameter leaf carries a tuple of logical axis names
(``Model.specs()``).  A rule table maps logical axes to mesh axes;
:func:`param_shardings` builds the placement tree of a parameter tree.

Default layout (the reference's GSPMD layout):
  * tensor parallelism over the ``model`` axis: heads / kv_heads / ff /
    experts / vocab;
  * ZeRO-3/FSDP over the ``data`` (+``pod``) axes: the largest remaining
    unsharded dim of big leaves (parameters and optimizer moments).

The reference's ``PartitionSpec`` and ``NamedSharding`` have plain
counterparts here: :class:`PartitionSpec` is a tuple with one entry per
dimension (``None``, a mesh axis name, or a tuple of names, a one-name
tuple being the name itself, as JAX normalises it) and
:class:`NamedSharding` is ``(mesh, spec)``.  What ``shard_map``'s
``in_specs`` do in the reference, cut one rank's block of a full tensor,
is :func:`local_shard` (and :func:`local_shard_tree`), which the pipeline's
tensor-parallel stages and the tests use on the full parameters.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh

# logical axis -> mesh axis (None = replicate)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "embed": None,
}


def _entry(e):
    """One ``PartitionSpec`` entry in JAX's normal form."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """``PartitionSpec(*entries)``: per dimension ``None`` (replicated), a
    mesh axis name, or a tuple of names (sharded over their product, the
    first axis major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A leaf's placement: its ``spec`` on ``mesh``."""
    mesh: Mesh
    spec: PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def _size(mesh: Mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in _axes(entry))


def _is_spec(s) -> bool:
    return isinstance(s, tuple)


def map_specs(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (dicts down to logical-axis
    tuples, which are its leaves) and trees of its structure."""
    if _is_spec(specs):
        return fn(specs, *trees)
    return {k: map_specs(fn, v, *(t[k] for t in trees)) for k, v in specs.items()}


def spec_to_pspec(spec: Tuple, rules: Dict[str, Optional[str]], mesh: Mesh,
                  shape: Optional[Tuple[int, ...]] = None,
                  fsdp_axes: Optional[Tuple[str, ...]] = None,
                  fsdp_min_size: int = 2 ** 20) -> PartitionSpec:
    """Map one leaf's logical spec to a :class:`PartitionSpec`.

    Divisibility-checked: a logical axis is only sharded if the mesh axis
    size divides the dim (else replicated, e.g. kv_heads=4 on model=16).
    If ``fsdp_axes`` is set, the largest still-unsharded divisible dim of a
    leaf of at least ``fsdp_min_size`` elements is also sharded over them
    (ZeRO-3).
    """
    entries = [rules.get(ax) if ax is not None else None for ax in spec]
    if shape is not None:
        for i, (mesh_ax, dim) in enumerate(zip(entries, shape)):
            if mesh_ax is not None and dim % _size(mesh, mesh_ax) != 0:
                entries[i] = None
    if fsdp_axes and shape is not None and math.prod(shape) >= fsdp_min_size:
        fsdp_size = math.prod(mesh.shape[a] for a in fsdp_axes)
        # biggest unsharded, divisible dim (the last of equal ones)
        cands = [(dim, i) for i, (dim, e) in enumerate(zip(shape, entries))
                 if e is None and dim % fsdp_size == 0]
        if cands:
            _, i = max(cands)
            entries[i] = tuple(fsdp_axes)
    return PartitionSpec(*entries)


def param_shardings(specs: Any, params_or_shapes: Any, mesh: Mesh, *,
                    rules: Optional[Dict] = None,
                    fsdp_axes: Optional[Sequence[str]] = None) -> Any:
    """The :class:`NamedSharding` tree matching ``specs`` (logical-axis
    tuples) over a tree of tensors (meta tensors do) of the same layout."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    fsdp = tuple(fsdp_axes) if fsdp_axes else None
    return map_specs(lambda spec, leaf: NamedSharding(
        mesh, spec_to_pspec(spec, rules, mesh, tuple(leaf.shape), fsdp)), specs, params_or_shapes)


def batch_shardings(batch_specs: Any, mesh: Mesh,
                    data_axes: Sequence[str] = ("data",)) -> Any:
    """Shard every batch leaf's leading (batch) dim over the data axes
    (replicated when they do not divide it, e.g. global_batch=1
    long-context cells).  ``batch_specs``: a dict of tensors (meta tensors
    do, as ``configs.input_specs`` gives them)."""
    axes = tuple(data_axes)
    total = math.prod(mesh.shape[a] for a in axes)

    def one(leaf):
        if leaf.shape[0] % total != 0:
            return NamedSharding(mesh, PartitionSpec())
        return NamedSharding(mesh, PartitionSpec(axes, *([None] * (leaf.dim() - 1))))

    return {k: one(v) for k, v in batch_specs.items()}


def local_shard(t: torch.Tensor, spec: Sequence, mesh: Mesh,
                coord: Mapping[str, int]) -> torch.Tensor:
    """The block of the full tensor ``t`` that the rank at ``coord`` (mesh
    axis -> index) holds under ``spec``: per sharded dim, the slice of
    ``dim / size`` elements at the rank's index over the entry's axes (the
    first axis major), as ``shard_map``'s ``in_specs`` hand it out.  A view;
    a spec with no sharded dim gives ``t`` itself.  Every axis of ``spec``
    needs a coordinate; ``spec`` may be shorter than ``t.dim()`` (the
    trailing dims are whole)."""
    for dim, entry in enumerate(spec):
        axes = _axes(_entry(entry))
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + coord[a]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} is not divisible by {axes} ({n})")
        blk = t.shape[dim] // n
        t = t.narrow(dim, idx * blk, blk)
    return t


def local_shard_tree(tree: Any, pspecs: Any, mesh: Mesh, coord: Mapping[str, int]) -> Any:
    """:func:`local_shard` over a tree of tensors and the matching tree of
    :class:`PartitionSpec` (or logical-axis tuples already mapped)."""
    return map_specs(lambda spec, t: local_shard(t, spec, mesh, coord), pspecs, tree)


# ------------------------------------------------ one process's blocks
class Block:
    """Where one rank's part of a leaf lies in the whole leaf: ``rows``, the
    ranges ``(lo, hi)`` of dim 0 it holds, in order and concatenated
    (``None``: the whole dim), and ``cuts``, per later dim ``(start,
    stop)`` or ``None`` (whole).  A whole leaf is ``Block()``."""

    __slots__ = ("rows", "cuts")

    def __init__(self, rows: Optional[Sequence[Tuple[int, int]]] = None,
                 cuts: Sequence[Optional[Tuple[int, int]]] = ()):
        self.rows = None if rows is None else tuple((int(lo), int(hi)) for lo, hi in rows)
        self.cuts = tuple(None if c is None else (int(c[0]), int(c[1])) for c in cuts)

    @property
    def whole(self) -> bool:
        return self.rows is None and not any(self.cuts)

    def shape(self, full: Sequence[int]) -> Tuple[int, ...]:
        """The block's shape within a leaf of shape ``full``."""
        out = list(full)
        if self.rows is not None:
            out[0] = sum(hi - lo for lo, hi in self.rows)
        for d, c in enumerate(self.cuts, start=1):
            if c is not None:
                out[d] = c[1] - c[0]
        return tuple(out)

    def _index(self, lo: int, hi: int) -> tuple:
        return (slice(lo, hi),) + tuple(slice(None) if c is None else slice(*c)
                                        for c in self.cuts)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """The block of the whole leaf ``full``, in storage of its own (a
        view would keep the whole leaf alive); a whole block is ``full``."""
        if self.whole:
            return full
        rows = self.rows if self.rows is not None else ((0, full.shape[0]),)
        parts = [full[self._index(lo, hi)] for lo, hi in rows] or [full[self._index(0, 0)]]
        return parts[0].clone() if len(parts) == 1 else torch.cat(parts)

    def place(self, full: torch.Tensor, block: torch.Tensor) -> None:
        """Write ``block`` into its place in ``full``."""
        rows = self.rows if self.rows is not None else ((0, full.shape[0]),)
        off = 0
        for lo, hi in rows:
            full[self._index(lo, hi)] = block[off:off + hi - lo]
            off += hi - lo

    def astuple(self) -> tuple:
        """``(rows, cuts)``, plain data: ``Block(*b.astuple())`` is ``b``."""
        return self.rows, self.cuts

    def __repr__(self) -> str:
        return f"Block(rows={self.rows}, cuts={self.cuts})"


class LeafShards:
    """How the ranks of a world (``world_size`` processes) hold one leaf of
    shape ``shape``: ``blocks[w]`` is world rank ``w``'s :class:`Block`
    (``blocks`` ``None``: every rank holds the leaf whole), ``rank`` this
    process's world rank, and ``owned`` whether this process owns its block
    for a sum over the world: rank 0 of the axes the block is replicated
    on, so that every element is counted once.  Not a tuple: the tree
    functions take it as a leaf."""

    __slots__ = ("shape", "blocks", "rank", "owned")

    def __init__(self, shape=None, blocks: Optional[Sequence[Block]] = None, rank: int = 0,
                 owned: bool = True):
        self.shape = None if shape is None else tuple(int(d) for d in shape)
        self.blocks = None if blocks is None else tuple(blocks)
        self.rank, self.owned = rank, owned

    @property
    def whole(self) -> bool:
        """Every rank holds the whole leaf."""
        return self.blocks is None or all(b.whole for b in self.blocks)

    @property
    def mine(self) -> Block:
        return Block() if self.blocks is None else self.blocks[self.rank]

    def __repr__(self) -> str:
        return (f"LeafShards(shape={self.shape}, rank {self.rank}, owned={self.owned}, "
                f"{'whole' if self.whole else f'{len(self.blocks)} blocks'})")


#: a leaf every rank holds whole, rank 0 owning it (a step count)
REPLICATED = LeafShards()
