"""TeraPipe: token-level pipeline parallelism on K virtual ranks in one
process, under every registered training schedule (reference:
``repro/core/pipeline.py``).

The paper's execution model (§3.2), as the reference runs it:

* the main layer stack is cut into K·V chunks; rank k holds chunks
  ``v = 0..V-1``, global stages ``s = v·K + k``
  (``StageAssignment.layer_rows``);
* a minibatch is cut into D microbatches × M token slices; work item
  ``i = d·M + m`` enters stage 0 at its tick and flows down the ranks, one
  ring shift per tick;
* each (rank, chunk) keeps a cache per layer of the prefix of the
  current microbatch it has already processed, so slice m attends at
  context offset ``ctx = l_0 + … + l_{m-1}`` (the paper's t_fwd(l, ctx)):
  a KV cache, or for the state families (mamba2, the hybrid's rec blocks)
  the recurrent state the slice carries on, reset with every microbatch.
  Such families need uniform slices, as in the reference.

Which unit runs where and when comes from the schedule IR
(``core/schedules``): a Python tick loop reads each hosted rank's
``(work_item, chunk, kind)`` from ``assign.tick_table(D·M)`` and runs it.
Values move between ranks through a transport with one ``shift`` method:
:class:`LocalRing` hosts all K ranks in process,
``distributed.transport.DistRing`` one per process.  The comm plan
(``assign.comm_plan()``) adds destination-side skew buffers, ``hold + 1``
deep, pushed every tick and read ``hold`` ticks later: ``fwd_hold`` on the
forward wrap edge (rank K-1 → 0), ``rev_hold`` on the reverse wrap edge
(rank 0 → K-1), and ``rev_lag`` on every reverse edge.

Two kinds of schedule, as in the reference:

* **forward-only** (``contiguous``, ``interleaved``): the backward pass is
  autograd over the whole tick loop, as ``jax.value_and_grad`` of the
  reference's scan is.  Caches are written out of place under grad
  (``models/attention.py::_write_rows``), so each slice's K/V cotangent
  flows back through every later slice's attention.
* **explicit backward** (``1f1b``, ``interleaved-1f1b``, ``zb-h1``): forward
  units run without autograd and save their inputs; a backward unit
  recomputes its stage forward under grad from them and calls
  ``torch.autograd.grad`` (the reference's per-unit ``jax.vjp``).  The last
  global stage adds the per-slice LM loss.  The stage-granular recompute is
  the remat, so the blocks run without checkpoint inside it.  Under
  ``zb-h1`` the B unit takes the gradient of the unit's inputs only and
  keeps its graph for the W unit one tick later on the same rank, which
  takes the parameters' gradient against the same cotangents.

What differs from the reference, and why the result does not:

* **A mesh of sizes, ranks hosted by groups.** The signatures take
  ``(model, tcfg, seq_len, global_batch, mesh)`` in place of ``(model,
  specs, mesh, ...)``: ``mesh`` a :class:`~repro_torch.launch.mesh.Mesh`
  with a ``pipe`` axis and optional ``tp`` and ``data`` axes (an int K is
  ``Mesh(pipe=K)``), ``groups`` the process's transport per axis (default:
  every rank in process, :class:`LocalRing` and ``LocalGroup``).  The
  mesh axes' names are fixed (``pipe``, ``tp``, ``data``), so
  ``TeraPipeConfig`` has no axis fields.
* **Data parallelism** (``data`` axis): data rank r takes the rows
  ``[r·B/data, (r+1)·B/data)``, cut into its D microbatches; each data
  rank's loss and gradients are computed on a graph of their own (one data
  rank's activations alive at a time), the loss scaled by its share of the
  global batch, and the data group's ``all_reduce`` sums them (the
  reference's ``psum`` over the data axes).  Every schedule takes it.
* **Tensor parallelism inside a stage** (``tp`` axis, Megatron): the stage
  leaves are placed by :func:`_leaf_pspec` (``heads``, ``ff``, ``experts``
  on ``tp``; ``kv_heads`` only if the axis divides them), each hosted tp
  rank gets its block of every layer (``distributed.sharding.local_shard``)
  and the stage runs the TP-local model, whose blocks take the hosted
  ranks' list of shards and all_reduce their partials.  The forward-only
  schedules take it; the explicit-backward ones raise, as the reference's
  do.  A rank whose KV heads are replicated keeps the heads its q heads
  read (``attention.tp_rank_attn``), where the reference pairs them
  wrongly (ROADMAP Queue 3).
* **Eager shapes.** The reference pads every slice to ``l_max``, pads the
  cache to ``L + l``, pads the sequence and sends idle ticks' outputs to a
  dump row, all to keep a traced ``lax.scan`` shape-stable.  Here each
  slice runs at its own length at its own ``ctx`` (a host int), an idle
  tick does nothing, and the cache is ``L`` long.  A backward unit takes
  the cache rows ``[0, ctx + l)`` it reads, so its calls are shaped by
  ``(stage, l, ctx)`` alone.  The loss and the gradients on every valid
  token are the same.
* **Uneven stages.** When K·V does not divide the layer count the
  reference pads the stack with zero (identity) blocks; here a chunk runs
  the real layers among its ``layer_rows`` and skips the pad rows, which is
  exact.  Parameters stay in layer order: a chunk takes its rows by
  slicing, so no ``interleave_stacked`` is needed.
* **Per-microbatch caches.** A forward unit writes its cache rows in place
  (no autograd), and its saved residual refers to that cache, which no
  later unit of the microbatch changes below ``ctx + l``.  Each microbatch
  gets new cache tensors at its first slice, since under 1F1B the next
  microbatch starts on a rank before this one's backward ends there.
* **Groups around the pipeline.** Pre-groups (DeepSeek's ``dense0``) run
  on the whole sequence before it, post-groups (RecurrentGemma's ``tail``)
  after it on the reassembled sequence, before the head; the explicit-
  backward schedules take the loss at the last stage, so they refuse
  post-groups, and, as the reference's, every family but dense and moe.
* **Stage-sharded state across processes.** On a ring that hosts one rank
  per process (``DistRing``, ``ThreadRing``) a process holds only the
  blocks of the ranks it hosts (:meth:`_Plan.shard_layout`,
  :func:`shard_params`): of the main group's stacked leaves the layer rows
  of its chunks and, under a tp group that hosts one rank, that rank's
  block by :func:`_leaf_pspec`; everything else (embedding, head, final
  norm, pre- and post-groups) whole.  Its gradients come back in the same
  shapes, and only the replicated leaves' are summed over the ring.  With
  ``V = 1`` and K dividing the stack this is the reference's
  ``param_shardings_fn`` placement; with ``V > 1`` a rank holds the rows it
  computes (the reference holds a contiguous block at rest and re-shards
  it every step), and where K·V does not divide the stack the rows are
  uneven (the reference replicates the layer axis).  A process that hosts
  every rank of an axis holds that axis whole.
* **The vlm family** runs as the dense one on a sequence of patches +
  text: the prologue's embedding puts the patch rows first, so the first
  slices may hold only patches, and the loss after the pipeline is taken
  over the text rows (``Model.head_loss``).  The enc-dec family raises: its
  encoder is bidirectional and cannot be cut into token slices.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (Block, LeafShards, NamedSharding, PartitionSpec,
                                              local_shard_tree, map_specs)
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.models import Model, build_model
from repro_torch.models.attention import tp_local_kv_heads, tp_rank_attn
from repro_torch.models.common import LocalGroup, ModelConfig, rms_norm, shards
from repro_torch.models.lm import BlockGroup, _remat, _scan_full, _unstack, _xent_chunk
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten

from .schedules import (KIND_BWD, KIND_BWD_INPUT, KIND_BWD_WEIGHT, KIND_FWD, get_schedule,
                        schedule_names)

#: registered schedule names (core/schedules registry): the CLI choices
SCHEDULES = schedule_names()

# logical axes of the stage leaves that tensor parallelism shards
_TP_LOGICAL = ("heads", "ff", "experts")
# a block's sub-trees that lie inside a tensor-parallel region (its norms
# run on the replicated activation, outside)
_TP_REGIONS = ("attn", "ffn", "moe")


@dataclasses.dataclass
class TeraPipeConfig:
    """The reference's ``TeraPipeConfig`` (``pipeline.py:128-170``) without
    the mesh-axis fields, ``skip_bubbles`` and ``unroll``: an eager idle
    tick does nothing, and the tick loop is Python either way."""
    n_token_slices: int = 4          # M (uniform mode; ignored if slice_lens)
    # non-uniform DP scheme (the paper's Alg. 1 output): slice lengths
    # summing to seq_len, each run at its own length
    slice_lens: Optional[Tuple[int, ...]] = None
    n_microbatches: int = 1          # D
    cache_dtype: Any = torch.bfloat16
    # V: virtual stages (layer chunks) per rank; V > 1 needs D·M divisible
    # by K (work items advance in ring groups of K)
    virtual_stages: int = 1
    # which schedule table drives the tick loop (core/schedules registry);
    # "contiguous" with virtual_stages > 1 is promoted to "interleaved", as
    # in the reference
    schedule: str = "contiguous"
    # debug: all-idle ticks appended to the tick loop; they must leave the
    # caches bit-identical (tests assert it)
    extra_ticks: int = 0


class LocalRing:
    """Ring transport of K virtual ranks in one process, which hosts them
    all (``ranks``): ``shift`` takes one value per hosted rank and hands
    each the value its ring predecessor sent (the reference's ``ppermute``
    over ``(j, (j + step) % K)``): ``step`` 1 is the forward ring, -1 the
    reverse (cotangent) ring."""

    def __init__(self, n_ranks: int):
        self.n_ranks = self.size = n_ranks
        self.ranks = tuple(range(n_ranks))

    def shift(self, sent: List[Any], step: int = 1) -> List[Any]:
        assert len(sent) == self.n_ranks, (len(sent), self.n_ranks)
        return [sent[(k - step) % self.n_ranks] for k in range(self.n_ranks)]


def _hosts_all(group) -> bool:
    return len(group.ranks) == group.size


def _leaf_pspec(spec: Tuple, tp_axis: Optional[str], tp_size: int, pipe_axis: str,
                cfg: ModelConfig) -> PartitionSpec:
    """The placement of one stacked main-group leaf (reference
    ``_leaf_pspec``, ``pipeline.py:192-207``): ``spec[0]`` is the layer
    axis (-> pipe); ``heads``/``ff``/``experts`` -> tp; ``kv_heads`` -> tp
    only if the axis divides ``cfg.n_kv_heads``; everything else
    replicated."""
    out = [pipe_axis]
    for ax in spec[1:]:
        if tp_axis and tp_size > 1 and ax in _TP_LOGICAL:
            out.append(tp_axis)
        elif (tp_axis and tp_size > 1 and ax == "kv_heads"
              and cfg.n_kv_heads % tp_size == 0):
            out.append(tp_axis)
        else:
            out.append(None)
    return PartitionSpec(*out)


class _Saved(NamedTuple):
    """A forward unit's inputs, kept for its backward: the activation, the
    microbatch's (k, v) caches of the chunk (referred to, not copied) and
    the context offset."""
    x: torch.Tensor
    caches: list
    ctx: int


class _ResidualStore:
    """Saved values of units whose retiring backward has not run, per rank
    keyed ``(chunk, item % spread)``, the reference's ``(V, R)`` ring
    buffer.  Writing a slot that is still live raises (the IR audit makes
    the keys collision-free).  ``peak`` is the most entries one rank held
    at once, summed over its chunks: ``assign.peak_live_items(D·M)``."""

    def __init__(self, n_ranks: int, spread: int):
        self.spread = spread
        self.slots: Dict[Tuple[int, int, int], Tuple[int, Any]] = {}
        self.live = [0] * n_ranks
        self.peak = 0

    def put(self, k: int, v: int, i: int, value) -> None:
        key = (k, v, i % self.spread)
        assert key not in self.slots, (
            f"residual slot {key} written by item {i} while item "
            f"{self.slots.get(key, (None,))[0]} holds it")
        self.slots[key] = (i, value)
        self.live[k] += 1
        self.peak = max(self.peak, self.live[k])

    def get(self, k: int, v: int, i: int):
        item, value = self.slots[(k, v, i % self.spread)]
        assert item == i, (k, v, i, item)
        return value

    def pop(self, k: int, v: int, i: int):
        value = self.get(k, v, i)
        del self.slots[(k, v, i % self.spread)]
        self.live[k] -= 1
        return value


def _group_split(model: Model) -> Tuple[List[BlockGroup], BlockGroup, List[BlockGroup]]:
    """``(pre_groups, main_group, post_groups)`` (reference ``_group_split``,
    ``:173-189``): only the main (homogeneous) group is pipelined; the
    small pre-groups (DeepSeek's dense first layer) run before it on the
    whole sequence, the post-groups (RecurrentGemma's rec tail) after it.
    The enc-dec family is not token-sliceable and raises."""
    gs = model.groups
    family = model.cfg.family
    if family == "encdec":
        raise NotImplementedError(
            "enc-dec archs: the bidirectional encoder is not token-sliceable (paper "
            "footnote 1); pipeline the decoder via the generic path or use GSPMD mode")
    if len(gs) == 1:
        return [], gs[0], []
    if family == "moe":                # [dense0?, moe]
        return list(gs[:-1]), gs[-1], []
    if family == "hybrid":             # [super, tail?]
        return [], gs[0], list(gs[1:])
    raise NotImplementedError(family)


class _Plan:
    """Everything the executor derives from (model, tcfg, shapes, mesh):
    slice geometry, the schedule assignment and comm plan, each chunk's
    layer rows, the stage-local (TP-local) block function and placements,
    and the process's transport per mesh axis."""

    def __init__(self, model: Model, tcfg: TeraPipeConfig, seq_len: int,
                 global_batch: int, mesh, groups: Optional[Dict[str, Any]] = None):
        self.mesh = mesh = mesh if isinstance(mesh, Mesh) else Mesh(pipe=int(mesh))
        unknown = set(mesh.shape) - {"pipe", "tp", "data", "pod"}
        assert not unknown, f"mesh axes {sorted(unknown)}: the executor runs pipe, tp, data, pod"
        self.model, self.tcfg = model, tcfg
        self.K = K = mesh.get("pipe")
        self.tp = tp = mesh.get("tp")
        self.data_axes = data_axes(mesh)
        self.data = data = math.prod(mesh.shape[a] for a in self.data_axes)
        groups = dict(groups or {})
        self.ring = groups.get("pipe") or LocalRing(K)
        self.tp_group = groups.get("tp") or LocalGroup(tp)
        self.data_group = groups.get("data") or LocalGroup(data)
        assert (self.ring.size, self.tp_group.size, self.data_group.size) == (K, tp, data), (
            "groups do not match the mesh", mesh)
        self.D = D = tcfg.n_microbatches
        self.L, self.B = L, B = seq_len, global_batch

        self.V = V = tcfg.virtual_stages
        self.sched = "interleaved" if tcfg.schedule == "contiguous" and V > 1 else tcfg.schedule
        self.pre, self.main, self.post = _group_split(model)
        self.n_main = self.main.count
        # the registry validates the (schedule, V) combination and builds
        # the IR value the tick loop interprets
        self.assign = get_schedule(self.sched, n_ranks=K, n_layers=self.n_main,
                                   virtual_stages=V, n_microbatches=D)
        self.comm = self.assign.comm_plan()
        assert not (self.comm.rev_hold and self.comm.rev_lag), self.comm

        if tcfg.slice_lens is not None:
            slice_lens = tuple(int(s) for s in tcfg.slice_lens)
            assert sum(slice_lens) == L and min(slice_lens) >= 1, (slice_lens, L)
            if len(set(slice_lens)) > 1 and model.cfg.family not in ("dense", "vlm", "moe"):
                raise ValueError("non-uniform slices need prefix-overwrite semantics (KV "
                                 "caches); state-based families require uniform slices")
        else:
            M = tcfg.n_token_slices
            assert L % M == 0, (L, M)
            slice_lens = (L // M,) * M
        self.slice_lens, self.M = slice_lens, len(slice_lens)
        self.starts = [sum(slice_lens[:m]) for m in range(self.M)]
        assert B % (data * D) == 0, (B, data, D)
        self.b_local = B // data                     # one data rank's rows
        self.mb = self.b_local // D
        self.DM = D * self.M
        self.tab = self.assign.tick_table(self.DM)   # validates D·M against K, V

        # per (rank, chunk): the real layers [lo, hi) of its global stage
        self.rows = {}
        for k in range(K):
            for v in range(V):
                lo, hi = self.assign.layer_rows(self.assign.stage_of(k, v))
                self.rows[k, v] = (min(lo, self.n_main), min(hi, self.n_main))
        self.last = (K - 1, V - 1)                   # the last global stage

        # one rank per process: the process holds the rows of its chunks
        # (and, under a tp group hosting one rank, that rank's block), in
        # chunk order; ``local_rows`` are each hosted chunk's rows there
        self.sharded = not _hosts_all(self.ring)
        self.tp_sharded = self.sharded and tp > 1 and not _hosts_all(self.tp_group)
        self.local_rows = self.rows
        self.world = None
        if self.sharded:
            self.local_rows, off = {}, 0
            for v in range(V):
                for k in self.ring.ranks:
                    lo, hi = self.rows[k, v]
                    self.local_rows[k, v] = (off, off + hi - lo)
                    off += hi - lo
            self._set_world(groups)

        # the model's own config decides the attention route (use_kernel);
        # the stages run the TP-local model (reference :269-281), whose
        # state groups (mamba2, the rec block) refuse tp when built
        self.cfg = cfg = model.cfg
        if tp > 1:
            assert cfg.n_heads % tp == 0, (cfg.n_heads, tp)
            self.cfg_local = cfg.replace(
                tp_axis=self.tp_group, head_dim=cfg.hd,    # pin: hd derives from n_heads
                n_heads=cfg.n_heads // tp,
                n_kv_heads=tp_local_kv_heads(cfg.n_heads, cfg.n_kv_heads, tp))
            local = build_model(self.cfg_local, model.device)
            self.main_local = next(g for g in local.groups if g.name == self.main.name)
            # one layer's placements: the stage leaves' without the layer axis
            self.layer_specs = map_specs(
                lambda s: PartitionSpec(*_leaf_pspec(s, "tp", tp, "pipe", cfg)[1:]),
                model.specs()["groups"][self.main.name])
        else:
            self.cfg_local, self.main_local = cfg, self.main
        self.block_fn = self.main_local.sliced_dyn
        self.running: Optional[int] = None           # the rank whose unit runs (_run_ticks)
        # per main-group leaf path: whether _leaf_pspec cuts it over tp
        self.tp_cut = dict(tree_items(map_specs(
            lambda s: "tp" in _leaf_pspec(s, "tp", tp, "pipe", cfg)[1:],
            model.specs()["groups"][self.main.name])))

    def _set_world(self, groups: Dict[str, Any]) -> None:
        """The world: every process of the run (``groups["world"]``, or the
        ring where it is the only axis hosted one rank per process), laid
        out row-major over the axes that host one rank per process, in the
        mesh's order (``transport.mesh_groups``' layout)."""
        by_axis = {"pipe": self.ring, "tp": self.tp_group}
        if self.data_axes:
            by_axis[self.data_axes[0]] = self.data_group
        self.world_axes = [(a, by_axis[a]) for a in self.mesh.axis_names
                           if a in by_axis and not _hosts_all(by_axis[a])]
        names = [a for a, _ in self.world_axes]
        world = groups.get("world")
        if world is None:
            if names != ["pipe"]:
                raise ValueError(f"the axes {names} host one rank per process: pass the group "
                                 f"over every process as groups['world']")
            world = self.ring
        sizes = [g.size for _, g in self.world_axes]
        self.world_coords = [dict(zip(names, c)) for c in
                             itertools.product(*(range(n) for n in sizes))]
        mine = {a: g.ranks[0] for a, g in self.world_axes}
        if world.size != len(self.world_coords) or self.world_coords[world.rank] != mine:
            raise ValueError(f"the world {world} is not the row-major layout of the groups' "
                             f"axes {dict(zip(names, sizes))} at this process's ranks {mine}")
        self.world = world

    def local_batch(self, batch, r: int):
        """Data rank ``r``'s rows of every leaf of ``batch``."""
        if self.data == 1:
            return batch
        return {key: a[r * self.b_local:(r + 1) * self.b_local] for key, a in batch.items()}

    def param_shardings_fn(self) -> Callable:
        """``param_shardings(specs) ->`` the :class:`NamedSharding` tree of
        the parameters (reference ``:360-395``): the main group's leaves on
        ``pipe`` (+ ``tp``), its layer axis replicated when K does not
        divide the unpadded stack; everything else replicated."""
        mesh, cfg, tp, K = self.mesh, self.cfg, self.tp, self.K
        main_name = self.main.name

        def build(spec, in_main):
            if not in_main:
                return NamedSharding(mesh, PartitionSpec())
            ps = _leaf_pspec(spec, "tp", tp, "pipe", cfg)
            if self.n_main % K:
                ps = PartitionSpec(None, *ps[1:])
            return NamedSharding(mesh, ps)

        def param_shardings(specs):
            out = {}
            for key, sub in specs.items():
                if key == "groups":
                    out["groups"] = {g: map_specs(lambda s, m=(g == main_name): build(s, m), gs)
                                     for g, gs in sub.items()}
                else:
                    out[key] = map_specs(lambda s: build(s, False), sub)
            return out

        return param_shardings

    def shard_layout(self, params) -> Any:
        """On a ring that hosts one rank per process: per leaf of the whole
        tree ``params`` (meta tensors will do), how the world's processes
        hold it, a :class:`~repro_torch.distributed.sharding.LeafShards`
        in the parameters' structure.  The main group's stacked leaves:
        every process the rows of its pipe rank's chunks, in chunk order,
        cut over tp as :func:`_leaf_pspec` places them where the process
        hosts one tp rank, owned by data rank 0 (and tp rank 0 where tp
        does not cut them); every other leaf whole, owned by world rank 0.
        ``None`` where the ring hosts every rank (one process holds it all)."""
        if not self.sharded:
            return None
        cfg, tp, me = self.cfg, self.tp, self.world.rank
        coord = self.world_coords[me]

        def block(ps, shape, c) -> Block:
            rows = [self.rows[c["pipe"], v] for v in range(self.V)]
            cuts = []
            for d in range(1, len(shape)):
                if self.tp_sharded and ps[d] == "tp":
                    assert shape[d] % tp == 0, (shape, tp)
                    n = shape[d] // tp
                    cuts.append((c["tp"] * n, (c["tp"] + 1) * n))
                else:
                    cuts.append(None)
            return Block([r for r in rows if r[1] > r[0]], cuts)

        def main_leaf(spec, a):
            ps = _leaf_pspec(spec, "tp", tp, "pipe", cfg)
            cut_on = {"pipe"} | ({"tp"} if self.tp_sharded and "tp" in ps[1:] else set())
            owned = all(i == 0 for ax, i in coord.items() if ax not in cut_on)
            return LeafShards(a.shape, [block(ps, a.shape, c) for c in self.world_coords], me,
                              owned)

        whole = lambda spec, a: LeafShards(a.shape, None, me, me == 0)
        out = {}
        for key, sub in self.model.specs().items():
            if key == "groups":
                out[key] = {g: map_specs(main_leaf if g == self.main.name else whole, gs,
                                         params[key][g]) for g, gs in sub.items()}
            else:
                out[key] = map_specs(whole, sub, params[key])
        return tree_map(lambda a, ls: ls, params, out)      # the parameters' order

    def prefix(self, params, batch) -> torch.Tensor:
        """The prologue before the pipeline (reference ``:307-319``): the
        embedding, then the pre-groups on the whole sequence (each layer
        under checkpoint when ``cfg.remat``), in the activation dtype.  The
        vlm family's embedding puts the batch's patch rows first."""
        x = self.model.embed(params, batch, 0)
        for g in self.pre:
            x = _scan_full(g, params["groups"][g.name], x, self.cfg.remat)
        return x.to(self.cfg.dtype)

    def rows_of(self, a: torch.Tensor, d: int, m: int) -> torch.Tensor:
        """Microbatch ``d``'s rows of slice ``m`` of a (B, L, ...) tensor."""
        ctx = self.starts[m]
        return a[d * self.mb:(d + 1) * self.mb, ctx:ctx + self.slice_lens[m]]

    def chunk_layers(self, main_params, leaf=lambda a: a) -> Dict[Tuple[int, int], list]:
        """Per hosted (rank, chunk), the per-layer parameter dicts of its
        rows (``local_rows`` of the process's stack), each leaf ``leaf`` of
        its row's view; under tensor parallelism each layer is the list of
        the hosted tp ranks' blocks of it (``local_shard``, unless the
        process holds its one tp rank's block already).  One unbind per
        stacked leaf: under autograd the backward pass stacks each leaf's
        gradient once rather than scattering each chunk's into a zero
        tensor of the whole stack."""
        layers = [tree_map(leaf, layer) for layer in _unstack(main_params)]
        if self.tp > 1:
            layers = [[self._tp_rank_layer(layer, r) for r in self.tp_group.ranks]
                      for layer in layers]
        return {kv: layers[lo:hi] for kv, (lo, hi) in self.local_rows.items()}

    def _tp_rank_layer(self, layer, r: int):
        """Tp rank ``r``'s block of one layer's parameters; its attention
        keeps the KV heads its q heads read where they are replicated."""
        block = (dict(layer) if self.tp_sharded else
                 local_shard_tree(layer, self.layer_specs, self.mesh, {"tp": r}))
        if "attn" in block:
            block["attn"] = tp_rank_attn(block["attn"], self.cfg, self.tp, r)
        return block

    def fresh_caches(self, n_layers: int) -> list:
        """New zero caches of ``n_layers`` layers of the main group for one
        microbatch, one cache tree per layer (under tensor parallelism the
        list of the hosted tp ranks', at TP-local heads), each the only row
        of the (TP-local) group's own ``init_cache``: KV caches in
        ``tcfg.cache_dtype``, recurrent states in float32.  Each layer gets
        storage of its own: the out-of-place write of a row of a shared
        stack (``torch.slice_scatter`` of a view) allocates the whole
        stack."""
        def one():
            return tree_map(lambda a: a[0], self.main_local.init_cache(
                self.mb, self.L, self.tcfg.cache_dtype, layers=1))
        if self.tp > 1:
            return [[one() for _ in self.tp_group.ranks] for _ in range(n_layers)]
        return [one() for _ in range(n_layers)]

    def stage_apply(self, layers, x, caches, ctx: int, remat: bool = False):
        """One chunk's forward of one slice at offset ``ctx``: its blocks in
        order, each under non-reentrant checkpoint when ``remat`` and
        autograd is recording (the reference's per-block
        ``jax.checkpoint``, with no remat policy)."""
        block = self.block_fn
        if remat and torch.is_grad_enabled():
            block = _remat(self.block_fn)
        new = []
        for bp, c in zip(layers, caches):
            x, c = block(bp, x, c, ctx)
            new.append(c)
        return x, new


def _run_ticks(p: _Plan, run_fwd: Callable, run_bwd: Optional[Callable] = None) -> None:
    """The tick interpreter over the ranks the ring hosts (all K in
    process, one under a process group).  Per tick, every value the rings
    delivered lands in its rank's skew buffer (idle ticks included); then
    each hosted rank runs its unit: ``run_fwd(k, v, i, x_in)`` returns the
    activation for the forward ring (``x_in`` is None where rank 0 admits
    the item from the embedding), ``run_bwd(k, v, i, kind, g)`` the
    cotangent for the reverse ring or None (``g`` is None at the last
    global stage, which seeds from its own loss).  A buffer is read
    ``hold`` (or ``rev_lag``) ticks after the push, on the tick the
    schedule consumes the value."""
    K, tab, comm = p.K, p.tab, p.comm
    hosted = p.ring.ranks
    n = len(hosted)
    hx, hg = comm.fwd_hold + 1, max(comm.rev_hold, comm.rev_lag) + 1
    xbuf = [[None] * hx for _ in range(n)]
    gbuf = [[None] * hg for _ in range(n)]
    x_recv: List[Any] = [None] * n
    g_recv: List[Any] = [None] * n
    for t in range(tab.shape[0] + p.tcfg.extra_ticks):
        for j in range(n):
            xbuf[j][t % hx] = x_recv[j]
            gbuf[j][t % hg] = g_recv[j]
        x_sent: List[Any] = [None] * n
        g_sent: List[Any] = [None] * n
        for j, k in enumerate(hosted):
            if t >= tab.shape[0] or tab[t, k, 0] < 0:
                continue                              # idle: nothing runs
            i, v, kind = (int(a) for a in tab[t, k])
            p.running = k                             # the dry run's live-bytes account reads it
            if kind == KIND_FWD:
                x_in = None
                if (k, v) != (0, 0):                  # rank 0 chunk 0 admits new work
                    hold = comm.fwd_hold if k == 0 else 0
                    x_in = xbuf[j][(t - hold) % hx]
                    assert x_in is not None, (t, k, v, i)
                x_sent[j] = run_fwd(k, v, i, x_in)
                continue
            g = None
            if (k, v) != p.last and kind != KIND_BWD_WEIGHT:
                lag = comm.rev_lag or (comm.rev_hold if k == K - 1 else 0)
                g = gbuf[j][(t - lag) % hg]
                assert g is not None, (t, k, v, i, kind)
            g_sent[j] = run_bwd(k, v, i, kind, g)
        p.running = None
        x_recv = p.ring.shift(x_sent)
        if comm.rev_ring:
            g_recv = p.ring.shift(g_sent, step=-1)


def _run_forward(p: _Plan, params, x_emb: torch.Tensor):
    """Forward-only schedules: the tick loop under the caller's autograd
    mode.  Returns the last global stage's output of every work item (in
    item order) and each (rank, chunk)'s final caches."""
    chunks = p.chunk_layers(params["groups"][p.main.name])
    caches: Dict[Tuple[int, int], list] = {}
    outs: List[Optional[torch.Tensor]] = [None] * p.DM

    def run_fwd(k, v, i, x_in):
        d, m = divmod(i, p.M)
        if x_in is None:
            x_in = p.rows_of(x_emb, d, m)
        if m == 0:                                    # new microbatch: fresh prefix
            caches[k, v] = p.fresh_caches(len(chunks[k, v]))
        x_out, caches[k, v] = p.stage_apply(chunks[k, v], x_in, caches[k, v],
                                            p.starts[m], remat=p.cfg.remat)
        if (k, v) == p.last:
            outs[i] = x_out
        return x_out

    _run_ticks(p, run_fwd)
    return outs, caches


def _make_loss_from_plan(p: _Plan) -> Callable:
    """Differentiable loss over the tick loop of one data rank's rows:
    reassemble the last stage's per-item outputs into ``(B/data, L, d)``,
    run the post-groups on it (each layer under checkpoint when
    ``cfg.remat``), then the head and the chunked loss (vlm: over the text
    rows, so ``labels`` are ``L - n_patches`` long), as the reference's
    ``_make_loss_from_plan`` does; with a data axis, scaled by the rank's
    share of the global batch, so that the ranks' losses sum to the mean
    over it."""
    if p.assign.has_backward:
        raise ValueError(f"schedule {p.sched!r} computes the loss and its gradients in one "
                         f"pass; build it with make_terapipe_value_and_grad")

    def loss_fn(params, batch) -> torch.Tensor:
        outs, _ = _run_forward(p, params, p.prefix(params, batch))
        x_final = torch.cat([torch.cat(outs[d * p.M:(d + 1) * p.M], dim=1)
                             for d in range(p.D)], dim=0)
        for g in p.post:
            x_final = _scan_full(g, params["groups"][g.name], x_final, p.cfg.remat)
        loss = p.model.head_loss(params, x_final, batch["labels"])
        return loss * (p.b_local / p.B) if p.data > 1 else loss

    return loss_fn


def _requiring_grad(a):
    """A leaf of its own that requires grad (floating tensors only)."""
    return a.detach().requires_grad_() if a.is_floating_point() else a


class _UnitGrads:
    """One call's leaves and gradient sums for a tick loop that takes each
    unit's gradients with a ``torch.autograd.grad`` of its own: the
    explicit-backward schedules, and the forward-only ones on a ring that
    hosts one rank per process.

    * ``layers[k, v]``: the chunk's per-layer parameters (under tensor
      parallelism the hosted tp ranks' blocks) as leaves of their own, so a
      unit's gradients are its layers'; ``param_cots`` sums them in f32;
    * ``final_ln``, ``w_head`` and the post-groups' parameters as leaves:
      the head's and the post-groups' gradients, ``head_cots``;
    * the prologue (embedding, pre-groups) run once under grad on leaves of
      its own, ``x_det`` its output without a graph, ``d_emb`` the
      cotangent the units at rank 0 chunk 0 write into it, by rows;
    * ``loss`` the sum of the loss terms this process computed.

    ``finish`` sums the replicated leaves' gradients over the ring when it
    hosts one rank per process (each rank contributes its units' shares and
    zeros; the main group's rows are the process's own), maps the layers'
    sums back onto the stacked leaves (one autograd pass over the views
    that cut them), runs the prologue's one autograd pass and returns
    ``(loss, grads)`` in the parameters' structure, shapes and dtypes."""

    def __init__(self, p: _Plan, params, batch):
        self.p, self.params = p, params
        self.tied = tied = p.cfg.tie_embeddings
        main = params["groups"][p.main.name]
        if p.sharded:
            rows = sum(hi - lo for lo, hi in p.local_rows.values())
            got = next(iter(tree_leaves(main))).shape[0]
            if got != rows:
                raise ValueError(f"the main group has {got} layer rows, this process's shard "
                                 f"{rows}: on a ring that hosts one rank per process pass "
                                 f"shard_params(params, vg.plan.shard_layout(params))")
        with torch.enable_grad():
            # the stacked leaves and their per-chunk views (tp: the rank's
            # blocks), through which ``finish`` maps the sums back
            self.main = tree_map(_requiring_grad, main)
            self.views = p.chunk_layers(self.main)
        self.layers = {kv: tree_map(_requiring_grad, c) for kv, c in self.views.items()}
        self.final_ln = params["final_ln"].detach().requires_grad_()
        self.w_head = (params["embed"] if tied else params["lm_head"]).detach().requires_grad_()
        self.post = {g.name: tree_map(_requiring_grad, params["groups"][g.name]) for g in p.post}
        # the prologue's parameters as leaves of their own: the embedding
        # and every pre-group
        self.pro = tree_map(_requiring_grad, {
            "embed": params["embed"], "groups": {g.name: params["groups"][g.name] for g in p.pre}})
        with torch.enable_grad():
            self.x_emb = p.prefix({**params, **self.pro}, batch)
        self.x_det = self.x_emb.detach()

        f32 = lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device)
        hosted = [kv for kv in self.layers if kv[0] in p.ring.ranks]
        self.d_layers = {kv: tree_map(f32, self.layers[kv]) for kv in hosted}
        self.d_head = [f32(self.final_ln), f32(self.w_head)]
        self.d_post = tree_map(f32, self.post)
        self.d_emb = torch.zeros_like(self.x_det)
        self.loss = torch.zeros((), dtype=torch.float32, device=self.x_det.device)

    def head_params(self) -> dict:
        """The head's leaves under the keys ``Model.head_loss`` reads."""
        return {"final_ln": self.final_ln, ("embed" if self.tied else "lm_head"): self.w_head}

    def param_cots(self, k: int, v: int, grads) -> None:
        """Chunk ``(k, v)``'s layers' gradients (then, at the last global
        stage of an explicit schedule, the head's) summed in f32."""
        accs = list(tree_leaves(self.d_layers[k, v]))
        for acc, g in zip(accs, grads[:len(accs)]):
            if g is not None:
                acc += g.float()
        self.head_cots(grads[len(accs):])

    def head_cots(self, grads) -> None:
        """``final_ln``'s and ``w_head``'s gradients, summed in f32."""
        for acc, g in zip(self.d_head, grads):
            acc += g.float()

    def finish(self):
        p = self.p
        d_main = self.main_grads()
        if p.sharded:                                # the other ranks' shares
            reduce = lambda a: p.ring.all_reduce([a])[0]
            self.loss, self.d_emb = reduce(self.loss), reduce(self.d_emb)
            self.d_head = [reduce(a) for a in self.d_head]
            for acc in tree_leaves(self.d_post):
                acc.copy_(reduce(acc))

        d_pro = tree_unflatten(self.pro, torch.autograd.grad(
            self.x_emb, list(tree_leaves(self.pro)), self.d_emb))
        named = {"embed": d_pro["embed"].float(), "final_ln": self.d_head[0]}
        if self.tied:
            named["embed"] = named["embed"] + self.d_head[1]
        else:
            named["lm_head"] = self.d_head[1]
        named["groups"] = {**d_pro["groups"], **self.d_post, p.main.name: d_main}
        grads = {key: tree_map(lambda a, g: g.to(a.dtype), self.params[key], named[key])
                 for key in self.params}
        return self.loss, grads

    def main_grads(self):
        """The hosted chunks' sums as gradients of the stacked main-group
        leaves the process holds, in f32: per leaf, one autograd pass over
        the views (unbind, the tp blocks' slices) that cut the chunks'
        blocks from it, whose sums are freed once it is built (one leaf's
        size above the sums at a time).  In process every rank's rows are
        there; on a ring hosting one rank, the process's rows alone."""
        leaves = list(tree_leaves(self.main))
        views = [[] for _ in leaves]
        sums = [[] for _ in leaves]
        for kv, acc in self.d_layers.items():
            for layer, layer_acc in zip(self.views[kv], acc):
                for block, block_acc in zip(shards(layer), shards(layer_acc)):
                    for j, (a, g) in enumerate(zip(tree_leaves(block), tree_leaves(block_acc))):
                        views[j].append(a)
                        sums[j].append(g)
        self.d_layers = None
        out = []
        for j, a in enumerate(leaves):
            g = torch.autograd.grad(views[j], a, sums[j])[0].float() if views[j] else \
                torch.zeros(a.shape, dtype=torch.float32, device=a.device)
            views[j] = sums[j] = None
            out.append(g)
        return tree_unflatten(self.main, out)


def _make_explicit_value_and_grad(p: _Plan) -> Callable:
    """``(params, batch) -> (loss, grads)`` of an explicit-backward schedule
    (reference ``_make_explicit_value_and_grad`` and the bwd branches of
    ``_make_pipeline_body``, ``:602-713``): one tick loop computes the loss
    and every gradient; the embedding's and the pre-groups' come from one
    autograd pass over the prologue at the end (:class:`_UnitGrads`).  One
    data rank's rows; under a ring that hosts one rank per process, each
    process runs its rank's units and the loss and gradients are summed
    over the ring's ranks at the end."""
    if p.tp > 1:
        raise ValueError(f"schedule {p.sched!r} does not support tensor parallelism inside a "
                         f"stage (the per-slice head loss and the explicit gradient sums need "
                         f"tp-aware reductions), as the reference's does not")
    if p.post:
        raise ValueError("explicit-backward schedules need the head and loss at the last "
                         "stage; post-pipeline groups are not token-local")
    if p.cfg.family not in ("dense", "moe"):
        raise ValueError(f"schedule={p.sched!r} supports dense/moe families (per-slice LM "
                         f"loss at the last stage); got {p.cfg.family}")
    tied = p.cfg.tie_embeddings
    spread = p.assign.residual_spread(p.DM)
    inv_total = 1.0 / float(p.B * p.L)

    def value_and_grad_fn(params, batch):
        u = _UnitGrads(p, params, batch)
        labels = batch["labels"]
        caches: Dict[Tuple[int, int], list] = {}
        gcache: Dict[Tuple[int, int], list] = {}     # cache cotangent of the later slices
        store = _ResidualStore(p.K, spread)
        held = _ResidualStore(p.K, spread)            # zb-h1: B's graph, replayed by W

        def run_fwd(k, v, i, x_in):
            d, m = divmod(i, p.M)
            if x_in is None:
                x_in = p.rows_of(u.x_det, d, m)
            if m == 0:
                caches[k, v] = p.fresh_caches(len(u.layers[k, v]))
            with torch.no_grad():
                x_out, _ = p.stage_apply(u.layers[k, v], x_in, caches[k, v], p.starts[m])
            store.put(k, v, i, _Saved(x_in, caches[k, v], p.starts[m]))
            return x_out

        def unit_graph(k, v, i, saved, g):
            """The unit's forward again, under grad, from its saved inputs:
            ``(outputs, cotangents, input leaves, param leaves)``.  The
            cache leaves are rows [0, ctx + l), the rows the unit reads; at
            the first slice they are zeros and no input.  The last stage's
            outputs are its slice's loss (seed 1) and no activation."""
            d, m = divmod(i, p.M)
            ctx, l = saved.ctx, saved.x.shape[1]
            x_in = saved.x.detach().requires_grad_()
            c_in = [tuple(c[:, :ctx + l].detach().requires_grad_(m > 0) for c in kv)
                    for kv in saved.caches]
            with torch.enable_grad():
                x_out, c_out = p.stage_apply(u.layers[k, v], x_in, c_in, ctx)
                if (k, v) == p.last:             # rms_norm, head, f32 cross-entropy
                    w_head = u.w_head.T if tied else u.w_head
                    ls = _xent_chunk(rms_norm(x_out, u.final_ln), w_head,
                                     p.rows_of(labels, d, m)) * inv_total
                    outs, cots = [ls], [torch.ones((), device=ls.device)]
                else:
                    outs, cots = [x_out], [g]
            if m < p.M - 1:
                for new, dc in zip(c_out, gcache[k, v]):
                    outs += list(new)
                    cots += [a[:, :ctx + l] for a in dc]
            inputs = [x_in] + ([c for kv in c_in for c in kv] if m > 0 else [])
            params_in = list(tree_leaves(u.layers[k, v]))
            if (k, v) == p.last:
                params_in += [u.final_ln, u.w_head]
            return outs, cots, inputs, params_in

        def apply_input_cots(k, v, i, grads, outs):
            """The input cotangent onto the reverse ring (or, at rank 0
            chunk 0, into the embedding's), the cache cotangent for the
            microbatch's earlier slices, and the loss term."""
            d, m = divmod(i, p.M)
            if (k, v) == p.last:
                u.loss = u.loss + outs[0].detach().float()
            if m > 0:
                gcache[k, v] = list(zip(grads[1::2], grads[2::2]))   # (dk, dv) per layer
            else:
                gcache.pop((k, v), None)
            if (k, v) == (0, 0):
                p.rows_of(u.d_emb, d, m).copy_(grads[0])
                return None
            return grads[0]

        def run_bwd(k, v, i, kind, g):
            if kind == KIND_BWD_WEIGHT:              # W: the params' gradient, B's graph
                outs, cots, params_in = held.pop(k, v, i)
                if params_in:                       # not a chunk of pad rows only
                    u.param_cots(k, v, torch.autograd.grad(outs, params_in, cots))
                store.pop(k, v, i)
                return None
            assert kind in (KIND_BWD, KIND_BWD_INPUT), kind
            if kind == KIND_BWD:                     # fused: params and inputs at once
                outs, cots, inputs, params_in = unit_graph(k, v, i, store.pop(k, v, i), g)
                grads = torch.autograd.grad(outs, inputs + params_in, cots)
                u.param_cots(k, v, grads[len(inputs):])
                return apply_input_cots(k, v, i, grads[:len(inputs)], outs)
            # B: the inputs' gradient now; the graph waits a tick for W
            outs, cots, inputs, params_in = unit_graph(k, v, i, store.get(k, v, i), g)
            grads = torch.autograd.grad(outs, inputs, cots, retain_graph=True)
            held.put(k, v, i, (outs, cots, params_in))
            return apply_input_cots(k, v, i, grads, outs)

        _run_ticks(p, run_fwd, run_bwd)
        assert not store.slots and not held.slots, "units left without their backward"
        value_and_grad_fn.residual_peak = store.peak
        return u.finish()

    return value_and_grad_fn


def _run_ticks_transposed(p: _Plan, run_bwd: Callable) -> None:
    """The forward tick table run backwards, the transpose of
    :func:`_run_ticks`'s forward ring (what JAX's AD makes of the
    reference's ``ppermute``): reverse tick ``r`` is forward tick ``T-1-r``;
    each hosted rank's forward unit there runs ``run_bwd(k, v, i, g)`` with
    the cotangent of its output (None at the last global stage, which
    seeds from the loss) and returns its input's cotangent or None; the
    cotangents travel on the reverse ring.  A value that crossed the
    forward wrap edge (rank K-1 -> 0) waited ``fwd_hold`` ticks at rank 0,
    so its cotangent waits as long at rank K-1: a unit reads the value the
    ring delivered ``hold`` reverse ticks before its own."""
    K, tab, hold = p.K, p.tab, p.comm.fwd_hold
    hosted = p.ring.ranks
    n, h, T = len(hosted), p.comm.fwd_hold + 1, p.tab.shape[0]
    gbuf = [[None] * h for _ in range(n)]
    g_recv: List[Any] = [None] * n
    for r in range(T):
        t = T - 1 - r
        for j in range(n):
            gbuf[j][r % h] = g_recv[j]
        g_sent: List[Any] = [None] * n
        for j, k in enumerate(hosted):
            if tab[t, k, 0] < 0:
                continue
            i, v, kind = (int(a) for a in tab[t, k])
            assert kind == KIND_FWD, (t, k, kind)
            g = None
            if (k, v) != p.last:
                g = gbuf[j][(r - (hold if k == K - 1 else 0)) % h]
                assert g is not None, (t, k, v, i)
            p.running = k
            g_sent[j] = run_bwd(k, v, i, g)
        p.running = None
        g_recv = p.ring.shift(g_sent, step=-1)


def _make_transposed_value_and_grad(p: _Plan) -> Callable:
    """``(params, batch) -> (loss, grads)`` of a forward-only schedule on a
    ring that hosts one rank per process, where autograd cannot run over
    the whole tick loop: the same loss and gradients as that run, by the
    transposed tick table (the reference differentiates its ring with
    ``jax.value_and_grad``, ``pipeline.py:968-982``).

    * The forward ticks run as in process, under grad: a value the ring
      delivered enters its unit as a leaf, and so do the cache rows the
      microbatch's earlier slice left (each layer under checkpoint when
      ``cfg.remat``).  Each unit keeps its graph, its input and cache
      leaves and its outputs.
    * The last global stage reassembles its items, runs the post-groups,
      the head and the loss on leaves of their own (``_make_loss_from_plan``
      without the tick loop), and takes the cotangent of each item's output.
    * The forward table runs again in reverse tick order
      (:func:`_run_ticks_transposed`): each unit's ``torch.autograd.grad``
      over its kept graph, with its output's cotangent from the reverse
      ring (or the loss) and its cache outputs' from the microbatch's next
      slice; its input's cotangent goes on the reverse ring (rank 0 chunk
      0: into the embedding's), its cache inputs' to the microbatch's
      previous slice.  Every send and receive sits in the tick
      interpreter, none inside an autograd backward, so every rank pairs
      them alike; the tensor-parallel all-reduces run inside each unit's
      ``autograd.grad``, in the same order on every tp rank.
    * :class:`_UnitGrads` sums the parameters' gradients and, at the end,
      everything over the ring."""

    def value_and_grad_fn(params, batch):
        u = _UnitGrads(p, params, batch)
        last_hosted = p.last[0] in p.ring.ranks
        caches: Dict[Tuple[int, int], list] = {}
        store = _ResidualStore(p.K, p.DM)             # every unit lives to the reverse pass
        gcache: Dict[Tuple[int, int], list] = {}     # cache cotangent of the later slices
        seeds: Dict[int, torch.Tensor] = {}           # the last stage's output cotangents

        def run_fwd(k, v, i, x_in):
            d, m = divmod(i, p.M)
            x_in = (p.rows_of(u.x_det, d, m) if x_in is None else x_in).detach()
            x_in.requires_grad_()
            c_in = (p.fresh_caches(len(u.layers[k, v])) if m == 0
                    else tree_map(_requiring_grad, caches[k, v]))
            with torch.enable_grad():
                x_out, caches[k, v] = p.stage_apply(u.layers[k, v], x_in, c_in, p.starts[m],
                                                    remat=p.cfg.remat)
            store.put(k, v, i, (x_in, c_in, x_out, caches[k, v]))
            return x_out.detach()

        def run_bwd(k, v, i, g):
            d, m = divmod(i, p.M)
            x_in, c_in, x_out, c_out = store.pop(k, v, i)
            outs, cots = [x_out], [seeds.pop(i) if (k, v) == p.last else g]
            if m < p.M - 1:
                for o, c in zip(tree_leaves(c_out), gcache.pop((k, v))):
                    if c is not None and o.requires_grad:
                        outs.append(o)
                        cots.append(c)
            inputs = [x_in] + (list(tree_leaves(c_in)) if m > 0 else [])
            params_in = list(tree_leaves(u.layers[k, v]))
            grads = torch.autograd.grad(outs, inputs + params_in, cots, allow_unused=True)
            u.param_cots(k, v, grads[len(inputs):])
            if m > 0:
                gcache[k, v] = grads[1:len(inputs)]
            if (k, v) == (0, 0):
                p.rows_of(u.d_emb, d, m).copy_(grads[0])
                return None
            return grads[0]

        _run_ticks(p, run_fwd)
        if last_hosted:
            # the loss on the last stage's outputs: reassembled, then the
            # post-groups, the head and the loss, as _make_loss_from_plan
            outs = [store.get(*p.last, i)[2].detach().requires_grad_() for i in range(p.DM)]
            with torch.enable_grad():
                x_final = torch.cat([torch.cat(outs[d * p.M:(d + 1) * p.M], dim=1)
                                     for d in range(p.D)], dim=0)
                for g in p.post:
                    x_final = _scan_full(g, u.post[g.name], x_final, p.cfg.remat)
                loss = p.model.head_loss(u.head_params(), x_final, batch["labels"])
                if p.data > 1:
                    loss = loss * (p.b_local / p.B)
            post = list(tree_leaves(u.post))
            grads = torch.autograd.grad(loss, outs + post + [u.final_ln, u.w_head])
            seeds.update(enumerate(grads[:p.DM]))
            for acc, g in zip(tree_leaves(u.d_post), grads[p.DM:p.DM + len(post)]):
                acc += g.float()
            u.head_cots(grads[p.DM + len(post):])
            u.loss = loss.detach().float()
            del outs, x_final, loss, grads
        _run_ticks_transposed(p, run_bwd)
        assert not store.slots, "units left without their backward"
        return u.finish()

    return value_and_grad_fn


def make_terapipe_loss(model: Model, tcfg: TeraPipeConfig, seq_len: int,
                       global_batch: int, n_ranks, groups=None) -> Callable:
    """``loss_fn(params, batch)`` of the pipelined step under a
    forward-only schedule (differentiate it with autograd, or use
    :func:`make_terapipe_value_and_grad`, which serves every schedule).
    ``n_ranks``: an int K or a :class:`~repro_torch.launch.mesh.Mesh`; with
    a data axis the loss is the sum of the data ranks' (each on its own
    rows).  Explicit-backward schedules raise ``ValueError``."""
    p = _Plan(model, tcfg, seq_len, global_batch, n_ranks, groups)
    if not all(_hosts_all(g) for g in (p.ring, p.tp_group, p.data_group)):
        raise ValueError("make_terapipe_loss runs every rank in process; across processes use "
                         "make_terapipe_value_and_grad")
    local = _make_loss_from_plan(p)

    def loss_fn(params, batch):
        return p.data_group.all_reduce([local(params, p.local_batch(batch, r))
                                        for r in p.data_group.ranks])[0]

    return loss_fn


def make_terapipe_caches_fn(model: Model, tcfg: TeraPipeConfig, seq_len: int,
                            global_batch: int, n_ranks) -> Callable:
    """Debug/testing: ``(params, batch) ->`` the main group's final caches
    of the same tick loop under a forward-only schedule, each leaf stacked
    ``(n_layers, B/D, ...)`` in layer order (global stage ``s = v·K + k``,
    the layout of ``model.init_caches``: ``(k, v)`` for the dense family),
    run without autograd.  With ``tcfg.extra_ticks`` appended the result
    must be bit-identical.  Pipe meshes only (no tp or data axis)."""
    p = _Plan(model, tcfg, seq_len, global_batch, n_ranks)
    assert not p.assign.has_backward, "forward-only schedules expose the caches"
    if p.tp > 1 or p.data > 1:
        raise ValueError("make_terapipe_caches_fn runs pipe meshes (no tp or data axis)")

    @torch.no_grad()
    def caches_fn(params, batch):
        _, caches = _run_forward(p, params, p.prefix(params, batch))
        stages = range(p.K * p.V)
        layers = [c for s in stages for c in caches[s % p.K, s // p.K]]
        return tree_map(lambda *rows: torch.stack(rows), *layers)

    return caches_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)`` of ``loss_fn`` by autograd, the
    counterpart of ``jax.value_and_grad``; every leaf of ``params`` must
    require grad.  The loss comes back detached."""

    def vg(params, batch):
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(tree_leaves(params)))
        return loss.detach(), tree_unflatten(params, grads)

    return vg


def _reduce_tp_regions(p: _Plan, grads):
    """Under a tp group that hosts one rank per process: the main group's
    gradients of the leaves inside tensor-parallel regions summed over
    the axis (a replicated leaf's rank holds its share, such as the KV
    heads its q heads read where the axis does not divide them; a cut
    leaf's rank, with whole parameters, its block's gradient and zeros).
    A leaf the process holds as its tp rank's block has its whole
    gradient already, and so do the norms outside the regions and
    everything outside the stages."""
    main = grads["groups"][p.main.name]
    for path, g in tree_items(main):
        if path.split("/")[1] in _TP_REGIONS and not (p.tp_sharded and p.tp_cut[path]):
            g.copy_(p.tp_group.all_reduce([g])[0])
    return grads


def make_terapipe_value_and_grad(model: Model, tcfg: TeraPipeConfig, seq_len: int,
                                 global_batch: int, n_ranks, groups=None) -> Callable:
    """``(params, batch) -> (loss, grads)`` for the pipelined step under any
    registered training schedule, the one entry point the trainer drives
    (reference ``pipeline.py:968-982``): autograd over the tick loop for
    the forward-only schedules, the explicit backward units otherwise.

    ``n_ranks``: an int K (``Mesh(pipe=K)``) or a
    :class:`~repro_torch.launch.mesh.Mesh` with ``pipe`` and optional
    ``tp`` and ``data`` axes; ``groups``: the process's transport per axis
    (``distributed.transport.mesh_groups``), every rank in process by
    default.  On a ring that hosts one rank per process the function takes
    and returns the process's shard (:func:`shard_params` of
    ``vg.plan.shard_layout(params)``).  With a data axis, each hosted data
    rank's loss and gradients are computed in turn on its rows and then
    summed by the data group.  An
    explicit schedule's function keeps, as ``residual_peak``, the most
    saved units one rank held in its last call.  Every function carries its
    ``plan`` (slices, schedule assignment, tick table), which the audits
    (``repro_torch.analysis``) hold the run to."""
    p = _Plan(model, tcfg, seq_len, global_batch, n_ranks, groups)
    if p.assign.has_backward:
        local = _make_explicit_value_and_grad(p)
    elif _hosts_all(p.ring):
        local = value_and_grad(_make_loss_from_plan(p))
    else:
        local = _make_transposed_value_and_grad(p)

    def vg(params, batch):
        # each hosted data rank's graph in turn; then the sums over the
        # data axis, leaf by leaf, each rank's leaf freed once summed
        losses, per_rank = [], []
        for r in p.data_group.ranks:
            loss, grads = local(params, p.local_batch(batch, r))
            losses.append(loss)
            per_rank.append(list(tree_leaves(grads)))
        reduce = p.data_group.all_reduce
        loss = reduce(losses)[0]
        leaves = []
        for j in range(len(per_rank[0])):
            leaves.append(reduce([g[j] for g in per_rank])[0])
            for g in per_rank:
                g[j] = None
        grads = tree_unflatten(grads, leaves)
        if p.tp > 1 and not _hosts_all(p.tp_group):
            grads = _reduce_tp_regions(p, grads)
        if p.assign.has_backward:
            vg.residual_peak = local.residual_peak
        return loss, grads

    vg.plan = p
    return vg


def shard_params(params, layout):
    """The process's shard of the whole tree ``params``: per leaf its block
    of ``layout`` (:meth:`_Plan.shard_layout`), each in storage of its own
    and a leaf of its own (requiring grad where the whole leaf does); a
    leaf held whole is the leaf itself.  ``layout`` None: ``params``."""
    if layout is None:
        return params

    def leaf(a, ls):
        b = ls.mine
        return a if b.whole else b.cut(a.detach()).requires_grad_(a.requires_grad)
    return tree_map(leaf, params, layout)


def full_shapes(layout) -> Any:
    """The whole shape of every leaf of ``layout``, a tree of ``torch.Size``."""
    return tree_map(lambda ls: torch.Size(ls.shape), layout)


def make_gpipe_loss(model: Model, *, n_microbatches: int, seq_len: int,
                    global_batch: int, n_ranks, cache_dtype: Any = torch.bfloat16) -> Callable:
    """Microbatch-only pipelining (GPipe, the paper's baseline): D
    microbatches, one token slice per sequence."""
    tcfg = TeraPipeConfig(n_token_slices=1, n_microbatches=n_microbatches,
                          cache_dtype=cache_dtype)
    return make_terapipe_loss(model, tcfg, seq_len, global_batch, n_ranks)
