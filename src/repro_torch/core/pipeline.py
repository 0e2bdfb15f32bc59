"""TeraPipe: token-level pipeline parallelism, the ``contiguous`` schedule
on K virtual ranks in one process (reference: ``repro/core/pipeline.py``).

The paper's execution model (§3.2), as the reference runs it:

* the main layer stack is cut into K stages; stage k runs on rank k
  (``StageAssignment.layer_rows``);
* a minibatch is cut into D microbatches × M token slices; work item
  ``i = d·M + m`` enters stage 0 at its tick and flows down the ranks, one
  ring shift per tick;
* each stage keeps a KV cache per layer of the prefix of the current
  microbatch it has already processed, so slice m attends at context
  offset ``ctx = l_0 + … + l_{m-1}`` (the paper's t_fwd(l, ctx)).

Which unit runs where and when comes from the schedule IR
(``core/schedules``): a Python tick loop reads each rank's
``(work_item, chunk, kind)`` from ``assign.tick_table(D·M)`` and runs it.
The activations move between ranks through a transport with one ``shift``
method (:class:`LocalRing`, in process), so that a ``torch.distributed``
ring can later stand behind the same call (ROADMAP Queue 1 item 9).  The
backward pass is autograd over the whole tick loop, as
``jax.value_and_grad`` of the reference's scan is: caches are written out
of place under grad (``models/attention.py::_write_rows``), so each slice's
K/V cotangent flows back through every later slice's attention.

What differs from the reference, and why the result does not:

* **No mesh.** K ranks run one after another in one process on one device,
  so the signatures take ``(model, tcfg, seq_len, global_batch, n_ranks)``
  in place of ``(model, specs, mesh, ...)``.  Parameter shardings and
  tensor parallelism are not ported (ROADMAP Queue 1 item 9).
* **Eager shapes.** The reference pads every slice to ``l_max``, pads the
  cache to ``L + l``, pads the sequence and sends idle ticks' outputs to a
  dump row, all to keep a traced ``lax.scan`` shape-stable.  Here each
  slice runs at its own length at its own ``ctx`` (a host int), an idle
  tick does nothing, and the cache is ``L`` long.  The loss and the
  gradients on every valid token are the same.
* **Uneven stages.** When K does not divide the layer count the reference
  pads the stack with zero (identity) blocks; here a stage runs the real
  layers among its ``layer_rows`` and skips the pad rows, which is exact.
* **Schedules.** Only ``contiguous`` executes (and GPipe, its M = 1 case).
  The other registered schedules raise ``NotImplementedError`` naming
  ROADMAP Queue 1 item 6.  There is no rolled/unrolled distinction: that
  is one of JAX tracing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.models import Model
from repro_torch.models.lm import BlockGroup, _remat, _unstack
from repro_torch.tree import tree_leaves, tree_unflatten

from .schedules import KIND_FWD, get_schedule, schedule_names

#: registered schedule names (core/schedules registry): the CLI choices
SCHEDULES = schedule_names()


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
    # V: virtual stages per rank; V > 1 (interleaving) is not ported yet
    virtual_stages: int = 1
    # which schedule table drives the tick loop (core/schedules registry);
    # "contiguous" with virtual_stages > 1 is promoted to "interleaved", as
    # in the reference
    schedule: str = "contiguous"
    # debug: all-idle ticks appended to the tick loop; they must leave the
    # caches bit-identical (tests assert it)
    extra_ticks: int = 0


class LocalRing:
    """Ring transport of K virtual ranks in one process: ``shift`` hands
    each rank the value its ring predecessor sent (the reference's
    ``ppermute`` over ``(j, (j + 1) % K)``)."""

    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks

    def shift(self, sent: List[Any]) -> List[Any]:
        assert len(sent) == self.n_ranks, (len(sent), self.n_ranks)
        return [sent[(k - 1) % self.n_ranks] for k in range(self.n_ranks)]


def _main_group(model: Model) -> BlockGroup:
    """The pipelined group.  The reference (``_group_split``, ``:173``) also
    runs small pre/post groups around the pipeline for the MoE and hybrid
    families; the port's models are dense, one homogeneous group."""
    if len(model.groups) != 1:
        raise NotImplementedError(
            f"family {model.cfg.family!r}: the pipeline runs single-group "
            f"(dense) models (ROADMAP Queue 1 item 8)")
    return model.groups[0]


class _Plan:
    """Everything the executor derives from (model, tcfg, shapes, K): slice
    geometry, the schedule assignment, the stage-local block function."""

    def __init__(self, model: Model, tcfg: TeraPipeConfig, seq_len: int,
                 global_batch: int, n_ranks: int):
        self.model, self.tcfg = model, tcfg
        self.K = K = n_ranks
        self.D = D = tcfg.n_microbatches
        self.L, self.B = L, B = seq_len, global_batch

        V = tcfg.virtual_stages
        sched = "interleaved" if tcfg.schedule == "contiguous" and V > 1 else tcfg.schedule
        self.main = _main_group(model)
        self.n_main = self.main.count
        # the registry validates the (schedule, V) combination and builds
        # the IR value the tick loop interprets
        self.assign = get_schedule(sched, n_ranks=K, n_layers=self.n_main,
                                   virtual_stages=V, n_microbatches=D)
        if sched != "contiguous":
            raise NotImplementedError(
                f"schedule {sched!r} (V={V}): the port's executor runs the "
                f"contiguous schedule; the others are ROADMAP Queue 1 item 6")

        if tcfg.slice_lens is not None:
            slice_lens = tuple(int(s) for s in tcfg.slice_lens)
            assert sum(slice_lens) == L and min(slice_lens) >= 1, (slice_lens, L)
        else:
            M = tcfg.n_token_slices
            assert L % M == 0, (L, M)
            slice_lens = (L // M,) * M
        self.slice_lens, self.M = slice_lens, len(slice_lens)
        self.starts = [sum(slice_lens[:m]) for m in range(self.M)]
        assert B % D == 0, (B, D)
        self.mb = B // D
        self.DM = D * self.M

        # the model's own config decides the attention route (use_kernel)
        self.cfg = model.cfg
        self.block_fn = self.main.sliced_dyn
        self.ring = LocalRing(K)

    def prefix(self, params, batch) -> torch.Tensor:
        """Embedding in the activation dtype (the port's models have no
        pre-pipeline groups)."""
        return self.model.embed(params, batch, 0).to(self.cfg.dtype)

    def stage_layers(self, main_params) -> List[list]:
        """Per rank, the per-layer parameter dicts of its stage: the real
        layers among ``layer_rows``; pad rows are skipped."""
        layers = _unstack(main_params)
        out = []
        for k in range(self.K):
            lo, hi = self.assign.layer_rows(self.assign.stage_of(k, 0))
            out.append(layers[lo:min(hi, self.n_main)])
        return out

    def fresh_caches(self, n_layers: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zero (k, v) caches of ``n_layers`` layers for one microbatch."""
        cfg = self.cfg
        shape = (self.mb, self.L, cfg.n_kv_heads, cfg.hd)
        zeros = lambda: torch.zeros(shape, dtype=self.tcfg.cache_dtype,
                                    device=self.model.device)
        return [(zeros(), zeros()) for _ in range(n_layers)]

    def stage_apply(self, layers, x, caches, ctx: int):
        """One stage's forward of one slice at offset ``ctx``: its blocks in
        order, each under non-reentrant checkpoint when ``cfg.remat`` and
        autograd is recording (the reference's per-block
        ``jax.checkpoint``)."""
        block = self.block_fn
        if self.cfg.remat and torch.is_grad_enabled():
            block = _remat(self.block_fn, self.cfg)
        new = []
        for bp, c in zip(layers, caches):
            x, c = block(bp, x, c, ctx)
            new.append(c)
        return x, new


def _run_ticks(p: _Plan, params, x_emb: torch.Tensor):
    """The tick loop.  Returns the last rank's output of every work item (in
    item order) and each rank's final caches."""
    tab = p.assign.tick_table(p.DM)
    stages = p.stage_layers(params["groups"][p.main.name])
    caches: List[list] = [[] for _ in range(p.K)]
    outs: List[Optional[torch.Tensor]] = [None] * p.DM
    received: List[Optional[torch.Tensor]] = [None] * p.K
    for t in range(tab.shape[0] + p.tcfg.extra_ticks):
        sent: List[Optional[torch.Tensor]] = [None] * p.K
        for k in range(p.K):
            if t >= tab.shape[0] or tab[t, k, 0] < 0:
                continue                              # idle: nothing runs
            i, chunk, kind = (int(a) for a in tab[t, k])
            assert kind == KIND_FWD and chunk == 0, (t, k, kind, chunk)
            d, m = divmod(i, p.M)
            ctx, l = p.starts[m], p.slice_lens[m]
            if k == 0:                                # rank 0 admits new work
                x_in = x_emb[d * p.mb:(d + 1) * p.mb, ctx:ctx + l]
            else:
                x_in = received[k]
            if m == 0:                                # new microbatch: fresh prefix
                caches[k] = p.fresh_caches(len(stages[k]))
            sent[k], caches[k] = p.stage_apply(stages[k], x_in, caches[k], ctx)
            if k == p.K - 1:
                outs[i] = sent[k]
        received = p.ring.shift(sent)
    return outs, caches


def _make_loss_from_plan(p: _Plan) -> Callable:
    """Differentiable loss over the tick loop: reassemble the last rank's
    per-item outputs into ``(B, L, d)`` and run the head and the chunked
    loss on it, as the reference's ``_make_loss_from_plan`` does."""

    def loss_fn(params, batch) -> torch.Tensor:
        outs, _ = _run_ticks(p, params, p.prefix(params, batch))
        x_final = torch.cat([torch.cat(outs[d * p.M:(d + 1) * p.M], dim=1)
                             for d in range(p.D)], dim=0)
        return p.model.head_loss(params, x_final, batch["labels"])

    return loss_fn


def make_terapipe_loss(model: Model, tcfg: TeraPipeConfig, seq_len: int,
                       global_batch: int, n_ranks: int) -> Callable:
    """``loss_fn(params, batch)`` of the pipelined step (differentiate it
    with autograd, or use :func:`make_terapipe_value_and_grad`)."""
    return _make_loss_from_plan(_Plan(model, tcfg, seq_len, global_batch, n_ranks))


def make_terapipe_caches_fn(model: Model, tcfg: TeraPipeConfig, seq_len: int,
                            global_batch: int, n_ranks: int) -> Callable:
    """Debug/testing: ``(params, batch) -> (k, v)`` final caches of the
    same tick loop, each ``(n_layers, B/D, L, Hkv, hd)`` in layer order (the
    layout of ``model.init_caches``), run without autograd.  With
    ``tcfg.extra_ticks`` appended the result must be bit-identical."""
    p = _Plan(model, tcfg, seq_len, global_batch, n_ranks)

    @torch.no_grad()
    def caches_fn(params, batch):
        _, caches = _run_ticks(p, params, p.prefix(params, batch))
        layers = [c for rank in caches for c in rank]
        return (torch.stack([k for k, _ in layers]), torch.stack([v for _, v in layers]))

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


def make_terapipe_value_and_grad(model: Model, tcfg: TeraPipeConfig, seq_len: int,
                                 global_batch: int, n_ranks: int) -> Callable:
    """``(params, batch) -> (loss, grads)`` for the pipelined step, the one
    entry point the trainer drives (the reference's fwd-only branch,
    ``pipeline.py:968-982``).  Explicit-backward schedules raise."""
    return value_and_grad(make_terapipe_loss(model, tcfg, seq_len, global_batch, n_ranks))


def make_gpipe_loss(model: Model, *, n_microbatches: int, seq_len: int,
                    global_batch: int, n_ranks: int,
                    cache_dtype: Any = torch.bfloat16) -> Callable:
    """Microbatch-only pipelining (GPipe, the paper's baseline): D
    microbatches, one token slice per sequence."""
    tcfg = TeraPipeConfig(n_token_slices=1, n_microbatches=n_microbatches,
                          cache_dtype=cache_dtype)
    return make_terapipe_loss(model, tcfg, seq_len, global_batch, n_ranks)
