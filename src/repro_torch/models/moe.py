"""Mixture-of-Experts FFN: grouped top-k routing with gather dispatch
(reference: ``repro/models/moe.py``).

Token-local: routing and the expert FFN act position-wise, and the routing
groups are fixed blocks of ``cfg.moe_block`` tokens, so TeraPipe token
slicing is exact on slices that are multiples of the block (a slice holds
whole groups, and the capacity drops are the same in one pass or in
slices).  Per group, GShard style, each expert takes at most
C = ceil(capacity_factor * S * k / E) of the group's (token, choice) pairs;
the rest go to an overflow bin and add nothing.

Supports DeepSeek-MoE fine-grained experts: ``n_shared_experts`` always-on
dense experts of width ``n_shared * d_expert`` plus ``n_experts`` routed
experts with top-k gating.

What differs from the reference, and why the result does not:

* The reference ``vmap``s one group at a time; here every group of the
  batch is routed at once.  The expert inputs of all groups lie in one
  ``(E, G * C, D)`` tensor, expert-major, so each expert weight is one
  batched matmul over every group.
* Dispatch and combine are gathers whose backward pass is a gather too
  (:class:`_Gather`), through the inverse slot map: a token's gradient is
  the sum over its k choices, in choice order, of its slots' gradients.
  Nothing is scattered with atomics, so a step repeats bit for bit on the
  card.  The combine is a weighted sum over each token's k choices, an
  ``(S, k, D)`` tensor, not a scatter-add.
* Expert parallelism (``cfg.tp_axis``): the reference routes on every
  rank; here a process routes once for the ranks it hosts (the same
  global routing) and each rank dispatches to its own experts.  The
  reference's ``shard_map`` layout of the dispatch over the data axes is
  a hint to XLA's sharding propagation, with no eager counterpart.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .common import ModelConfig, dense_init, shards, swiglu, tp_group
from .layers import ffn as dense_ffn, ffn_specs, init_ffn

#: The routing record, off (``None``) by default.  Set to a list, every
#: routing call appends ``(router, topi, keep, grad)``: the layer's router
#: weight, the chosen experts ``(G, S, k)``, which choices fit their
#: expert's capacity ``(G, S * k)``, and whether autograd was recording (a
#: forward unit of an explicit-backward schedule runs without it, its
#: recompute with it).  The tensors stay on the device and nothing waits for
#: them; ``chip_smoke.py`` reads drops and assignments from it.
ROUTING_LOG = None


def init_moe(gen: torch.Generator, cfg: ModelConfig):
    e, d, dff = cfg.n_experts, cfg.d_model, cfg.d_expert
    p = {
        "router": dense_init(gen, (d, e)),
        "w_gate": dense_init(gen, (e, d, dff), in_axis=-2),
        "w_up": dense_init(gen, (e, d, dff), in_axis=-2),
        "w_down": dense_init(gen, (e, dff, d), in_axis=-2),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_ffn(gen, cfg, d_ff=cfg.n_shared_experts * dff)
    return p


def moe_specs(cfg: ModelConfig):
    """The logical axes of :func:`init_moe`'s leaves: the expert axis
    leads each expert's weights; the router's expert columns and the
    experts' own width carry no logical axis (as the reference's)."""
    s = {"router": ("embed", None), "w_gate": ("experts", "embed", None),
         "w_up": ("experts", "embed", None), "w_down": ("experts", None, "embed")}
    if cfg.n_shared_experts:
        s["shared"] = ffn_specs(cfg)
    return s


def _pad_row(a: torch.Tensor) -> torch.Tensor:
    """``a`` (N, D) with a zero row appended at index N."""
    return torch.cat([a, a.new_zeros((1, a.shape[-1]))])


class _Gather(torch.autograd.Function):
    """``out[i] = [src; 0][idx[i]]``, whose gradient is a gather as well:
    ``dsrc[r] = sum_f [dout; 0][inv[r * fold + f]]``, with ``inv`` listing,
    for each source row, the ``fold`` output rows that read it (``len(out)``
    where fewer do).  The caller guarantees that ``inv`` is the inverse of
    ``idx``.  torch's own backward of an index is a scatter-add, whose
    atomics make the summation order, and so the result, vary on CUDA."""

    @staticmethod
    def forward(ctx, src, idx, inv, fold: int):
        ctx.save_for_backward(idx, inv)
        ctx.fold = fold
        return _pad_row(src).index_select(0, idx)

    @staticmethod
    def backward(ctx, dout):
        _, inv = ctx.saved_tensors
        d = _pad_row(dout).index_select(0, inv)
        return d.reshape(-1, ctx.fold, d.shape[-1]).sum(1), None, None, None


class _Routing(NamedTuple):
    """The global routing of G groups: renormalised top-k weights and
    experts ``(G, S, k)``, the flat choices' experts and queue positions
    ``(G, S·k)``, which fit the capacity, and the capacity."""
    topw: torch.Tensor
    flat_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def _route(router: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor) -> _Routing:
    """Top-k routing of G token groups over all ``cfg.n_experts``, with the
    capacity counted over them: the same on every expert-parallel rank."""
    g, s, d = xg.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    capacity = max(1, math.ceil(cfg.capacity_factor * s * k / e))

    logits = (xg @ router.to(xg.dtype)).float()                           # (G, S, E)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, k, dim=-1)                             # (G, S, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # slot position of each (token, choice) in its expert's queue, within its
    # group: the exclusive count of earlier choices of that expert in the
    # flat token-major (S * k) order
    with torch.no_grad():
        flat_e = topi.reshape(g, s * k)
        onehot = (flat_e[..., None] == torch.arange(e, device=xg.device)).to(torch.int32)
        pos = torch.gather(torch.cumsum(onehot, dim=1), 2, flat_e[..., None])[..., 0] - 1
        keep = pos < capacity
    if ROUTING_LOG is not None:
        ROUTING_LOG.append((router, topi, keep, torch.is_grad_enabled()))
    return _Routing(topw, flat_e, pos, keep, capacity)


def _route_groups(p, cfg: ModelConfig, xg: torch.Tensor, routing: Optional[_Routing] = None,
                  rank: int = 0) -> torch.Tensor:
    """Route G token groups at once (the reference's ``_route_group`` under
    ``vmap``).  xg: (G, S, D) -> (G, S, D).  Under expert parallelism
    (``p`` holds ``e_local < n_experts`` experts: rank ``rank``'s, experts
    ``[rank·e_local, (rank+1)·e_local)``) the global ``routing`` is kept
    for the local experts only; every other choice goes to the overflow
    bin, and the output is this rank's partial."""
    g, s, d = xg.shape
    k = cfg.moe_top_k
    topw, flat_e, pos, keep, capacity = routing or _route(p["router"], cfg, xg)
    e_local = p["w_gate"].shape[0]
    dev = xg.device
    with torch.no_grad():
        off = rank * e_local
        keep = keep & (flat_e >= off) & (flat_e < off + e_local)
        flat_e = flat_e - off
        # expert-major slots over every group: (expert, group, position);
        # dropped choices go to the overflow index n_slots (a zero row)
        n_slots, n_choice = e_local * g * capacity, g * s * k
        grp = torch.arange(g, device=dev)[:, None]
        slot = torch.where(keep, flat_e * (g * capacity) + grp * capacity + pos,
                           n_slots).reshape(-1)                           # (G*S*k,)
        # the inverse: the (token, choice) in each slot, n_choice where empty
        choice = torch.full((n_slots + 1,), n_choice, dtype=torch.long, device=dev)
        choice.scatter_(0, slot, torch.arange(n_choice, device=dev))
        choice = choice[:n_slots]
        token = torch.where(choice < n_choice, choice // k, g * s)

    # expert_in[e, (g, c)] = the group's token in that slot (zeros where empty)
    expert_in = _Gather.apply(xg.reshape(g * s, d), token, slot, k)
    expert_in = expert_in.reshape(e_local, g * capacity, d)
    h = swiglu(torch.bmm(expert_in, p["w_gate"].to(xg.dtype)),
               torch.bmm(expert_in, p["w_up"].to(xg.dtype)))
    expert_out = torch.bmm(h, p["w_down"].to(xg.dtype)).reshape(n_slots, d)

    # combine: out[t] = sum_j w[t, j] * expert_out[slot(t, j)], over the k
    # choices in order; a dropped choice reads the zero row and weighs 0
    per_choice = _Gather.apply(expert_out, slot, choice, 1).reshape(g, s, k, d)
    w = (topw * keep.reshape(g, s, k).to(topw.dtype)).to(xg.dtype)
    return (per_choice * w[..., None]).sum(2)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    Routing groups are fixed ``cfg.moe_block``-token blocks (never whole
    sequences): a slice that is a multiple of the block holds whole groups,
    so capacity drops do not depend on how the sequence is sliced.

    Under tensor parallelism (``cfg.tp_axis`` a group, ``p`` the hosted
    ranks' shards: each a slice of the experts and of the shared experts'
    ``ff``) the routing is computed once over all experts from the
    replicated router, each rank runs its experts and its share of the
    shared experts, and the partials are summed once (reference
    ``moe.py:162-165``)."""
    b, s, d = x.shape
    blk = min(cfg.moe_block, s)
    assert s % blk == 0, f"seq {s} not a multiple of moe_block {blk}"
    group, ps = tp_group(cfg.tp_axis), shards(p)
    xs = group.region(x)
    xgs = [x_r.reshape(b * (s // blk), blk, d) for x_r in xs]
    routing = _route(ps[0]["router"], cfg, xgs[0])
    parts = []
    for r, p_r, x_r, xg in zip(group.ranks, ps, xs, xgs):
        out = _route_groups(p_r, cfg, xg, routing, r).reshape(b, s, d)
        if cfg.n_shared_experts:
            out = out + dense_ffn(p_r["shared"], x_r)
        parts.append(out)
    return group.all_reduce(parts)[0]


def aux_load_balance_loss(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e."""
    xt = x.reshape(-1, x.shape[-1])
    logits = (xt @ p["router"].to(x.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    f = torch.nn.functional.one_hot(top1, cfg.n_experts).float().mean(0)
    pbar = gates.mean(0)
    return cfg.n_experts * torch.sum(f * pbar)
