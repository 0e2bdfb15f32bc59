"""AdamW + LR schedules + global-norm clipping + gradient accumulation
(reference: ``repro/optim/adamw.py``).

The reference's functional API, defaults and order of operations, on the
port's nested-dict parameter trees:
    opt = adamw(lr_schedule, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Moments are fp32 regardless of param dtype (bf16-safe); the update is cast
back to the param dtype.  The step count and the learning rate are 0-d
tensors on the parameters' device, so an update never waits on the host.
``update`` computes each leaf's clipped gradient, moments and update in one
pass (the reference maps whole trees one after another): each element sees
the same operations in the same order, and the temporaries are one leaf's,
not one model's.

Over a sharded state (each process the blocks it holds, parameters and
moments alike) the clip norm is the world's: ``sq_norm_reduce`` takes the
per-leaf squared sums of the process's gradients and returns the global
squared norm, which every process then uses (``launch/train.py`` passes
:func:`world_sq_norm`: each process sums the blocks it owns, and the world
sums those).  Without it, the norm is the tree's own, as before.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor         # int32, 0-d
    m: Any                     # fp32 tree
    v: Any                     # fp32 tree
    master: Any = None         # fp32 master weights (bf16-param training)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable           # (grads, state, params) -> (updates, state)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> Callable:
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = step / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return peak_lr * torch.where(step < warmup_steps, warm, cos)
    return lr


def constant_schedule(lr_value: float) -> Callable:
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def global_norm(tree, sq_norm_reduce: Optional[Callable] = None) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree``; with ``sq_norm_reduce``,
    the square root of what it makes of the leaves' squared sums."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if sq_norm_reduce is not None:
        return torch.sqrt(sq_norm_reduce(leaves))
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def world_sq_norm(layout, world) -> Callable:
    """``sq_norm_reduce`` of a state sharded by ``layout`` (a tree of
    ``distributed.sharding.LeafShards`` in the gradients' structure) over
    ``world``: the sum of the leaves this process owns, summed over the
    world, so that each element counts once and every process gets the one
    scalar."""
    owned = [ls.owned for ls in tree_leaves(layout)]

    def reduce(sq):
        assert len(sq) == len(owned), (len(sq), len(owned))
        mine = [s for s, o in zip(sq, owned) if o]
        total = torch.sum(torch.stack(mine)) if mine else torch.zeros_like(sq[0])
        return world.all_reduce([total])[0]
    return reduce


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: Optional[float] = 1.0,
          master_weights: bool = False,
          sq_norm_reduce: Optional[Callable] = None) -> Optimizer:
    """master_weights=True keeps an fp32 copy in the state — use when params
    are stored bf16 (halves weight traffic; update precision preserved).
    ``sq_norm_reduce``: the clip norm over a sharded state (module
    docstring)."""
    lr_fn = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        master = (tree_map(lambda p: p.detach().float().clone(), params)
                  if master_weights else None)
        device = next(tree_leaves(params)).device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          tree_map(zeros, params), tree_map(zeros, params), master)

    @torch.no_grad()
    def update(grads, state, params):
        step = state.step + 1
        scale = (_clip_scale(global_norm(grads, sq_norm_reduce), clip_norm)
                 if clip_norm is not None else None)
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())
        lr_t = lr_fn(step)
        ref = state.master if master_weights else params

        def leaf(g, m, v, p):
            if scale is not None:
                g = (g.float() * scale).to(g.dtype)
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            return (-lr_t * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()),
                    m, v)

        per_leaf = [leaf(*xs) for xs in zip(*map(tree_leaves, (grads, state.m, state.v, ref)))]
        upd32, m, v = (tree_unflatten(grads, col) for col in zip(*per_leaf))
        if master_weights:
            new_master = tree_map(lambda p, u: p + u, state.master, upd32)
            # "updates" reconstruct bf16 params from the fp32 master
            updates = tree_map(lambda nm, p: nm.to(p.dtype) - p, new_master, params)
            return updates, AdamWState(step, m, v, new_master)
        updates = tree_map(lambda u, p: u.to(p.dtype), upd32, params)
        return updates, AdamWState(step, m, v, None)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)


# ---------------------------------------------------------------------------
# Gradient accumulation (paper §3.4 "combine with memory optimization")
# ---------------------------------------------------------------------------
def accumulate_grads(loss_fn: Callable, params, batches) -> Tuple[torch.Tensor, Any]:
    """Average loss/grads over a leading accumulation axis of ``batches``.
    The leaves of ``params`` must require grad."""
    leaves = list(tree_leaves(params))
    n = next(tree_leaves(batches)).shape[0]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    grad_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    for i in range(n):
        loss = loss_fn(params, tree_map(lambda a: a[i], batches))
        grads = torch.autograd.grad(loss, leaves)
        loss_sum = loss_sum + loss.detach()
        grad_sum = [acc + g for acc, g in zip(grad_sum, grads)]
    inv = 1.0 / n
    return loss_sum * inv, tree_unflatten(params, (s * inv for s in grad_sum))
