"""The plain reference's training steps: the gradient of the mean loss over
the whole batch, accumulated over blocks of rows, then AdamW with
global-norm clipping and a cosine schedule with linear warm-up, all in
float32 with TF32 off.  Returns the readings the benchmark compares with
the program's: each step's loss, each leaf's norm of the clipped first
gradient, and each leaf's norm of the parameters' change after the last
step.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from . import model


def learning_rate(step: int, opt: dict) -> float:
    """The rate of update ``step`` (1 for the first): linear warm-up to
    ``lr``, then a half cosine down to ``min_ratio * lr`` at
    ``total_steps``."""
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    ratio = opt["min_ratio"]
    return lr * (ratio + (1 - ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


def _sq(t: torch.Tensor) -> float:
    return float(torch.sum(t.double() * t.double()))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, m: dict, v: dict, step: int, opt: dict) -> dict:
    """AdamW update number ``step`` (1 for the first) of ``params`` in place,
    the gradients clipped to a global norm of ``clip_norm`` first and
    consumed leaf by leaf; decoupled weight decay on every leaf.  Returns
    each leaf's norm of its clipped gradient."""
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    norm = math.sqrt(sum(_sq(g) for g in grads.values()))
    scale = min(opt["clip_norm"] / max(norm, 1e-9), 1.0)
    lr = learning_rate(step, opt)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    clipped = {}
    for p in list(grads):
        g = grads.pop(p) * scale
        clipped[p] = math.sqrt(_sq(g))
        m[p].mul_(b1).add_(g, alpha=1 - b1)
        v[p].mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m[p] / bc1) / (torch.sqrt(v[p] / bc2) + eps) + wd * params[p]
        params[p].sub_(lr * upd)
        del g, upd
    return clipped


def train_readings(cfg: dict, weights, batches: List[dict], opt: dict, *, steps: int = 3,
                   row_block: int = 1, remat: bool = True, mm: Callable = torch.matmul,
                   rows: Optional[int] = None,
                   on_grads: Optional[Callable[[dict], None]] = None) -> Dict[str, object]:
    """``steps`` training steps of the reference from ``weights.all()``
    (``path -> float32 tensor``) on ``batches[i]`` (``tokens``,
    ``labels``: (B, S)), ``row_block`` rows at a time, each layer
    recomputed in the backward pass if ``remat``.  ``mm`` computes
    every product; ``rows`` keeps only the first ``rows`` rows of each
    batch (the mean is then over those); ``on_grads`` may change each
    step's gradients in place before the update.  The parameters' change is taken
    against ``weights.leaf(path)``, made again leaf by leaf."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(cfg, weights, batches, opt, steps, row_block, remat, mm, rows, on_grads)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _train(cfg, weights, batches, opt, steps, row_block, remat, mm, rows, on_grads):
    params = {p: t.requires_grad_(True) for p, t in weights.all().items()}
    paths = list(params)
    m = {p: torch.zeros_like(t) for p, t in params.items()}
    v = {p: torch.zeros_like(t) for p, t in params.items()}
    losses, first_grad = [], {}
    for step in range(1, steps + 1):
        tokens, labels = batches[step - 1]["tokens"], batches[step - 1]["labels"]
        if rows is not None:
            tokens, labels = tokens[:rows], labels[:rows]
        count = tokens.numel()
        grads = {p: torch.zeros_like(t) for p, t in params.items()}
        total = 0.0
        for r0 in range(0, tokens.shape[0], row_block):
            loss = model.loss_sum(params, cfg, tokens[r0:r0 + row_block],
                                  labels[r0:r0 + row_block], mm, remat) / count
            for p, g in zip(paths, torch.autograd.grad(loss, [params[p] for p in paths])):
                grads[p] += g
            total += float(loss.detach())
        losses.append(total)
        if on_grads is not None:
            on_grads(grads)
        clipped = adamw_update(params, grads, m, v, step, opt)
        if step == 1:
            first_grad = clipped
    del m, v
    change = {}
    with torch.no_grad():
        for p in paths:
            change[p] = math.sqrt(_sq(params[p] - weights.leaf(p)))
    return {"loss": losses, "grad_norm": first_grad, "change_norm": change}
