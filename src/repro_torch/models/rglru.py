"""RecurrentGemma / Griffin hybrid blocks: the RG-LRU recurrent block
(reference: ``repro/models/rglru.py``); local attention, the third block of
the repeating (rec, rec, attn) pattern, is ``models/attention.py`` with a
window.

The RG-LRU recurrence h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * x_t) is a
linear scan, and its state is carried across TeraPipe slices, so slicing is
exact (as for the SSM family).

What differs from the reference, and why the result does not: the
reference's ``jax.lax.associative_scan`` is a log-depth doubling scan on
whole tensors here (:func:`_rglru_scan`): ceil(log2 L) steps, each a few
elementwise ops over ``(B, L, D)``, out of place.  Neither a Python loop over
tokens (thousands of launches per block at 2048 tokens) nor a closed form
through the cumulative product of ``a`` (which underflows float32 within a
few dozen tokens, at ``log a ≈ -7.8 r`` per step, and would be divided by).
Manual tensor parallelism (``cfg.tp_axis``) raises (:func:`check_no_tp`):
the reference's rec block cannot run under it (ROADMAP Queue 3).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init, rms_norm
from .ssm import _causal_conv

_C = 8.0  # RG-LRU temperature constant (Griffin paper)


def check_no_tp(cfg: ModelConfig) -> None:
    """The rec block refuses tensor parallelism: its gates ``w_a`` and
    ``w_i`` are specced ``("embed", "ff")``, so TP shards their output dim,
    but they are applied to the branch ``xf``, which is already sharded
    over ``ff``: the contraction's two sides differ (the reference raises a
    ``dot_general`` shape error at tp 2)."""
    if cfg.tp_axis is not None:
        raise NotImplementedError(
            "rec block under tensor parallelism (cfg.tp_axis): w_a and w_i ('embed', 'ff') "
            "contract the ff-sharded branch xf over the full width, so no TP layout of the "
            "reference's specs computes it (the reference's fault at tp 2: dot_general "
            "contracting dimensions differ; ROADMAP Queue 3)")


def init_rec_block(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=gen.device)
    return {
        "ln": zeros(),
        "w_x": dense_init(gen, (d, d)),          # recurrent branch in-proj
        "w_y": dense_init(gen, (d, d)),          # gate branch
        "conv_w": dense_init(gen, (cfg.rglru_conv, d)) * 0.1,
        "conv_b": zeros(),
        "w_a": dense_init(gen, (d, d)),          # recurrence gate r_t
        "b_a": zeros(),
        "w_i": dense_init(gen, (d, d)),          # input gate i_t
        "b_i": zeros(),
        "lam": torch.full((d,), 0.5, dtype=torch.float32, device=gen.device),  # Λ
        "w_out": dense_init(gen, (d, d)),
    }


def rec_block_specs(cfg: ModelConfig):
    """The logical axes of :func:`init_rec_block`'s leaves."""
    return {"ln": (None,), "w_x": ("embed", "ff"), "w_y": ("embed", "ff"),
            "conv_w": (None, "ff"), "conv_b": ("ff",), "w_a": ("embed", "ff"),
            "b_a": ("ff",), "w_i": ("embed", "ff"), "b_i": ("ff",), "lam": ("ff",),
            "w_out": ("ff", "embed")}


def _rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]):
    """h_t = a_t h_{t-1} + b_t over axis 1.  a, b: (B, L, D); h0: (B, D)|None.

    Hillis-Steele doubling: after the step of stride k, position t holds the
    composition of the (up to) 2k maps ending at t, ``(prod a, h from zero)``;
    after the last, ``b`` is the scan from zero and ``a`` the product of every
    ``a_s`` up to t, which carries ``h0`` in."""
    L = a.shape[1]
    k = 1
    while k < L:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    return b if h0 is None else a * h0[:, None, :] + b


def rec_block(p, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Full/sliced forward.  x (b, L, d); state = (conv_state, h0) | None."""
    check_no_tp(cfg)
    h = rms_norm(x, p["ln"])
    xr = h @ p["w_x"].to(h.dtype)
    gate = F.gelu(h @ p["w_y"].to(h.dtype), approximate="tanh")   # jax.nn.gelu's default
    conv_state = None if state is None else state[0]
    h0 = None if state is None else state[1]
    xr, new_conv = _causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    xf = xr.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])     # float32, as JAX promotes
    i = torch.sigmoid(xf @ p["w_i"].float() + p["b_i"])
    log_a = -_C * F.softplus(p["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    hs = _rglru_scan(a, b, None if h0 is None else h0.float())
    new_h = hs[:, -1, :]
    y = (hs.to(x.dtype) * gate) @ p["w_out"].to(x.dtype)
    return x + y, (new_conv, new_h)


def rec_block_decode(p, cfg: ModelConfig, x_tok: torch.Tensor, state):
    """Single-token step.  x_tok (b, 1, d); state = (conv_state, h)."""
    return rec_block(p, cfg, x_tok, state)


def init_rec_state(cfg: ModelConfig, batch: int, n_layers: int, device=None):
    """Zero ``(conv, h)`` states of ``n_layers`` blocks, float32."""
    conv = torch.zeros((n_layers, batch, cfg.rglru_conv - 1, cfg.d_model),
                       dtype=torch.float32, device=device)
    h = torch.zeros((n_layers, batch, cfg.d_model), dtype=torch.float32, device=device)
    return conv, h
