"""Dense transformer block: pre-RMSNorm attention + SwiGLU FFN (reference:
``repro/models/layers.py``), in the full, sliced, sliced_dyn and decode
modes of :mod:`repro_torch.models.attention`.  Under tensor parallelism
(``cfg.tp_axis`` a group) a block's ``p`` and cache are the hosted ranks'
lists (``models/common.py``): the attention and the FFN each reduce their
partial outputs once, the norms run once on the replicated activation.
The serving modes (sliced, decode) take no tensor parallelism."""
from __future__ import annotations

import torch

from . import attention as attn_mod
from .common import (ModelConfig, dense_init, per_rank, replicated, rms_norm, shards, swiglu,
                     tp_group)


def init_ffn(gen: torch.Generator, cfg: ModelConfig, d_ff: int = 0):
    d_ff = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (cfg.d_model, d_ff)),
        "w_up": dense_init(gen, (cfg.d_model, d_ff)),
        "w_down": dense_init(gen, (d_ff, cfg.d_model)),
    }


def ffn_specs(cfg: ModelConfig):
    """The logical axes of :func:`init_ffn`'s leaves."""
    return {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"), "w_down": ("ff", "embed")}


def _ffn_partial(p, x: torch.Tensor) -> torch.Tensor:
    h = swiglu(x @ p["w_gate"].to(x.dtype), x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)


def ffn(p, x: torch.Tensor, tp_axis=None) -> torch.Tensor:
    """SwiGLU FFN: each hosted rank's partial output (``p`` a dict, or
    under ``tp_axis``, a group, the hosted ranks' column/row shards of
    ``ff``), summed over the axis (the reference's ``psum``)."""
    group = tp_group(tp_axis)
    return group.all_reduce([_ffn_partial(p_r, x_r)
                             for p_r, x_r in zip(shards(p), group.region(x))])[0]


def init_dense_block(gen: torch.Generator, cfg: ModelConfig):
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)
    return {
        "attn": attn_mod.init_attn(gen, cfg),
        "ffn": init_ffn(gen, cfg),
        "ln_attn": zeros(),
        "ln_ffn": zeros(),
    }


def dense_block_specs(cfg: ModelConfig):
    """The logical axes of :func:`init_dense_block`'s leaves."""
    return {"attn": attn_mod.attn_specs(cfg), "ffn": ffn_specs(cfg),
            "ln_attn": (None,), "ln_ffn": (None,)}


def dense_block_full(p, cfg: ModelConfig, x: torch.Tensor, *, causal: bool = True,
                     window: int = 0) -> torch.Tensor:
    x = x + attn_mod.attn_full(per_rank(p, "attn"), cfg, rms_norm(x, replicated(p, "ln_attn")),
                               causal=causal, window=window)
    x = x + ffn(per_rank(p, "ffn"), rms_norm(x, replicated(p, "ln_ffn")), cfg.tp_axis)
    return x


def dense_block_sliced(p, cfg: ModelConfig, x: torch.Tensor, kv_cache, ctx_len: int,
                       *, window: int = 0):
    a, kv_cache = attn_mod.attn_sliced(p["attn"], cfg, rms_norm(x, p["ln_attn"]),
                                       kv_cache, ctx_len, window=window)
    x = x + a
    x = x + ffn(p["ffn"], rms_norm(x, p["ln_ffn"]))
    return x, kv_cache


def dense_block_sliced_dyn(p, cfg: ModelConfig, x: torch.Tensor, kv_cache, ctx,
                           *, window: int = 0):
    """Variant with a context offset that is data (the lockstep pipeline)."""
    a, kv_cache = attn_mod.attn_sliced_dyn(per_rank(p, "attn"), cfg,
                                           rms_norm(x, replicated(p, "ln_attn")),
                                           kv_cache, ctx, window=window)
    x = x + a
    x = x + ffn(per_rank(p, "ffn"), rms_norm(x, replicated(p, "ln_ffn")), cfg.tp_axis)
    return x, kv_cache


def dense_block_decode(p, cfg: ModelConfig, x: torch.Tensor, kv_cache, pos,
                       *, window: int = 0, ring: bool = False):
    a, kv_cache = attn_mod.attn_decode(p["attn"], cfg, rms_norm(x, p["ln_attn"]),
                                       kv_cache, pos, window=window, ring=ring)
    x = x + a
    x = x + ffn(p["ffn"], rms_norm(x, p["ln_ffn"]))
    return x, kv_cache
