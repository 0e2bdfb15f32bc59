"""Model assembly, dense decoder family (reference: ``repro/models/lm.py``).

A model is a stack of *block groups*: homogeneous runs of layers whose
per-layer parameters are stacked on a leading axis (``_stack_init``).  The
reference's ``lax.scan`` over that axis is a Python loop over the layer
index here; there is no ``jit`` — the port runs eagerly.

Ported: the dense group's ``sliced`` and ``decode`` modes and the serving
surface of ``build_model`` (``init``, ``embed``, ``head``, ``init_caches``,
``prefill``, ``decode_step``).  The training surface (``forward``, ``loss``,
``chunked_xent``) and the other families arrive with later slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import torch

from repro_torch.device import resolve_device

from . import layers as layers_mod
from .common import ModelConfig, embed_init, rms_norm

Params = Dict[str, Any]


class BlockGroup(NamedTuple):
    name: str            # key into params["groups"][name]
    count: int           # number of stacked blocks in this group
    sliced: Callable     # (bp, x, cache, ctx:int) -> (x, cache)
    decode: Callable     # (bp, x, cache, pos) -> (x, cache)
    init_cache: Callable # (batch, max_len, dtype) -> stacked (k, v)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter dict (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _scan(step: Callable, count: int, bp, x, cache, arg):
    """The reference's ``lax.scan`` over stacked layers (``_scan_sliced`` /
    ``_scan_decode``): layer ``i`` gets its parameter and cache views and
    writes its K/V into the stacked cache in place."""
    ck, cv = cache
    for i in range(count):
        x, _ = step(_layer(bp, i), x, (ck[i], cv[i]), arg)
    return x, cache


def apply_groups_sliced(model: "Model", params, x, caches, ctx: int):
    """Run every group at context offset ``ctx``; caches are updated in
    place (each layer writes its slice's K/V into its cache rows)."""
    return _apply_groups(model, params, x, caches, ctx, "sliced")


def apply_groups_decode(model: "Model", params, x, caches, pos):
    """Run every group on one token per row at ``pos``; caches in place."""
    return _apply_groups(model, params, x, caches, pos, "decode")


def _apply_groups(model: "Model", params, x, caches, arg, mode: str):
    new = []
    for g, c in zip(model.groups, caches):
        x, c = _scan(getattr(g, mode), g.count, params["groups"][g.name], x, c, arg)
        new.append(c)
    return x, new


def _stack_init(init_one: Callable, gen: torch.Generator, count: int):
    """Per-layer leaves stacked on a leading ``count`` axis."""
    layers = [init_one(gen) for _ in range(count)]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return torch.stack(items)
    return stack(layers)


def _make_dense_group(cfg: ModelConfig, name: str, count: int, device):
    def sliced(bp, x, cache, ctx):
        return layers_mod.dense_block_sliced(bp, cfg, x, cache, ctx)

    def decode(bp, x, cache, pos):
        return layers_mod.dense_block_decode(bp, cfg, x, cache, pos)

    def init_cache(batch, max_len, dtype=torch.bfloat16):
        shape = (count, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    def init_params(gen):
        return _stack_init(lambda g: layers_mod.init_dense_block(g, cfg), gen, count)

    return BlockGroup(name, count, sliced, decode, init_cache), init_params


class Model(torch.nn.Module):
    """The decoder: block groups plus embedding and head.  Parameters live
    outside the module as the reference's nested dict (``init``), so the
    JAX package's parameters convert leaf by leaf
    (:func:`repro_torch.weights.params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"family {cfg.family!r}: not yet ported")
        self.cfg = cfg
        self.device = device
        group, self._init_group = _make_dense_group(cfg, "blocks", cfg.n_layers, device)
        self.groups: List[BlockGroup] = [group]

    @property
    def n_blocks(self) -> int:
        return sum(g.count for g in self.groups)

    def init(self, seed: int) -> Params:
        """Random parameters from a ``torch.Generator`` seeded with ``seed``
        on the model's device (same distributions as the reference)."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params: Params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model)),
                          "groups": {"blocks": self._init_group(gen)}}
        params["final_ln"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                         device=self.device)
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size))
        return params

    def _head_weight(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def embed(self, params, batch, ctx: int = 0) -> torch.Tensor:
        # gather, then cast: the same values as the reference's cast-then-gather
        return params["embed"][batch["tokens"].long()].to(self.cfg.dtype)

    def head(self, params, x) -> torch.Tensor:
        x = rms_norm(x, params["final_ln"])
        return (x @ self._head_weight(params).to(x.dtype)).float()

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return [g.init_cache(batch, max_len, dtype) for g in self.groups]

    def prefill(self, params, batch, max_len: int):
        caches = self.init_caches(batch["tokens"].shape[0], max_len, dtype=self.cfg.dtype)
        x = self.embed(params, batch, 0)
        x, caches = apply_groups_sliced(self, params, x, caches, 0)
        return self.head(params, x[:, -1:, :]), caches

    def decode_step(self, params, caches, batch, pos):
        """One token per row at ``pos`` (scalar or per-row (B,)); the caches
        are updated in place and returned."""
        x = self.embed(params, batch, ctx=1)
        x, caches = apply_groups_decode(self, params, x, caches, pos)
        return self.head(params, x), caches

    def forward(self, params, batch):
        raise NotImplementedError("the training forward arrives with the training slice")

    def loss(self, params, batch):
        raise NotImplementedError("the LM loss arrives with the training slice")


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """Build the model on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"`` is asked for)."""
    return Model(cfg, resolve_device(device))
