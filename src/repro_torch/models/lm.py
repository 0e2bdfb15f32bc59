"""Model assembly: every architecture family behind one API (reference:
``repro/models/lm.py``).

A model is a stack of *block groups*: homogeneous runs of layers whose
per-layer parameters are stacked on a leading axis (``_stack_init``).  The
reference's ``lax.scan`` over that axis is a Python loop over the layer
index here; there is no ``jit`` — the port runs eagerly.  ``jax.checkpoint``
is ``torch.utils.checkpoint`` (non-reentrant): under ``cfg.remat`` each
layer keeps only its input for the backward pass and recomputes the rest;
``cfg.remat_policy="dots"`` also keeps the outputs of its plain matrix
products (``_remat``).

The families: dense, vlm (the dense stack behind a prefix of patch
embeddings at ``ctx == 0``, the loss over the text positions only), MoE
(DeepSeek's first dense layer ``dense0`` before the ``moe`` group), SSM
(mamba2), hybrid (RecurrentGemma's ``super`` blocks of (rec, rec, windowed
attn), then the ``tail`` of rec blocks), each group in the ``full``,
``sliced``, ``sliced_dyn`` and ``decode`` modes, with the training surface
(``forward``, ``loss``, ``head_loss``, ``chunked_xent``) and the serving
surface (``init``, ``embed``, ``head``, ``init_caches``, ``prefill``,
``decode_step``) of :class:`Model`, and ``specs``, the logical axes of
``init``'s leaves that the reference's ``init`` returns beside them; and
the encoder-decoder
(:class:`EncDecModel`, whisper's backbone): a bidirectional ``enc`` group,
not token-sliceable, and a ``dec`` group whose blocks carry the stacked
encoder K/V beside the activation.

A group's cache is a tree of tensors stacked on a leading layer axis: the
``(k, v)`` KV cache, the ``(conv, ssm)`` or ``(conv, h)`` recurrent state
(float32 whatever the activation dtype), or the super-block's
``((rec_conv, rec_h), (k, v))``.  The SSM and rec groups have no separate
``sliced_dyn``: ``ctx`` is unused there, so it is ``sliced`` (the
reference's executor falls back to ``sliced`` the same way).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_unflatten

from . import attention as attn_mod
from . import layers as layers_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import ModelConfig, embed_init, make_generator, per_rank, replicated, rms_norm

Params = Dict[str, Any]


class BlockGroup(NamedTuple):
    name: str            # key into params["groups"][name]
    count: int           # number of stacked blocks in this group
    full: Callable       # (bp, x) -> x
    sliced: Callable     # (bp, x, cache, ctx:int) -> (x, cache)
    decode: Callable     # (bp, x, cache, pos) -> (x, cache)
    init_cache: Callable # (batch, max_len, dtype, mode, layers=count) -> stacked cache tree
    sliced_dyn: Optional[Callable]  # like sliced, ctx may be a 0-d tensor; caches
    #                                 out of place under grad; None: not pipelined
    causal: bool = True  # token-sliceable (False: an encoder-style group)


def _unstack(tree) -> List[Any]:
    """The per-layer parameter dicts of a stacked tree (views, no copies).
    One ``unbind`` per leaf, so the backward pass stacks each leaf's
    gradient once rather than scattering every layer's into a full-size
    zero tensor."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v) for k, v in tree.items()}
        return [dict(zip(per_key, layer)) for layer in zip(*per_key.values())]
    if isinstance(tree, list):       # the hosted tp ranks' stacks: per layer, their list
        return [list(layer) for layer in zip(*(_unstack(t) for t in tree))]
    return list(torch.unbind(tree))


#: the products ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
#: keeps: plain ``x @ w`` matrix products (a (B, S, D) activation times a
#: weight folds to one ``mm``; the port has no biases, so no ``addmm``).
#: Batched products (``bmm``: the attention scores) and everything else,
#: the kernels' autograd Function included, run again in the backward pass.
_DOTS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body: Callable, cfg: Optional[ModelConfig] = None) -> Callable:
    """``jax.checkpoint`` of the reference (``lm.py:74-79``) as non-reentrant
    ``torch.utils.checkpoint``: the body keeps only its inputs for the
    backward pass and runs again there to rebuild the rest.  With
    ``cfg.remat_policy == "dots"`` it also keeps every plain matrix
    product's output (``_DOTS``), which the backward pass then reads in
    place of recomputing it.  Without ``cfg`` (the pipeline's stages and
    its pre- and post-groups, as in the reference) the policy does not
    apply."""
    if cfg is not None and cfg.remat_policy == "dots":
        dots = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *args: checkpoint(body, *args, use_reentrant=False, context_fn=dots)
    return lambda *args: checkpoint(body, *args, use_reentrant=False)


def _scan_full(group: BlockGroup, bp, x, remat: bool, cfg: Optional[ModelConfig] = None):
    body = _remat(group.full, cfg) if remat else group.full
    for bp_l in _unstack(bp):
        x = body(bp_l, x)
    return x


def _scan(step: Callable, bp, x, cache, arg):
    """The reference's ``lax.scan`` over stacked layers (``_scan_sliced`` /
    ``_scan_decode``): layer ``i`` gets its parameter views and row ``i``
    of every cache leaf, and returns its new cache.  A leaf the layer wrote
    in place (a KV cache: the same view comes back) needs nothing more.  A
    new leaf (a recurrent state) goes into row ``i``: in place while
    autograd is off, and under grad into a new stacked tensor, so that no
    tensor saved for the backward pass is overwritten."""
    leaves = list(tree_leaves(cache))
    rows = [[] for _ in leaves]
    for i, bp_l in enumerate(_unstack(bp)):
        old = [a[i] for a in leaves]
        x, new = step(bp_l, x, tree_unflatten(cache, old), arg)
        for j, (o, n) in enumerate(zip(old, tree_leaves(new))):
            if n is not o and not torch.is_grad_enabled():
                o.copy_(n)
            rows[j].append(n)
    if torch.is_grad_enabled():
        leaves = [a if all(n is o for n, o in zip(r, a)) else torch.stack(r)
                  for a, r in zip(leaves, rows)]
        cache = tree_unflatten(cache, leaves)
    return x, cache


def apply_groups_full(model: "Model", params, x):
    """The training forward of every group, layer by layer, each layer
    under ``torch.utils.checkpoint`` when ``cfg.remat``."""
    for g in model.groups:
        x = _scan_full(g, params["groups"][g.name], x, model.cfg.remat, model.cfg)
    return x


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
        x, c = _scan(getattr(g, mode), params["groups"][g.name], x, c, arg)
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


def _stack_specs(spec_one):
    """One layer's logical axes with the stacked layer axis (no logical
    axis: ``None``) in front of each leaf's (reference ``_stack_init``)."""
    if isinstance(spec_one, dict):
        return {k: _stack_specs(v) for k, v in spec_one.items()}
    return (None,) + tuple(spec_one)


def _xent_chunk(xc, w_head, lc):
    logits = (xc @ w_head.to(xc.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_xent(x: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Mean token cross-entropy that never holds (B, S, V) logits: a loop
    over sequence chunks, each under ``checkpoint`` (its logits are
    recomputed in the backward), summed in float32 in chunk order."""
    b, s, _ = x.shape
    if s % chunk != 0:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + checkpoint(_xent_chunk, x[:, c0:c0 + chunk], w_head,
                                   labels[:, c0:c0 + chunk], use_reentrant=False)
    return total / (b * s)


def _dense_like_groups(cfg: ModelConfig) -> List[Tuple[str, int, str]]:
    """``[(group_name, count, kind)]`` of a decoder's block stack (reference
    ``lm.py:173-194``); the enc-dec family builds its own
    (:class:`EncDecModel`)."""
    if cfg.family in ("dense", "vlm"):
        return [("blocks", cfg.n_layers, "dense")]
    if cfg.family == "moe":
        first_dense = 1 if cfg.n_shared_experts else 0   # deepseek convention
        gs = [("dense0", first_dense, "dense")] if first_dense else []
        gs.append(("moe", cfg.n_layers - first_dense, "moe"))
        return gs
    if cfg.family == "ssm":
        return [("blocks", cfg.n_layers, "ssm")]
    if cfg.family == "hybrid":
        pat = len(cfg.block_pattern)           # (rec, rec, attn)
        n_super = cfg.n_layers // pat
        tail = cfg.n_layers - n_super * pat
        gs = [("super", n_super, "super")]
        if tail:
            gs.append(("tail", tail, "rec"))
        return gs
    raise ValueError(cfg.family)


def _kv_zeros(cfg: ModelConfig, layers: int, batch: int, length: int, dtype, device):
    shape = (layers, batch, length, cfg.n_kv_heads, cfg.hd)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _kv_cache_init(cfg: ModelConfig, count: int, device) -> Callable:
    def init_cache(batch, max_len, dtype=torch.bfloat16, mode="sliced", layers=count):
        return _kv_zeros(cfg, layers, batch, max_len, dtype, device)
    return init_cache


def _make_dense_group(cfg: ModelConfig, name: str, count: int, device):
    def full(bp, x):
        return layers_mod.dense_block_full(bp, cfg, x)

    def sliced(bp, x, cache, ctx):
        return layers_mod.dense_block_sliced(bp, cfg, x, cache, ctx)

    def sliced_dyn(bp, x, cache, ctx):
        return layers_mod.dense_block_sliced_dyn(bp, cfg, x, cache, ctx)

    def decode(bp, x, cache, pos):
        return layers_mod.dense_block_decode(bp, cfg, x, cache, pos)

    def init_params(gen):
        return _stack_init(lambda g: layers_mod.init_dense_block(g, cfg), gen, count)

    return (BlockGroup(name, count, full, sliced, decode, _kv_cache_init(cfg, count, device),
                       sliced_dyn), init_params,
            _stack_specs(layers_mod.dense_block_specs(cfg)))


def _make_moe_group(cfg: ModelConfig, name: str, count: int, device):
    """Pre-norm attention, then the MoE FFN (reference ``lm.py:222-267``);
    under tensor parallelism ``bp`` is the hosted ranks' list of shards."""
    def init_one(gen):
        zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)
        return {"attn": attn_mod.init_attn(gen, cfg), "moe": moe_mod.init_moe(gen, cfg),
                "ln_attn": zeros(), "ln_ffn": zeros()}

    def ffn(bp, x):
        return x + moe_mod.moe_ffn(per_rank(bp, "moe"), cfg,
                                   rms_norm(x, replicated(bp, "ln_ffn")))

    def attn_in(bp, x):
        return per_rank(bp, "attn"), cfg, rms_norm(x, replicated(bp, "ln_attn"))

    def full(bp, x):
        x = x + attn_mod.attn_full(*attn_in(bp, x))
        return ffn(bp, x)

    def with_cache(attn_fn):
        def block(bp, x, cache, arg):
            a, cache = attn_fn(*attn_in(bp, x), cache, arg)
            return ffn(bp, x + a), cache
        return block

    def init_params(gen):
        return _stack_init(init_one, gen, count)

    specs = {"attn": attn_mod.attn_specs(cfg), "moe": moe_mod.moe_specs(cfg),
             "ln_attn": (None,), "ln_ffn": (None,)}
    return (BlockGroup(name, count, full, with_cache(attn_mod.attn_sliced),
                       with_cache(attn_mod.attn_decode), _kv_cache_init(cfg, count, device),
                       with_cache(attn_mod.attn_sliced_dyn)), init_params,
            _stack_specs(specs))


def _make_state_group(cfg: ModelConfig, name: str, count: int, device, *, block, step,
                      init_state, init_block, block_specs, check_no_tp):
    """Recurrent blocks whose cache is the state they carry, f32 whatever
    ``dtype``: Mamba-2 (``(conv, ssm)``, reference ``lm.py:270-288``) or
    RG-LRU, the hybrid's tail (``(conv, h)``, ``lm.py:291-307``).  ``block``
    runs a slice from a state (``None``: zeros), ``step`` one token.  Both
    refuse tensor parallelism when the group is built (``check_no_tp``)."""
    check_no_tp(cfg)
    def full(bp, x):
        return block(bp, cfg, x, None)[0]

    def sliced(bp, x, cache, ctx):
        return block(bp, cfg, x, cache)

    def decode(bp, x, cache, pos):
        return step(bp, cfg, x, cache)

    def init_cache(batch, max_len, dtype=torch.bfloat16, mode="sliced", layers=count):
        return init_state(cfg, batch, layers, device)

    def init_params(gen):
        return _stack_init(lambda g: init_block(g, cfg), gen, count)

    return (BlockGroup(name, count, full, sliced, decode, init_cache, sliced), init_params,
            _stack_specs(block_specs(cfg)))


def _make_super_group(cfg: ModelConfig, name: str, count: int, device):
    """RecurrentGemma super-block: (rec, rec, attn-with-window) (reference
    ``lm.py:310-377``).  Its cache is ``((rec_conv, rec_h), (k, v))``, the
    rec states stacked over the block's rec layers; the decode writes K/V
    into a ring (``ring=True``), of ``min(max_len, window)`` rows when
    ``init_cache`` is asked for ``mode="decode"``."""
    rglru_mod.check_no_tp(cfg)
    n_rec = sum(1 for b in cfg.block_pattern if b == "rec")
    w = cfg.window

    def init_one(gen):
        p = {f"rec{i}": rglru_mod.init_rec_block(gen, cfg) for i in range(n_rec)}
        p["attn"] = layers_mod.init_dense_block(gen, cfg)
        return p

    def full(bp, x):
        for i in range(n_rec):
            x, _ = rglru_mod.rec_block(bp[f"rec{i}"], cfg, x, None)
        return layers_mod.dense_block_full(bp["attn"], cfg, x, window=w)

    def with_cache(rec_fn, attn_fn, **attn_kw):
        def block(bp, x, cache, arg):
            (rec_conv, rec_h), kv = cache
            new = []
            for i in range(n_rec):
                x, c = rec_fn(bp[f"rec{i}"], cfg, x, (rec_conv[i], rec_h[i]))
                new.append(c)
            x, kv = attn_fn(bp["attn"], cfg, x, kv, arg, window=w, **attn_kw)
            rec = (torch.stack([c[0] for c in new]), torch.stack([c[1] for c in new]))
            return x, (rec, kv)
        return block

    def init_cache(batch, max_len, dtype=torch.bfloat16, mode="sliced", layers=count):
        # materialised per layer (the reference broadcasts one zero block):
        # an expanded view would alias every layer's rows, which the
        # in-place cache writes would then share
        rec_conv, rec_h = rglru_mod.init_rec_state(cfg, batch, layers * n_rec, device)
        rec = (rec_conv.reshape(layers, n_rec, *rec_conv.shape[1:]),
               rec_h.reshape(layers, n_rec, *rec_h.shape[1:]))
        kv_len = min(max_len, w) if mode == "decode" else max_len
        return rec, _kv_zeros(cfg, layers, batch, kv_len, dtype, device)

    def init_params(gen):
        return _stack_init(init_one, gen, count)

    specs = {f"rec{i}": rglru_mod.rec_block_specs(cfg) for i in range(n_rec)}
    specs["attn"] = layers_mod.dense_block_specs(cfg)
    return (BlockGroup(name, count, full,
                       with_cache(rglru_mod.rec_block, layers_mod.dense_block_sliced),
                       with_cache(rglru_mod.rec_block_decode, layers_mod.dense_block_decode,
                                  ring=True),
                       init_cache,
                       with_cache(rglru_mod.rec_block, layers_mod.dense_block_sliced_dyn)),
            init_params, _stack_specs(specs))


_GROUP_MAKERS = {
    "dense": _make_dense_group,
    "moe": _make_moe_group,
    "ssm": functools.partial(_make_state_group, block=ssm_mod.mamba2_block,
                             step=ssm_mod.mamba2_decode, init_state=ssm_mod.init_ssm_state,
                             init_block=ssm_mod.init_mamba2, block_specs=ssm_mod.mamba2_specs,
                             check_no_tp=ssm_mod.check_no_tp),
    "rec": functools.partial(_make_state_group, block=rglru_mod.rec_block,
                             step=rglru_mod.rec_block_decode,
                             init_state=rglru_mod.init_rec_state,
                             init_block=rglru_mod.init_rec_block,
                             block_specs=rglru_mod.rec_block_specs,
                             check_no_tp=rglru_mod.check_no_tp),
    "super": _make_super_group,
}


class Model(torch.nn.Module):
    """The decoder: block groups plus embedding and head.  Parameters live
    outside the module as the reference's nested dict (``init``), so the
    JAX package's parameters convert leaf by leaf
    (:func:`repro_torch.weights.params_from_jax`); their logical axes are
    a tree of the same keys (``specs``).  On the ``meta`` device ``init``
    gives every leaf's shape and dtype without storage
    (``launch/steps.py::abstract_init``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.groups: List[BlockGroup] = []
        self._init_groups: Dict[str, Callable] = {}
        self._group_specs: Dict[str, Any] = {}
        for group, init, specs in self._make_groups():
            self.groups.append(group)
            self._init_groups[group.name] = init
            self._group_specs[group.name] = specs

    def _make_groups(self) -> List[Tuple[BlockGroup, Callable, Any]]:
        """``[(group, init_params, specs)]`` of the block stack, in order."""
        return [_GROUP_MAKERS[kind](self.cfg, name, count, self.device)
                for name, count, kind in _dense_like_groups(self.cfg)]

    @property
    def n_blocks(self) -> int:
        return sum(g.count for g in self.groups)

    def init(self, seed: int) -> Params:
        """Random parameters from a ``torch.Generator`` seeded with ``seed``
        on the model's device (same distributions as the reference), drawn
        in the reference's order: the embedding, each group in stack order,
        the head."""
        cfg = self.cfg
        gen = make_generator(self.device, seed)
        params: Params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model))}
        params["groups"] = {name: init(gen) for name, init in self._init_groups.items()}
        params["final_ln"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                         device=self.device)
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size))
        return params

    def specs(self) -> Params:
        """The logical axes of every leaf of ``init``'s tree, the tree the
        reference's ``init`` returns beside its parameters: per leaf a
        tuple of axis names (``"embed"``, ``"heads"``, ``"ff"``, ...) or
        ``None`` per dimension; stacked layers lead with ``None``.  Drawn
        from ``cfg`` alone."""
        specs: Params = {"embed": ("vocab", "embed"), "groups": dict(self._group_specs),
                         "final_ln": (None,)}
        if not self.cfg.tie_embeddings:
            specs["lm_head"] = ("embed", "vocab")
        return specs

    def _head_weight(self, params):
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def embed(self, params, batch, ctx: int = 0) -> torch.Tensor:
        """The tokens' embeddings; for the vlm family at ``ctx == 0`` the
        batch's ``patch_embeds`` (B, n_patches, D) come first (the stubbed
        image frontend's output), so the sequence is patches + text."""
        # gather, then cast: the same values as the reference's cast-then-gather
        x = params["embed"][batch["tokens"].long()].to(self.cfg.dtype)
        if self.cfg.family == "vlm" and ctx == 0:
            x = torch.cat([batch["patch_embeds"].to(self.cfg.dtype), x], dim=1)
        return x

    def head(self, params, x) -> torch.Tensor:
        x = rms_norm(x, params["final_ln"])
        return (x @ self._head_weight(params).to(x.dtype)).float()

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    mode: str = "sliced"):
        """Every group's zero cache.  ``mode="decode"`` sizes the hybrid's
        KV ring to ``min(max_len, window)``; recurrent states are float32
        whatever ``dtype``."""
        return [g.init_cache(batch, max_len, dtype, mode=mode) for g in self.groups]

    def prefill(self, params, batch, max_len: int):
        caches = self.init_caches(batch["tokens"].shape[0], max_len, dtype=self.cfg.dtype)
        x = self.embed(params, batch, 0)
        x, caches = apply_groups_sliced(self, params, x, caches, 0)
        return self.head(params, x[:, -1:, :]), caches

    def decode_step(self, params, caches, batch, pos):
        """One token per row at ``pos`` (scalar or per-row (B,); the hybrid's
        ring takes a scalar); the caches are updated in place and
        returned."""
        x = self.embed(params, batch, ctx=1)      # ctx != 0: no vlm prefix
        x, caches = apply_groups_decode(self, params, x, caches, pos)
        return self.head(params, x), caches

    def forward(self, params, batch) -> torch.Tensor:
        """Float32 logits (B, S, V) of the whole sequence (vlm: patches +
        text)."""
        x = self.embed(params, batch, 0)
        x = apply_groups_full(self, params, x)
        return self.head(params, x)

    def head_loss(self, params, x, labels) -> torch.Tensor:
        """Final norm + chunked LM loss of the stack's output ``x``; for the
        vlm family over the text positions only (the first ``n_patches``
        rows are stripped), so ``labels`` are text-length."""
        x = rms_norm(x, params["final_ln"])
        if self.cfg.family == "vlm":
            x = x[:, self.cfg.n_patches:]
        return chunked_xent(x, self._head_weight(params), labels)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch`` (tokens, labels)."""
        x = self.embed(params, batch, 0)
        x = apply_groups_full(self, params, x)
        return self.head_loss(params, x, batch["labels"])


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig):
    """A decoder block: causal self-attention, cross-attention over the
    encoder's K/V and the FFN, each pre-normed (reference ``lm.py:475-485``)."""
    zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=gen.device)
    return {"self": attn_mod.init_attn(gen, cfg), "cross": attn_mod.init_attn(gen, cfg),
            "ffn": layers_mod.init_ffn(gen, cfg),
            "ln_self": zeros(), "ln_cross": zeros(), "ln_ffn": zeros()}


def _dec_block_specs(cfg: ModelConfig):
    """The logical axes of :func:`_init_dec_block`'s leaves."""
    return {"self": attn_mod.attn_specs(cfg), "cross": attn_mod.attn_specs(cfg),
            "ffn": layers_mod.ffn_specs(cfg),
            "ln_self": (None,), "ln_cross": (None,), "ln_ffn": (None,)}


def _make_enc_group(cfg: ModelConfig, name: str, count: int, device):
    """The encoder: dense blocks with bidirectional attention (reference
    ``lm.py:492-499``), full mode only (``causal`` False: not
    token-sliceable), no cache."""
    def full(bp, x):
        return layers_mod.dense_block_full(bp, cfg, x, causal=False)

    def init_params(gen):
        return _stack_init(lambda g: layers_mod.init_dense_block(g, cfg), gen, count)

    return (BlockGroup(name, count, full, None, None, lambda *a, **k: (), None, causal=False),
            init_params, _stack_specs(layers_mod.dense_block_specs(cfg)))


def _make_dec_group(cfg: ModelConfig, name: str, count: int, device):
    """The decoder (reference ``lm.py:501-535``): self-attention (causal,
    cached; the kernels under ``cfg.use_kernel``), cross-attention over one
    layer's encoder K/V, FFN.  Its blocks take and return ``(x, enc_kv)``
    in every mode, as the reference's do."""
    def cross_ffn(bp, x, ek, ev):
        x = x + attn_mod.attn_cross(per_rank(bp, "cross"), cfg,
                                    rms_norm(x, replicated(bp, "ln_cross")), ek, ev)
        return x + layers_mod.ffn(per_rank(bp, "ffn"), rms_norm(x, replicated(bp, "ln_ffn")),
                                  cfg.tp_axis)

    def full(bp, x_and_enc):
        x, (ek, ev) = x_and_enc
        x = x + attn_mod.attn_full(per_rank(bp, "self"), cfg,
                                   rms_norm(x, replicated(bp, "ln_self")))
        return cross_ffn(bp, x, ek, ev), (ek, ev)

    def with_cache(attn_fn):
        def block(bp, x_and_enc, cache, arg):
            x, (ek, ev) = x_and_enc
            a, cache = attn_fn(per_rank(bp, "self"), cfg, rms_norm(x, replicated(bp, "ln_self")),
                               cache, arg)
            return (cross_ffn(bp, x + a, ek, ev), (ek, ev)), cache
        return block

    def init_params(gen):
        return _stack_init(lambda g: _init_dec_block(g, cfg), gen, count)

    return (BlockGroup(name, count, full, with_cache(attn_mod.attn_sliced),
                       with_cache(attn_mod.attn_decode), _kv_cache_init(cfg, count, device),
                       None), init_params, _stack_specs(_dec_block_specs(cfg)))


class EncDecModel(Model):
    """The encoder-decoder, whisper's backbone with its conv frontend
    stubbed (reference ``_build_encdec``, ``lm.py:488-635``): the batch
    carries ``frames`` (B, S_enc, D), precomputed frame embeddings.  The
    ``enc`` group is bidirectional and not token-sliceable (``causal``
    False: its attention takes the plain route whatever
    ``cfg.use_kernel``); ``encode`` runs it, then each decoder layer's
    cross K/V of its output, stacked on the layer axis.  The ``dec`` group's
    blocks take and return ``(x, enc_kv)``: causal self-attention (the
    kernels under ``cfg.use_kernel``), then the plain cross-attention.  Its
    loops over layers are the reference's own, per method."""

    def _make_groups(self):
        cfg = self.cfg
        return [_make_enc_group(cfg, "enc", cfg.n_enc_layers or cfg.n_layers, self.device),
                _make_dec_group(cfg, "dec", cfg.n_dec_layers or cfg.n_layers, self.device)]

    def init(self, seed: int) -> Params:
        """Random parameters drawn in the reference's order: the encoder's
        and the decoder's stacks, the embedding, the head."""
        cfg = self.cfg
        gen = make_generator(self.device, seed)
        zeros = lambda: torch.zeros((cfg.d_model,), dtype=torch.float32, device=self.device)
        groups = {name: init(gen) for name, init in self._init_groups.items()}
        params: Params = {"groups": groups,
                          "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model))}
        params["enc_ln"], params["final_ln"] = zeros(), zeros()
        params["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size))
        return params

    def specs(self) -> Params:
        """The logical axes of ``init``'s tree (:meth:`Model.specs`)."""
        return {"groups": dict(self._group_specs), "embed": ("vocab", "embed"),
                "enc_ln": (None,), "final_ln": (None,), "lm_head": ("embed", "vocab")}

    def encode(self, params, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """frames (B, S_enc, D) -> the cross K/V of every decoder layer,
        each (n_dec, B, S_enc, Hkv, hd).  The encoder's layers run under
        plain checkpoint when ``cfg.remat`` (the reference's
        ``jax.checkpoint``, which the dots policy does not reach)."""
        enc = self.groups[0]
        x = frames.to(self.cfg.dtype)
        body = _remat(enc.full) if self.cfg.remat else enc.full
        for bp_l in _unstack(params["groups"]["enc"]):
            x = body(bp_l, x)
        x = rms_norm(x, params["enc_ln"])
        kv = [attn_mod.cross_kv(per_rank(bp_l, "cross"), self.cfg, x)
              for bp_l in _unstack(params["groups"]["dec"])]
        return torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])

    def embed(self, params, batch, ctx: int = 0) -> torch.Tensor:
        return params["embed"][batch["tokens"].long()].to(self.cfg.dtype)

    def _run_dec_full(self, params, x, enc_kv):
        dec = self.groups[1]

        def body(bp_l, h, ek, ev):
            return dec.full(bp_l, (h, (ek, ev)))[0]
        if self.cfg.remat:
            body = _remat(body)
        for bp_l, ek, ev in zip(_unstack(params["groups"]["dec"]), *enc_kv):
            x = body(bp_l, x, ek, ev)
        return x

    def forward(self, params, batch) -> torch.Tensor:
        """Float32 logits (B, S, V) of the decoder's tokens."""
        enc_kv = self.encode(params, batch["frames"])
        x = self._run_dec_full(params, self.embed(params, batch), enc_kv)
        return self.head(params, x)

    def head_loss(self, params, x, labels) -> torch.Tensor:
        return chunked_xent(rms_norm(x, params["final_ln"]), params["lm_head"], labels)

    def loss(self, params, batch) -> torch.Tensor:
        enc_kv = self.encode(params, batch["frames"])
        x = self._run_dec_full(params, self.embed(params, batch), enc_kv)
        return self.head_loss(params, x, batch["labels"])

    def init_caches(self, batch: int, max_len: int, dtype=torch.bfloat16,
                    mode: str = "sliced"):
        """``[enc_kv, dec_kv]``: slot 0 the cross K/V (zeros of ``max_len``
        rows until ``prefill`` puts ``encode``'s output there, whose length
        is the number of frames), slot 1 the decoder's self-attention
        cache."""
        return [_kv_zeros(self.cfg, self.groups[1].count, batch, max_len, dtype, self.device),
                self.groups[1].init_cache(batch, max_len, dtype, mode=mode)]

    def prefill(self, params, batch, max_len: int):
        """Encode ``frames``, then the decoder over ``tokens`` at ctx 0,
        writing its self-attention cache in place."""
        enc_kv = self.encode(params, batch["frames"])
        dec_kv = self.groups[1].init_cache(batch["tokens"].shape[0], max_len, self.cfg.dtype)
        x = self.embed(params, batch)
        for i, bp_l in enumerate(_unstack(params["groups"]["dec"])):
            (x, _), _ = self.groups[1].sliced(bp_l, (x, (enc_kv[0][i], enc_kv[1][i])),
                                              (dec_kv[0][i], dec_kv[1][i]), 0)
        return self.head(params, x[:, -1:, :]), [enc_kv, dec_kv]

    def decode_step(self, params, caches, batch, pos):
        """One token per row at ``pos``; the self-attention cache in place."""
        enc_kv, dec_kv = caches
        x = self.embed(params, batch)
        for i, bp_l in enumerate(_unstack(params["groups"]["dec"])):
            (x, _), _ = self.groups[1].decode(bp_l, (x, (enc_kv[0][i], enc_kv[1][i])),
                                              (dec_kv[0][i], dec_kv[1][i]), pos)
        return self.head(params, x), [enc_kv, dec_kv]


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """Build the model on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"`` is asked for; ``"meta"`` when asked for,
    for shapes without storage): :class:`EncDecModel` for the enc-dec
    family, else :class:`Model`."""
    cls = EncDecModel if cfg.family == "encdec" else Model
    return cls(cfg, resolve_device(device))
