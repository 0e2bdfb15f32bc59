"""GQA attention layer (reference: ``repro/models/attention.py``).

Modes: ``full`` (self-attention over the whole sequence: the training
forward, causal, or bidirectional for an encoder), ``sliced`` (a token slice
at a static context offset over [prefix KV cache ++ this slice]: prefill
chunks), ``sliced_dyn`` (a slice at an offset that is data, attending over
the cache rows up to the slice's end with an absolute-position mask: the
pipeline executor's op) and ``decode`` (one new token per row against a
fixed-capacity cache, at a scalar or a per-row position).  Each mode takes a
``window`` (sliding-window attention: the hybrid family's third block), and
``decode`` a ring cache (``ring``: slot ``pos % L_max``).  The enc-dec
family adds ``attn_cross`` (decoder queries over the encoder's K/V, no RoPE,
no mask) and ``cross_kv``.  The kernels compute causal, unwindowed
attention, so a windowed call, the encoder's bidirectional attention and
the cross-attention take the plain route whatever ``cfg.use_kernel`` says,
as in the reference (which has no Pallas kernel for them).

The ring decode keeps the reference's stated contract, that prefill then
decode continues the forward, where the reference does not: its ring mask
(``repro/models/attention.py:255-260``) keeps every written slot, which is
the window only when the cache is exactly ``window`` long, but ``prefill``
builds caches of ``max_len``.  Here the mask also drops slots ``window`` or
more positions behind (ROADMAP Queue 3).

``sliced`` and ``decode`` update their caches IN PLACE: the reference
returns new arrays, but every serving caller owns the dense cache it passes
(a fresh gather from the paged pool, or one ``prefill`` made), so writing
into it saves a copy of the whole cache per layer.  ``sliced_dyn`` writes in
place only while autograd is off; under grad it updates out of place, as
the reference's ``dynamic_update_slice`` does, so that no tensor saved for
the backward pass is overwritten.  All return ``(out, (k, v))`` with the
updated cache, as the reference does.

Under tensor parallelism (``cfg.tp_axis`` a group), ``full`` and
``sliced_dyn`` take the hosted ranks' lists of shards and caches, run each
rank's heads and sum the output projection's partials (``_over_ranks``);
``sliced`` and ``decode`` serve, and the reference serves without it, so
they refuse a group that hosts several ranks (one cache each would be
needed); under a group that hosts one rank (one process per rank, as
``distributed.transport.DistGroup``, or the dry run's recording group) they
run that rank's heads on its cache and sum the output projection's partial
over the axis.  ``attn_cross`` and ``cross_kv`` take the hosted ranks'
shards too: each rank projects and attends with its own heads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

from .common import (ModelConfig, apply_rope, attention_scores, attention_scores_gqa,
                     causal_mask, dense_init, local_causal_mask, repeat_kv, rms_norm, shards,
                     tp_group)


def init_attn(gen: torch.Generator, cfg: ModelConfig):
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, (cfg.d_model, cfg.n_heads * hd)),
        "wk": dense_init(gen, (cfg.d_model, cfg.n_kv_heads * hd)),
        "wv": dense_init(gen, (cfg.d_model, cfg.n_kv_heads * hd)),
        "wo": dense_init(gen, (cfg.n_heads * hd, cfg.d_model)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch.float32, device=gen.device)
    return p


def attn_specs(cfg: ModelConfig):
    """The logical axes of :func:`init_attn`'s leaves (reference
    ``init_attn``'s second value)."""
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qk_norm:
        s["q_norm"] = s["k_norm"] = (None,)
    return s


def kv_heads_of_rank(n_heads: int, n_kv_heads: int, tp: int, rank: int) -> list:
    """The KV heads that rank ``rank`` of ``tp`` reads when ``tp`` does not
    divide them (``wk``/``wv`` replicated): its local q head ``j`` is
    global head ``rank·Hq/tp + j`` and reads KV head ``(rank·Hq/tp + j) //
    (Hq // Hkv)``; the one head of its GQA group when all its q heads fall
    in one, else one per q head."""
    hq_local, group = n_heads // tp, n_heads // n_kv_heads
    heads = [(rank * hq_local + j) // group for j in range(hq_local)]
    return heads[:1] if group % hq_local == 0 else heads


def tp_local_kv_heads(n_heads: int, n_kv_heads: int, tp: int) -> int:
    """The KV heads one tensor-parallel rank attends with: its share when
    ``tp`` divides them, else those :func:`kv_heads_of_rank` selects."""
    if n_kv_heads % tp == 0:
        return n_kv_heads // tp
    return len(kv_heads_of_rank(n_heads, n_kv_heads, tp, 0))


def _select_heads(w: torch.Tensor, heads, hd: int) -> torch.Tensor:
    """The columns of ``w`` (d, H·hd) of ``heads``, in order: a view when
    they are consecutive."""
    if heads == list(range(heads[0], heads[0] + len(heads))):
        return w[:, heads[0] * hd:(heads[0] + len(heads)) * hd]
    return torch.cat([w[:, h * hd:(h + 1) * hd] for h in heads], dim=1)


def tp_rank_attn(p, cfg: ModelConfig, tp: int, rank: int):
    """Rank ``rank``'s attention parameters under tensor parallelism of
    degree ``tp``, from its block of them (``cfg`` the unsharded model's).
    Where ``tp`` does not divide the KV heads, ``wk``/``wv`` are placed
    replicated, as in the reference, and the rank keeps the KV heads its
    own q heads read (``kv_heads_of_rank``), so that the local GQA pairing
    is the unsharded model's; the reference pairs rank r's q heads with
    the first KV heads (ROADMAP Queue 3).  Otherwise ``p`` itself."""
    if cfg.n_kv_heads % tp == 0:
        return p
    heads = kv_heads_of_rank(cfg.n_heads, cfg.n_kv_heads, tp, rank)
    return {**p, "wk": _select_heads(p["wk"], heads, cfg.hd),
            "wv": _select_heads(p["wv"], heads, cfg.hd)}


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
                 rope: bool = True):
    """Head counts are derived from the weight shapes, not cfg (the
    reference's manual-TP convention)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, -1, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, -1, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


_BLOCKED_THRESHOLD = 2048   # above this seq len, use the q-chunked softmax path
_Q_CHUNK = 1024


def attention_blocked(q, k, v, *, q_offset: int = 0, q_chunk: int = _Q_CHUNK,
                      window: int = 0) -> torch.Tensor:
    """Causal attention without materializing the full (Sq, Sk) score matrix.

    A loop over query chunks; the chunk at absolute offset ``o`` only reads
    keys[: o + qc] (exact causal FLOPs), and with a ``window`` only from
    key ``o - window + 1`` on.  q: (B, Sq, H, hd); k/v: (B, Sk, H, hd),
    already GQA-repeated.
    """
    sq = q.shape[1]
    outs = []
    for start in range(0, sq, q_chunk):
        qc = min(q_chunk, sq - start)
        off = q_offset + start
        k_end = min(off + qc, k.shape[1])
        lo = max(0, off - window + 1) if window else 0
        if window:
            mask = local_causal_mask(qc, k_end - lo, window, q_offset=off - lo,
                                     device=q.device)
        else:
            mask = causal_mask(qc, k_end, q_offset=off, device=q.device)
        outs.append(attention_scores(q[:, start:start + qc], k[:, lo:k_end], v[:, lo:k_end],
                                     mask=mask))
    return torch.cat(outs, dim=1)


def attention_blocked_bidir(q, k, v, *, q_chunk: int = _Q_CHUNK) -> torch.Tensor:
    """Bidirectional attention without the (Sq, Sk) score matrix: a loop
    over query chunks, each attending every key (GQA-native: k/v
    (B, Sk, Hkv, hd)); one chunk when ``q_chunk`` does not divide Sq, as in
    the reference."""
    sq = q.shape[1]
    if sq % q_chunk != 0:
        q_chunk = sq
    return torch.cat([attention_scores_gqa(q[:, i:i + q_chunk], k, v, mask=None)
                      for i in range(0, sq, q_chunk)], dim=1)


def _out_proj(p, cfg: ModelConfig, out, b, s, dtype):
    return out.reshape(b, s, -1) @ p["wo"].to(dtype)


def _over_ranks(p, cfg: ModelConfig, x: torch.Tensor, cache, heads):
    """``heads(p, x, cache) -> (out, cache)``, an attention mode before its
    output projection, on each hosted rank's shard (``p`` a dict, or under
    tensor parallelism the hosted ranks' list) and cache (one, or the
    ranks' list), then the ranks' :func:`_out_proj` partials summed over
    the axis (the reference's ``psum``)."""
    b, s, _ = x.shape
    group, ps = tp_group(cfg.tp_axis), shards(p)
    caches = cache if isinstance(cache, list) else [cache] * len(ps)
    res = [heads(p_r, x_r, c_r) for p_r, x_r, c_r in zip(ps, group.region(x), caches)]
    y = group.all_reduce([_out_proj(p_r, cfg, out, b, s, x.dtype)
                          for p_r, (out, _) in zip(ps, res)])[0]
    new = [c for _, c in res]
    return y, (new if isinstance(cache, list) else new[0])


def _serving_params(p, cfg: ModelConfig):
    """A serving mode's one parameter dict (``p``, or the one rank's of a
    block's list) and the group its output projection's partial is summed
    over: without tensor parallelism the one-rank group; a group hosting
    several ranks raises, as the reference serves without tensor
    parallelism."""
    group = tp_group(cfg.tp_axis)
    if len(group.ranks) != 1:
        raise ValueError("the serving attention modes (attn_sliced, attn_decode) take no "
                         "tensor parallelism over a group that hosts several ranks "
                         "(cfg.tp_axis), as the reference's serving has none")
    return shards(p)[0], group


def _write_rows(cache: torch.Tensor, x: torch.Tensor, start: int) -> torch.Tensor:
    """``cache[:, start:start+len(x)] = x``: in place while autograd is off,
    out of place (a new tensor) under grad."""
    x = x.to(cache.dtype)
    if torch.is_grad_enabled():
        return torch.slice_scatter(cache, x, dim=1, start=start, end=start + x.shape[1])
    cache[:, start:start + x.shape[1]] = x
    return cache


def attn_full(p, cfg: ModelConfig, x: torch.Tensor, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """(B, S, D) -> (B, S, D).  Self-attention over the whole sequence:
    causal (the training forward), within ``window`` tokens if set, or
    bidirectional (``causal=False``: the encoder), which has no kernel."""
    s = x.shape[1]

    def heads(p, x, _):
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = _project_qkv(p, cfg, x, positions, rope=cfg.rope_theta > 0)
        if cfg.use_kernel and causal and window == 0:
            out = kops.terapipe_attention(q, k, v, ctx_len=0)
        elif not causal:
            out = (attention_blocked_bidir(q, k, v) if s > _BLOCKED_THRESHOLD
                   else attention_scores_gqa(q, k, v, mask=None))
        elif s > _BLOCKED_THRESHOLD:
            rep = q.shape[2] // k.shape[2]
            out = attention_blocked(q, repeat_kv(k, rep), repeat_kv(v, rep), window=window)
        elif window:
            out = attention_scores_gqa(q, k, v, mask=local_causal_mask(s, s, window,
                                                                       device=x.device)[None])
        else:
            out = attention_scores_gqa(q, k, v, mask=causal_mask(s, s, device=x.device)[None])
        return out, None

    return _over_ranks(p, cfg, x, None, heads)[0]


def attn_sliced(p, cfg: ModelConfig, x_slice: torch.Tensor, kv_cache, ctx_len: int,
                *, window: int = 0):
    """Attention of a slice at static context offset ``ctx_len``.

    x_slice : (B, l, D) hidden states of this token slice
    kv_cache: (k, v) each (B, L_max, kv_heads, hd) — prefix written in [0, ctx_len)
    Returns (out_slice, kv_cache) with the slice's K/V written at ctx_len.
    """
    p, group = _serving_params(p, cfg)
    b, l, _ = x_slice.shape
    positions = (torch.arange(l, device=x_slice.device) + ctx_len)[None, :]
    q, k, v = _project_qkv(p, cfg, x_slice, positions, rope=cfg.rope_theta > 0)
    ck, cv = kv_cache
    ck[:, ctx_len:ctx_len + l] = k.to(ck.dtype)
    cv[:, ctx_len:ctx_len + l] = v.to(cv.dtype)
    k_all = ck[:, :ctx_len + l].to(q.dtype)
    v_all = cv[:, :ctx_len + l].to(q.dtype)
    if cfg.use_kernel and window == 0:
        out = kops.terapipe_attention(q, k_all, v_all, ctx_len=ctx_len)
    elif l > _BLOCKED_THRESHOLD:
        rep = q.shape[2] // k_all.shape[2]
        out = attention_blocked(q, repeat_kv(k_all, rep), repeat_kv(v_all, rep),
                                q_offset=ctx_len, window=window)
    else:
        mask = (local_causal_mask(l, ctx_len + l, window, q_offset=ctx_len, device=q.device)
                if window else causal_mask(l, ctx_len + l, q_offset=ctx_len, device=q.device))
        out = attention_scores_gqa(q, k_all, v_all, mask=mask[None])
    return group.all_reduce([_out_proj(p, cfg, out, b, l, x_slice.dtype)])[0], (ck, cv)


def attn_sliced_dyn(p, cfg: ModelConfig, x_slice: torch.Tensor, kv_cache, ctx,
                    *, window: int = 0):
    """Attention of a slice at a context offset that is data (the lockstep
    pipeline: at one tick each stage works at its own ctx).

    ``ctx`` is a python int or a 0-d tensor (read once on the host).  The
    slice's K/V are written at ``ctx``; the slice attends over the cache
    rows ``[0, ctx + l)`` with an absolute-position causal mask (from row
    ``ctx - window + 1`` on with a ``window``).  The reference attends over
    the whole cache and masks the rows outside (stale, unwritten or out of
    the window); with ``ctx`` on the host the port hands the attention only
    the rows it reads, which gives the same result, and no dK/dV work or
    zero tiles for the unused rows.
    """
    l = x_slice.shape[1]
    ctx = int(ctx)

    def heads(p, x_slice, kv_cache):
        positions = (torch.arange(l, device=x_slice.device) + ctx)[None, :]
        q, k, v = _project_qkv(p, cfg, x_slice, positions, rope=cfg.rope_theta > 0)
        ck, cv = kv_cache
        ck = _write_rows(ck, k, ctx)
        cv = _write_rows(cv, v, ctx)
        lo = max(0, ctx - window + 1) if window else 0
        k_all = ck[:, lo:ctx + l].to(q.dtype)
        v_all = cv[:, lo:ctx + l].to(q.dtype)
        if cfg.use_kernel and window == 0:
            out = kops.terapipe_attention(q, k_all, v_all, ctx_len=ctx)
        elif window:
            mask = local_causal_mask(l, ctx + l - lo, window, q_offset=ctx - lo,
                                     device=q.device)
            out = attention_scores_gqa(q, k_all, v_all, mask=mask[None])
        else:
            mask = causal_mask(l, ctx + l, q_offset=ctx, device=q.device)
            out = attention_scores_gqa(q, k_all, v_all, mask=mask[None])
        return out, (ck, cv)

    return _over_ranks(p, cfg, x_slice, kv_cache, heads)


def attn_decode(p, cfg: ModelConfig, x_tok: torch.Tensor, kv_cache, pos,
                *, window: int = 0, ring: bool = False):
    """One-token decode.  x_tok (B, 1, D); ``pos`` a python int or 0-d
    tensor (current position) OR a per-row (B,) tensor — a continuous-
    batching round where every slot sits at its own context depth.

    kv_cache: (k, v) each (B, L_max, kv_heads, hd).
    ring=True: the cache is a ring buffer indexed by ``pos % L_max``
    (bounded memory for local-attention archs at 500k+ context); the token
    attends over the slots that hold one of the last ``window`` positions,
    whatever ``L_max`` is.
    """
    p, group = _serving_params(p, cfg)
    b = x_tok.shape[0]
    if not isinstance(pos, int):     # a host int stays one (no .item(): meta decodes)
        pos_t = torch.as_tensor(pos, device=x_tok.device)
        if pos_t.dim() > 0:
            y, kv_cache = _attn_decode_batched(p, cfg, x_tok, kv_cache, pos_t.long(),
                                               window=window, ring=ring)
            return group.all_reduce([y])[0], kv_cache
        pos = int(pos_t)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x_tok.device)
    q, k, v = _project_qkv(p, cfg, x_tok, positions, rope=cfg.rope_theta > 0)
    ck, cv = kv_cache
    lmax = ck.shape[1]
    slot = pos % lmax if ring else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    kp = torch.arange(lmax, device=x_tok.device)[None, :]
    if ring:
        # slot i holds absolute position p_i = pos - ((pos - i) mod L_max)
        abs_pos = pos - torch.remainder(pos - kp, lmax)
        valid = abs_pos >= 0
        if window:
            valid &= abs_pos > pos - window
        out = attention_scores_gqa(q, ck.to(q.dtype), cv.to(q.dtype),
                                   mask=valid[None])              # (1, 1, Lmax)
    elif cfg.use_kernel and window == 0:
        out = kops.decode_attention(q, ck.to(q.dtype), cv.to(q.dtype), pos + 1)
    else:
        valid = kp <= pos
        if window:
            valid &= kp > pos - window
        out = attention_scores_gqa(q, ck.to(q.dtype), cv.to(q.dtype),
                                   mask=valid[None])              # (1, 1, Lmax)
    return group.all_reduce([_out_proj(p, cfg, out, b, 1, x_tok.dtype)])[0], (ck, cv)


def _attn_decode_batched(p, cfg: ModelConfig, x_tok: torch.Tensor, kv_cache,
                         pos: torch.Tensor, *, window: int = 0, ring: bool = False):
    """attn_decode with a per-row (B,) position vector: each slot writes its
    token at its OWN cache depth and attends over its own valid prefix.
    Every op is row-independent, so slot b's output depends only on slot
    b's inputs — the bit-identity the serving engine's continuous-vs-
    sequential contract rests on."""
    if ring:
        raise ValueError("ring caches decode a single stream (scalar pos)")
    b = x_tok.shape[0]
    positions = pos[:, None]                                   # (B, 1)
    q, k, v = _project_qkv(p, cfg, x_tok, positions, rope=cfg.rope_theta > 0)
    ck, cv = kv_cache
    lmax = ck.shape[1]
    rows = torch.arange(b, device=x_tok.device)
    ck[rows, pos] = k[:, 0].to(ck.dtype)
    cv[rows, pos] = v[:, 0].to(cv.dtype)
    if cfg.use_kernel and window == 0:
        out = kops.decode_attention(q, ck.to(q.dtype), cv.to(q.dtype), pos + 1)
    else:
        kp = torch.arange(lmax, device=x_tok.device)[None, :]
        valid = kp <= positions                                # (B, Lmax)
        if window:
            valid &= kp > positions - window
        out = attention_scores_gqa(q, ck.to(q.dtype), cv.to(q.dtype),
                                   mask=valid[:, None, :])     # (B, 1, Lmax)
    return _out_proj(p, cfg, out, b, 1, x_tok.dtype), (ck, cv)


def attn_cross(p, cfg: ModelConfig, x: torch.Tensor, enc_k: torch.Tensor,
               enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention: the decoder's queries over the encoder's K/V
    (``cross_kv``), with no RoPE and no mask; plain PyTorch, as the
    reference's (it has no kernel).  Under tensor parallelism ``enc_k`` /
    ``enc_v`` hold the hosted ranks' KV heads in rank order, each rank
    attends with its own, and the output projection's partials are summed
    over the axis (``_over_ranks``)."""
    b, s, _ = x.shape
    hd = cfg.hd
    cuts = [q["wk"].shape[-1] // hd for q in shards(p)]
    kvs = list(zip(torch.split(enc_k, cuts, dim=2), torch.split(enc_v, cuts, dim=2)))

    def heads(p, x, kv):
        q = (x @ p["wq"].to(x.dtype)).reshape(b, s, -1, hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        ek, ev = (a.to(q.dtype) for a in kv)
        if s > _BLOCKED_THRESHOLD or ek.shape[1] > _BLOCKED_THRESHOLD:
            return attention_blocked_bidir(q, ek, ev), kv
        return attention_scores_gqa(q, ek, ev, mask=None), kv

    return _over_ranks(p, cfg, x, kvs, heads)[0]


def cross_kv(p, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder output's K and V for one decoder layer's
    cross-attention, computed once per sequence.  Under tensor parallelism
    each hosted rank projects its own KV heads (its shard of ``wk`` /
    ``wv``, the heads ``kv_heads_of_rank`` keeps where they are
    replicated) from its view of the replicated encoder output (the
    region, whose gradient is summed over the axis); the ranks' heads are
    concatenated in rank order, as :func:`attn_cross` reads them."""
    b, s, _ = enc_out.shape
    ks, vs = [], []
    for p_r, x_r in zip(shards(p), tp_group(cfg.tp_axis).region(enc_out)):
        k = (x_r @ p_r["wk"].to(x_r.dtype)).reshape(b, s, -1, cfg.hd)
        v = (x_r @ p_r["wv"].to(x_r.dtype)).reshape(b, s, -1, cfg.hd)
        if cfg.qk_norm:
            k = rms_norm(k, p_r["k_norm"])
        ks.append(k)
        vs.append(v)
    if len(ks) == 1:
        return ks[0], vs[0]
    return torch.cat(ks, dim=2), torch.cat(vs, dim=2)
