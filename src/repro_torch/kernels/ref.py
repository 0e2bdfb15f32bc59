"""Plain PyTorch versions of the attention kernels (reference:
``repro/kernels/ref.py`` and the kernels' own lse arithmetic).

They are the CPU path of :mod:`repro_torch.kernels.ops` and the oracle the
CUDA kernels are held against on the card.  All take GQA K/V natively
(``Hkv`` divides ``Hq``; the group is expanded here, never by the kernels).
"""
from __future__ import annotations

import math

import torch


def _grouped_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, Sq, Hq, hd) x (B, Sk, Hkv, hd) -> (B, Hq, Sq, Sk) float32 logits."""
    hq, hkv = q.shape[2], k.shape[2]
    k = k.float().repeat_interleave(hq // hkv, dim=2)
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(q.shape[-1])


def _grouped_pv(probs: torch.Tensor, v: torch.Tensor, hq: int) -> torch.Tensor:
    v = v.float().repeat_interleave(hq // v.shape[2], dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _softmax_lse(logits: torch.Tensor):
    """Softmax over the last axis of ``-inf``-masked logits, and the row
    logsumexp, with the kernels' guards: a fully masked row gives 0 (not
    NaN) and lse = -inf; the denominator is clamped at 1e-30."""
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    s = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return p / s, (m + torch.log(s))[..., 0]


def attention_mask(l: int, ctx: int, sk: int, device=None) -> torch.Tensor:
    """(l, Sk) bool: query row i (position ctx + i) sees key kv iff kv <= ctx
    + i and kv < ctx + l (keys of a stale cache tail past ctx + l never)."""
    qp = torch.arange(l, device=device)[:, None] + ctx
    kp = torch.arange(sk, device=device)[None, :]
    return (qp >= kp) & (kp < ctx + l)


def terapipe_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           ctx: int):
    """Attention of a query slice at absolute offset ``ctx``; returns
    ``(out, lse)``.

    q: (B, l, Hq, hd); k, v: (B, Sk, Hkv, hd) with Sk >= ctx + l.  Query i
    (position ctx+i) attends keys [0, ctx+i]; keys at or past ctx + l (a
    stale cache tail) are excluded.  ``lse`` is (B, Hq, l) float32, the
    per-row ``m + log(s)`` of ``terapipe_attention.py::_fwd_kernel`` with
    its denominator clamped at 1e-30.  The probabilities stay float32 into
    the PV product, as in the kernel.
    """
    b, l, hq, hd = q.shape
    logits = _grouped_logits(q, k)
    mask = attention_mask(l, ctx, k.shape[1], q.device)
    probs, lse = _softmax_lse(logits.masked_fill(~mask, float("-inf")))
    return _grouped_pv(probs, v, hq).to(q.dtype), lse


def _bwd_probs(q, k, v, do, lse, delta, ctx: int):
    """P and dS of the backward, (B, Hkv, rep, l, Sk) float32, and the
    grouped float32 operands."""
    b, l, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.float().reshape(b, l, hkv, rep, hd)
    dog = do.float().reshape(b, l, hkv, rep, hd)
    kf, vf = k.float(), v.float()
    mask = attention_mask(l, ctx, sk, q.device)                   # (l, Sk)
    rows = lambda t: t.reshape(b, hkv, rep, l, 1)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) / math.sqrt(hd)
    p = torch.where(mask, torch.exp(logits - rows(lse)), 0.0)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
    return p, p * (dp - rows(delta)), qg, dog, kf


def _dq(ds, kf, q):
    b, l, hq, hd = q.shape
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) / math.sqrt(hd)
    return dq.reshape(b, l, hq, hd).to(q.dtype)


def _dkv(p, ds, qg, dog, k, v):
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) / math.sqrt(k.shape[-1])
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def terapipe_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               do: torch.Tensor, lse: torch.Tensor,
                               delta: torch.Tensor, ctx: int):
    """Backward of :func:`terapipe_attention_ref`: returns ``(dq, dk, dv)``.

    The arithmetic of ``terapipe_attention_bwd.py::_dq_kernel`` and
    ``::_dkv_kernel``, all in float32: ``P = exp(scale*Q.K^T - lse)`` under
    the mask ``q_pos >= kv_pos & kv_pos < ctx + l``, ``dS = P * (dO.V^T -
    delta)``, ``dQ = scale*dS.K``, ``dK = scale*dS^T.Q``, ``dV = P^T.dO``.
    q/do: (B, l, Hq, hd); k/v: (B, Sk, Hkv, hd); lse/delta: (B, Hq, l)
    float32.  GQA-native: dK/dV are summed over each kv head's query heads
    and come back as (B, Sk, Hkv, hd) in k's dtype; keys at and past
    ``ctx + l`` get exactly zero.
    """
    p, ds, qg, dog, kf = _bwd_probs(q, k, v, do, lse, delta, ctx)
    return (_dq(ds, kf, q),) + _dkv(p, ds, qg, dog, k, v)


def terapipe_attention_dq_ref(q, k, v, do, lse, delta, ctx: int) -> torch.Tensor:
    """dQ alone: the plain version of the dQ kernel."""
    _, ds, _, _, kf = _bwd_probs(q, k, v, do, lse, delta, ctx)
    return _dq(ds, kf, q)


def terapipe_attention_dkv_ref(q, k, v, do, lse, delta, ctx: int):
    """(dK, dV) alone: the plain version of the dK/dV kernel."""
    p, ds, qg, dog, _ = _bwd_probs(q, k, v, do, lse, delta, ctx)
    return _dkv(p, ds, qg, dog, k, v)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len) -> torch.Tensor:
    """Single-token decode: q (B, 1, Hq, hd) over k/v (B, L, Hkv, hd) valid
    to ``kv_len`` — a python int, a 0-d tensor, or a per-batch (B,) vector.
    Positions >= kv_len[b] are masked."""
    b, _, hq, _ = q.shape
    lmax = k.shape[1]
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1).expand(b)
    logits = _grouped_logits(q, k)                              # (B, Hq, 1, L)
    valid = torch.arange(lmax, device=q.device)[None, :] < kv_len[:, None]
    probs, _ = _softmax_lse(logits.masked_fill(~valid[:, None, None, :], float("-inf")))
    return _grouped_pv(probs, v, hq).to(q.dtype)
