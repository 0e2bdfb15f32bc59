"""Public attention ops (reference: ``repro/kernels/ops.py``), with the JAX
signatures and layouts.

Dispatch is by the tensors' device, with no fallback from one route to
another:

* ``cpu``: the plain PyTorch versions (:mod:`repro_torch.kernels.ref`);
* ``cuda``: the hand-written kernels, or their wrappers raise;
* ``meta``: a shape-only route for the dry run (``launch/dryrun.py``):
  empty meta tensors of exactly what the kernel returns, after the
  kernel's own shape checks.  It counts the call in :data:`META` with the
  kernel's work by PERF.md §6's formulas (:func:`attention_flops`):
  4·hd FLOPs per unmasked (q, k) pair and head for the forward, 6·hd for
  dQ, 8·hd for dK/dV, 4·hd per valid key and head for decode; bytes as the
  kernel reads and writes them.  It never calls the plain version, which
  would count the whole ``(l, ctx + l)`` score matrix that the kernel
  never holds.

Any other device raises.

``terapipe_attention`` is a ``torch.autograd.Function``, the counterpart of
the reference's ``custom_vjp`` (``_make_flash_attention``): the forward
saves ``(q, k, v, O, lse)``; the backward computes ``delta = rowsum(dO*O)``
in float32 and runs the dQ and dK/dV kernels (``terapipe_attention_bwd``).
Neither the (l, ctx+l) probabilities nor a GQA-repeated K/V are saved.
"""
from __future__ import annotations

from typing import Dict

import torch

from .decode_attention import CHUNK, decode_attention_kernel
from .ref import decode_attention_ref, terapipe_attention_bwd_ref, terapipe_attention_ref
from .terapipe_attention import check_attention_shapes, terapipe_attention_fwd
from .terapipe_attention_bwd import terapipe_attention_bwd

#: the kernels, by the names of their launch counters
KERNELS = ("terapipe_attention_fwd", "terapipe_attention_dq", "terapipe_attention_dkv",
           "decode_attention")

#: per kernel, what its meta route was asked for: ``calls``, ``flops`` and
#: ``bytes`` (read once, written once); the dry run sets them to 0 and reads
#: them around a traced step
META: Dict[str, Dict[str, int]] = {k: {"calls": 0, "flops": 0, "bytes": 0} for k in KERNELS}


def reset_meta() -> None:
    for entry in META.values():
        entry.update(calls=0, flops=0, bytes=0)


def attention_pairs(b: int, l: int, ctx: int, hq: int) -> int:
    """Unmasked (query, key) pairs times heads of a causal slice of ``l``
    queries at offset ``ctx``: query i attends keys [0, ctx + i]."""
    return b * hq * (l * ctx + l * (l + 1) // 2)


def attention_flops(q: torch.Tensor, ctx: int) -> Dict[str, int]:
    """The forward's, dQ's and dK/dV's FLOPs on a slice of queries ``q``
    (B, l, Hq, hd) at offset ``ctx``, by PERF.md §6's formulas: 4·hd, 6·hd
    and 8·hd per unmasked (q, k) pair and head."""
    b, l, hq, hd = q.shape
    pairs = attention_pairs(b, l, int(ctx), hq)
    return {"terapipe_attention_fwd": 4 * hd * pairs, "terapipe_attention_dq": 6 * hd * pairs,
            "terapipe_attention_dkv": 8 * hd * pairs}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _count(name: str, flops: int, nbytes: int) -> None:
    entry = META[name]
    entry["calls"] += 1
    entry["flops"] += int(flops)
    entry["bytes"] += int(nbytes)


def _route(t: torch.Tensor, what: str) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: tensors on {t.device}; the attention ops take cpu "
                         f"(the plain versions), cuda (the kernels) or meta (shapes only)")
    return kind


def _check_slice(q, k, ctx: int, what: str) -> None:
    l = q.shape[1]
    if l < 1 or ctx < 0 or k.shape[1] < ctx + l:
        raise ValueError(f"{what}: need l >= 1, ctx >= 0 and Sk >= ctx + l; got l={l}, "
                         f"ctx={ctx}, Sk={k.shape[1]}")


def _empty(shape, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype or like.dtype, device=like.device)


def _fwd_meta(q, k, v, ctx: int):
    """The forward kernel's outputs, ``out`` (B, l, Hq, hd) like q and
    ``lse`` (B, Hq, l) float32, with its work counted."""
    check_attention_shapes(q, k, v, "terapipe_attention_fwd (meta)")
    _check_slice(q, k, ctx, "terapipe_attention_fwd (meta)")
    b, l, hq, hd = q.shape
    out, lse = _empty((b, l, hq, hd), q), _empty((b, hq, l), q, torch.float32)
    _count("terapipe_attention_fwd", attention_flops(q, ctx)["terapipe_attention_fwd"],
           _nbytes(q, k, v, out, lse))
    return out, lse


def _bwd_meta(q, k, v, do, lse, delta, ctx: int):
    """The dQ and dK/dV kernels' outputs, dq like q, dk and dv in the Hkv
    layout like k and v, each kernel counted."""
    what = "terapipe_attention_bwd (meta)"
    check_attention_shapes(q, k, v, what)
    check_attention_shapes(do, k, v, what + " (dO)")
    _check_slice(q, k, ctx, what)
    flops = attention_flops(q, ctx)
    reads = _nbytes(q, k, v, do, lse, delta)
    dq = _empty(q.shape, q)
    _count("terapipe_attention_dq", flops["terapipe_attention_dq"], reads + _nbytes(dq))
    dk, dv = _empty(k.shape, k), _empty(v.shape, v)
    _count("terapipe_attention_dkv", flops["terapipe_attention_dkv"], reads + _nbytes(dk, dv))
    return dq, dk, dv


def _decode_meta(q, k, v, kv_len):
    """The decode kernel's output (B, 1, Hq, hd) like q, and its chunk
    workspace while the call lasts.  Valid keys: ``kv_len`` when it is a
    host number (or a tensor that is not on meta), else the whole cache (a
    meta tensor holds no lengths)."""
    check_attention_shapes(q, k, v, "decode_attention (meta)")
    b, _, hq, hd = q.shape
    hkv, lmax = k.shape[2], k.shape[1]
    if not isinstance(kv_len, torch.Tensor):
        keys = b * min(max(int(kv_len), 0), lmax)
    elif kv_len.is_meta:
        keys = b * lmax
    else:
        keys = int(kv_len.reshape(-1).expand(b).clamp(0, lmax).sum())
    n_chunks = -(-lmax // CHUNK)
    ws = _empty((b * hq * n_chunks * (hd + 2),), q, torch.float32)
    out = _empty((b, 1, hq, hd), q)
    _count("decode_attention", 4 * hd * hq * keys,
           _nbytes(q, out) + 2 * keys * hkv * hd * q.element_size() + 4 * b)
    del ws
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(fctx, q, k, v, ctx: int):
        fwd = {"cpu": terapipe_attention_ref, "cuda": terapipe_attention_fwd,
               "meta": _fwd_meta}[_route(q, "terapipe_attention")]
        out, lse = fwd(q, k, v, ctx)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.offset = ctx
        return out

    @staticmethod
    def backward(fctx, g):
        q, k, v, out, lse = fctx.saved_tensors
        # autograd may hand over a strided or expanded cotangent
        do = g.to(q.dtype).contiguous()
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = {"cpu": terapipe_attention_bwd_ref, "cuda": terapipe_attention_bwd,
               "meta": _bwd_meta}[_route(q, "terapipe_attention")]
        dq, dk, dv = bwd(q, k, v, do, lse, delta, fctx.offset)
        return dq, dk, dv, None


def terapipe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       ctx_len) -> torch.Tensor:
    """Flash attention of a query slice at context offset ``ctx_len``.

    q: (B, l, Hq, hd); k/v: (B, Sk, Hkv, hd) with Sk >= ctx_len + l; GQA
    resolved inside the kernels (no K/V repeat).  ``ctx_len`` is a python
    int (or a 0-d tensor, read once on the host).  Differentiable in q, k
    and v through the flash backward kernels.
    """
    return _FlashAttention.apply(q, k, v, int(ctx_len))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """Flash decode: q (B,1,Hq,hd) vs cache (B,L,Hkv,hd) valid to ``kv_len``
    — a scalar, or a per-batch (B,) vector for continuous-batching rounds
    that mix context depths."""
    route = _route(q, "decode_attention")
    if route == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    if route == "meta":
        return _decode_meta(q, k, v, kv_len)
    return decode_attention_kernel(q, k, v, kv_len)
