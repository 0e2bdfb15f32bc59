"""Public attention ops (reference: ``repro/kernels/ops.py``), with the JAX
signatures and layouts.

Dispatch is by the tensors' device: CPU tensors take the plain PyTorch
versions (:mod:`repro_torch.kernels.ref`), CUDA tensors launch the
hand-written kernels or raise — there is no fallback from one to the other.

``terapipe_attention`` is a ``torch.autograd.Function``, the counterpart of
the reference's ``custom_vjp`` (``_make_flash_attention``): the forward
saves ``(q, k, v, O, lse)``; the backward computes ``delta = rowsum(dO*O)``
in float32 and runs the dQ and dK/dV kernels (``terapipe_attention_bwd``).
Neither the (l, ctx+l) probabilities nor a GQA-repeated K/V are saved.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention_kernel
from .ref import decode_attention_ref, terapipe_attention_bwd_ref, terapipe_attention_ref
from .terapipe_attention import terapipe_attention_fwd
from .terapipe_attention_bwd import terapipe_attention_bwd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(fctx, q, k, v, ctx: int):
        fwd = terapipe_attention_ref if q.device.type == "cpu" else terapipe_attention_fwd
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
        bwd = terapipe_attention_bwd_ref if q.device.type == "cpu" else terapipe_attention_bwd
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
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    return decode_attention_kernel(q, k, v, kv_len)
