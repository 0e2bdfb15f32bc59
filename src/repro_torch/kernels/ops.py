"""Public attention ops (reference: ``repro/kernels/ops.py``), with the JAX
signatures and layouts.

Dispatch is by the tensors' device: CPU tensors take the plain PyTorch
version (:mod:`repro_torch.kernels.ref`), CUDA tensors launch the
hand-written kernel or raise — there is no fallback from one to the other.

``terapipe_attention`` is forward-only in this slice: the reference's
``custom_vjp`` (``ops.py:34-65``) and its dQ / dK-dV kernels
(``terapipe_attention_bwd.py``) arrive with the training slice as a
``torch.autograd.Function``.
"""
from __future__ import annotations

import torch

from .decode_attention import decode_attention_kernel
from .ref import decode_attention_ref, terapipe_attention_ref
from .terapipe_attention import terapipe_attention_fwd


def terapipe_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       ctx_len) -> torch.Tensor:
    """Flash attention of a query slice at context offset ``ctx_len``.

    q: (B, l, Hq, hd); k/v: (B, Sk, Hkv, hd) with Sk >= ctx_len + l; GQA
    resolved inside the kernel (no K/V repeat).  ``ctx_len`` is a python
    int (or a 0-d tensor, read once on the host).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "terapipe_attention is forward-only until the training slice "
            "ports the dQ and dK/dV kernels (terapipe_attention_bwd.py)")
    ctx = int(ctx_len)
    if q.device.type == "cpu":
        return terapipe_attention_ref(q, k, v, ctx)[0]
    return terapipe_attention_fwd(q, k, v, ctx)[0]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len) -> torch.Tensor:
    """Flash decode: q (B,1,Hq,hd) vs cache (B,L,Hkv,hd) valid to ``kv_len``
    — a scalar, or a per-batch (B,) vector for continuous-batching rounds
    that mix context depths."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len)
    return decode_attention_kernel(q, k, v, kv_len)
