"""Launch wrappers of the flash-attention backward kernels (reference:
``repro/kernels/terapipe_attention_bwd.py::terapipe_attention_bwd``, whose
Pallas bodies ``_dq_kernel`` and ``_dkv_kernel`` become the two entries of
``csrc/terapipe_attention_bwd.cu``).

The wrappers check what the kernels take, allocate the gradients, and launch
on the current stream without synchronising.  They only take CUDA tensors:
the plain version for CPU tensors is :func:`repro_torch.kernels.ref.
terapipe_attention_bwd_ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .terapipe_attention import check_attention_inputs

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn(name: str, n_ptr: int, n_int: int, n_stride: int):
    fn = getattr(_build.load("terapipe_attention_bwd"), name)
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_L] * n_stride + [_P]
    fn.restype = _I
    return fn


def _check(q, k, v, do, lse, delta, ctx: int, what: str) -> None:
    check_attention_inputs(q, k, v, what)
    check_attention_inputs(do, k, v, what + " (dO)")
    b, l, hq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"{what}: dO {tuple(do.shape)} != q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b, hq, l) or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"{(b, hq, l)} tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if l < 1 or ctx < 0 or k.shape[1] < ctx + l:
        raise ValueError(f"{what}: need l >= 1, ctx >= 0 and Sk >= ctx + l; got "
                         f"l={l}, ctx={ctx}, Sk={k.shape[1]}")


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1))]


def terapipe_attention_dq(q, k, v, do, lse, delta, ctx: int) -> torch.Tensor:
    """dQ of flash attention at offset ``ctx`` on the card; like q."""
    ctx = int(ctx)
    _check(q, k, v, do, lse, delta, ctx, "terapipe_attention_dq")
    b, l, hq, hd = q.shape
    dq = torch.empty((b, l, hq, hd), dtype=q.dtype, device=q.device)
    err = _fn("terapipe_attention_dq", 7, 7, 10)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b, l, hq, k.shape[2], hd, ctx,
        int(q.dtype == torch.bfloat16), *_strides(q, k, v, do, dq),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "terapipe_attention_dq")
    _build.count(terapipe_attention_dq)
    return dq


def terapipe_attention_dkv(q, k, v, do, lse, delta, ctx: int):
    """(dK, dV) of flash attention at offset ``ctx`` on the card, like k/v
    (GQA-native: summed over each kv head's query heads; zero past ctx+l)."""
    ctx = int(ctx)
    _check(q, k, v, do, lse, delta, ctx, "terapipe_attention_dkv")
    b, l, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, sk, hkv, hd), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, sk, hkv, hd), dtype=v.dtype, device=v.device)
    err = _fn("terapipe_attention_dkv", 8, 8, 12)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, l, sk, hq, hkv, hd, ctx,
        int(q.dtype == torch.bfloat16), *_strides(q, k, v, do, dk, dv),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "terapipe_attention_dkv")
    _build.count(terapipe_attention_dkv)
    return dk, dv


terapipe_attention_dq.launches = 0
terapipe_attention_dkv.launches = 0


def terapipe_attention_bwd(q, k, v, do, lse, delta, ctx: int):
    """Fused backward on the card: returns ``(dq, dk, dv)``.

    q/do: (B, l, Hq, hd); k/v: (B, Sk, Hkv, hd); lse/delta: (B, Hq, l)
    float32 (lse from the forward, delta = rowsum(dO * O)); ``ctx`` a
    python int.  dk/dv come back in the Hkv layout.
    """
    dq = terapipe_attention_dq(q, k, v, do, lse, delta, ctx)
    dk, dv = terapipe_attention_dkv(q, k, v, do, lse, delta, ctx)
    return dq, dk, dv
