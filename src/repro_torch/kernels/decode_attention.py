"""Launch wrapper of the flash decode kernel (reference:
``repro/kernels/decode_attention.py::decode_attention_kernel``, whose
Pallas body ``_decode_kernel`` becomes ``csrc/decode_attention.cu``).

CUDA tensors only; CPU tensors take :func:`repro_torch.kernels.ref.
decode_attention_ref` through :mod:`repro_torch.kernels.ops`.

One call launches two kernels: one block per (b, kv head, query-head group,
chunk of ``CHUNK`` keys) writes its partial softmax state to a workspace,
and a merge kernel combines the chunks of each (b, query head) in chunk
order.  ``launches`` counts calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .terapipe_attention import check_attention_inputs

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

CHUNK = 128     # keys per block of the first kernel (kChunk in the source)


def _lib():
    fn = _build.load("decode_attention").decode_attention
    fn.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 6 + [_P]
    fn.restype = _I
    return fn


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            kv_len) -> torch.Tensor:
    """q: (B, 1, Hq, hd); k, v: (B, L, Hkv, hd); ``kv_len`` a python int, a
    0-d tensor or a per-batch (B,) tensor, broadcast to a device int32 (B,)
    vector as ``decode_attention.py:88-89`` does.  Lengths are clamped to
    [0, L] on the card; nothing past them is read."""
    check_attention_inputs(q, k, v, "decode_attention_kernel")
    b, one, hq, hd = q.shape
    if one != 1:
        raise ValueError(f"decode_attention_kernel: q must be (B, 1, Hq, hd), "
                         f"got {tuple(q.shape)}")
    lens = torch.as_tensor(kv_len, device=q.device)
    if lens.dim() > 1 or (lens.dim() == 1 and lens.shape[0] not in (1, b)):
        raise ValueError(f"decode_attention_kernel: kv_len shape {tuple(lens.shape)}")
    lens = lens.to(torch.int32).reshape(-1).expand(b).contiguous()
    out = torch.empty((b, 1, hq, hd), dtype=q.dtype, device=q.device)
    n_chunks = -(-k.shape[1] // CHUNK)
    # the chunks' partial states: acc (B, Hq, n_chunks, hd), then (m, s) of each
    ws = torch.empty(b * hq * n_chunks * (hd + 2), dtype=torch.float32, device=q.device)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lens.data_ptr(), ws.data_ptr(), b, hq, k.shape[2], k.shape[1], hd,
                 int(q.dtype == torch.bfloat16), CHUNK, q.stride(0), k.stride(0),
                 k.stride(1), v.stride(0), v.stride(1), out.stride(0),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_kernel")
    _build.count(decode_attention_kernel)
    return out


decode_attention_kernel.launches = 0
