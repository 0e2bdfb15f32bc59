"""Launch wrapper of the flash prefill kernel (reference:
``repro/kernels/terapipe_attention.py::terapipe_attention_fwd``, whose Pallas
body ``_fwd_kernel`` becomes ``csrc/terapipe_attention_fwd.cu``).

The wrapper checks what the kernel takes, allocates O and lse, and launches
on the current stream without synchronising.  It only takes CUDA tensors:
the plain version for CPU tensors is :func:`repro_torch.kernels.ref.
terapipe_attention_ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 96, 128, 160)
DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    lib = _build.load("terapipe_attention_fwd")
    fn = lib.terapipe_attention_fwd
    fn.argtypes = [_P] * 5 + [_I] * 7 + [_L] * 8 + [_P]
    fn.restype = _I
    return fn


def check_attention_inputs(q, k, v, what: str) -> None:
    """Shared argument checks of the attention kernels: CUDA tensors on one
    device, 16-byte aligned base pointers, and :func:`check_attention_shapes`."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}; the kernel takes "
                             f"CUDA tensors (CPU tensors use the plain version)")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    check_attention_shapes(q, k, v, what)


def check_attention_shapes(q, k, v, what: str) -> None:
    """What the kernels take of shapes, dtypes and strides, on any device
    (the meta routes of :mod:`repro_torch.kernels.ops` check the same): bf16
    or f32, (B, S, H, hd) with dense head and feature dims, rows 16 bytes
    apart (batch and sequence strides that are multiples of 8 elements in
    bf16, whose tiles are copied in 16-byte ``cp.async`` chunks, and of 4
    in f32), a supported head dim and ``Hq % Hkv == 0``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                             f"need one of {DTYPES}")
        if t.dim() != 4:
            raise ValueError(f"{what}: {name} must be 4-d, got {tuple(t.shape)}")
        hd, row = t.shape[3], 16 // t.element_size()
        if t.stride(3) != 1 or t.stride(2) != hd or t.stride(1) % row or t.stride(0) % row:
            raise ValueError(f"{what}: {name} strides {t.stride()} — head and "
                             f"feature dims must be dense, batch and sequence "
                             f"strides multiples of {row} elements ({t.dtype}: "
                             f"16-byte rows)")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {q.shape[3]} not in {HEAD_DIMS}")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"{what}: Hq={q.shape[2]} not a multiple of Hkv={k.shape[2]}")


def terapipe_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           ctx: int):
    """Flash prefill on the card: returns ``(out, lse)``.

    q: (B, l, Hq, hd) at absolute offset ``ctx`` (a python int); k, v:
    (B, Sk, Hkv, hd) with Sk >= ctx + l (keys past ctx + l are masked).
    ``out`` is like q; ``lse`` is (B, Hq, l) float32.
    """
    check_attention_inputs(q, k, v, "terapipe_attention_fwd")
    b, l, hq, hd = q.shape
    ctx = int(ctx)
    if l < 1 or ctx < 0 or k.shape[1] < ctx + l:
        raise ValueError(f"terapipe_attention_fwd: need l >= 1, ctx >= 0 and "
                         f"Sk >= ctx + l; got l={l}, ctx={ctx}, Sk={k.shape[1]}")
    out = torch.empty((b, l, hq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, l), dtype=torch.float32, device=q.device)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, l, hq, k.shape[2], hd, ctx,
                 int(q.dtype == torch.bfloat16), q.stride(0), q.stride(1),
                 k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                 out.stride(0), out.stride(1),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "terapipe_attention_fwd")
    _build.count(terapipe_attention_fwd)
    return out, lse


terapipe_attention_fwd.launches = 0
