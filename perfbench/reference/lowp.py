"""Products in fp8, the precision below the configurations' bfloat16: the
control that the benchmark's comparison has to fail.  Each product's two
inputs are rounded to e4m3 and its output's gradient to e5m2, each tensor
with one scale that maps its largest magnitude onto the format's largest
number (the usual recipe of fp8 training); the product itself is then
exact in float32."""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale, back in float32."""
    if x.numel() == 0:
        return x
    top = torch.finfo(dtype).max
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a, torch.float8_e4m3fn), quantize(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, torch.float8_e5m2)
        da = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            db = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            db = qa.transpose(-1, -2) @ qg
        return da, db


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8MatMul.apply(a, b)
