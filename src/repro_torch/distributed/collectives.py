"""Gradient compression for data-parallel sync (reference:
``repro/distributed/collectives.py``).

Where the data-parallel all-reduce crosses slow links, compressing the
gradients first saves bytes:

* ``bf16_compress``: cast f32 gradients to bf16 before the reduction (2x
  fewer bytes, no state);
* ``int8_ef_compress``: symmetric per-tensor int8 quantization with error
  feedback: the residual is added back the next step, so the compression
  error does not accumulate (Karimireddy et al. 2019).  4x fewer bytes.

They transform the port's nested-dict gradient trees
(:mod:`repro_torch.tree`) leaf by leaf, on the leaves' device, with the
reference's f32 arithmetic in its order, so they give its bits; the
reduction itself is the caller's.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def bf16_compress(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def bf16_decompress(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.float32), grads)


class EFState(NamedTuple):
    residual: Any              # f32 tree


def int8_ef_init(params: Any) -> EFState:
    return EFState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def _quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``scale = max|g| / 127 + 1e-12`` (0-d f32), ``q``
    the int8 of ``g / scale`` rounded half to even and clipped to ±127."""
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _compress_leaf(g: torch.Tensor, r: torch.Tensor):
    corrected = g.to(torch.float32) + r
    q, scale = _quantize(corrected)
    return q, scale, corrected - q.to(torch.float32) * scale


def int8_ef_compress(grads: Any, state: EFState) -> Tuple[Any, Any, EFState]:
    """Returns ``(int8 tree, scales tree, new state)``.  One leaf at a
    time, so the temporaries are one leaf's."""
    out = [_compress_leaf(g, r)
           for g, r in zip(tree_leaves(grads), tree_leaves(state.residual))]
    q, scales, residual = (tree_unflatten(grads, col) for col in zip(*out))
    return q, scales, EFState(residual)


def int8_ef_decompress(q: Any, scales: Any) -> Any:
    return tree_map(lambda qq, s: qq.to(torch.float32) * s, q, scales)
