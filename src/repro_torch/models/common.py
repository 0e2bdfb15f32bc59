"""Shared model building blocks (reference: ``repro/models/common.py``).

Plain functions over tensors and explicit parameter dicts, in the JAX
package's layouts: weights ``(d_in, d_out)`` applied as ``x @ w``, stored in
float32 and cast to the activation dtype at each use.  The activation
sharding helpers of the reference (hints to XLA's sharding propagation)
have no eager counterpart.

Manual tensor parallelism (Megatron, inside the pipeline's stages): where
the reference's ``cfg.tp_axis`` names a mesh axis that the blocks ``psum``
over, the port's is the axis's group (:class:`LocalGroup`, or
``distributed.transport.DistGroup`` across processes).  A group hosts some
ranks of its axis (``ranks``: every one in process, one per process
otherwise), and under it a block's parameters (and caches) are the list of
the hosted ranks' shards, in ``ranks`` order; the activation between the
blocks is replicated, one tensor.  A reducing block runs its partial on
each hosted rank's shard and sums them with ``all_reduce``; without tensor
parallelism it runs the same code on one rank (a dict ``p``, the group a
one-rank ``LocalGroup``).  The serving modes take no group that hosts
several ranks, as the reference's serving has no tensor parallelism; a
group that hosts one rank serves that rank's heads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

F32_MIN = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Port of ``repro.models.common.ModelConfig``: same fields and
    defaults, with torch dtypes."""
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    moe_block: int = 128
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (recurrentgemma) ---
    window: int = 0
    block_pattern: Tuple[str, ...] = ()
    rglru_conv: int = 4
    # --- enc-dec (whisper backbone) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- vlm ---
    n_patches: int = 0
    # --- numerics ---
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "full"
    use_kernel: bool = False         # route attention through the CUDA kernels
    # manual tensor parallelism: the axis's group (LocalGroup, DistGroup);
    # the blocks take the hosted ranks' shards and all_reduce the partials
    tp_axis: Any = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Tensor parallelism: the in-process group and the blocks' helpers
# ---------------------------------------------------------------------------
class _FanOut(torch.autograd.Function):
    """``n`` views of ``x``, whose gradients are summed in order."""

    @staticmethod
    def forward(ctx, x, n: int):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                total = g if total is None else total + g
        return total, None


class LocalGroup:
    """A mesh axis whose every rank lives in this process (virtual ranks,
    the counterpart of ``core/pipeline.py::LocalRing``): ``ranks`` are the
    hosted ranks, all ``size`` of them.  ``all_reduce`` takes one value per
    hosted rank, sums them in rank order (so two runs are bit-identical)
    and hands the sum to each.  ``region(x)`` gives each hosted rank its
    view of the replicated input of a tensor-parallel region (Megatron's
    ``f``); the ranks' gradients of it are summed in rank order, as a
    process group's all_reduce of them would be."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = tuple(range(size))

    def all_reduce(self, values: list) -> list:
        assert len(values) == self.size, (len(values), self.size)
        total = values[0]
        for v in values[1:]:
            total = total + v
        return [total] * self.size

    def region(self, x: torch.Tensor) -> list:
        if self.size == 1:
            return [x]
        return list(_FanOut.apply(x, self.size))

    def __repr__(self) -> str:
        return f"LocalGroup({self.size})"


_NO_TP = LocalGroup(1)


def tp_group(tp_axis):
    """The group a block reduces over: ``tp_axis``, or without tensor
    parallelism (``None``) a one-rank :class:`LocalGroup`, whose ``region``
    and ``all_reduce`` hand the one value back.  The reference's kind, a
    mesh axis name, raises ``TypeError``."""
    if tp_axis is None:
        return _NO_TP
    if not hasattr(tp_axis, "all_reduce"):
        raise TypeError(f"cfg.tp_axis must be a group with ranks, size and all_reduce "
                        f"(LocalGroup, distributed.transport.DistGroup), not {tp_axis!r}")
    return tp_axis


def shards(p) -> list:
    """A block's parameters as the hosted ranks' shards: under tensor
    parallelism ``p`` is that list; a dict ``p`` is the one rank's."""
    return p if isinstance(p, list) else [p]


def per_rank(p, key: str) -> list:
    """Each hosted rank's ``[key]`` of ``p`` (:func:`shards`)."""
    return [q[key] for q in shards(p)]


def replicated(p, key: str):
    """``[key]`` of a leaf every rank holds whole (a norm's scale): the
    first hosted rank's."""
    return shards(p)[0][key]


# ---------------------------------------------------------------------------
# Initializers (same distributions as the reference; torch.Generator keys).
# Every leaf is made on ``gen.device``.
# ---------------------------------------------------------------------------
class MetaDraws(torch.Generator):
    """A CPU generator whose ``device`` says ``meta``: the initializers
    draw on the meta device through it, so every leaf gets its shape and
    dtype and no storage (torch has no generator on ``meta``; a draw there
    takes a CPU one and reads nothing from it)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """The seeded generator of an init on ``device``: a ``torch.Generator``
    there, or :class:`MetaDraws` for ``meta``."""
    gen = MetaDraws() if device.type == "meta" else torch.Generator(device=device)
    return gen.manual_seed(seed)


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               dtype=torch.float32) -> torch.Tensor:
    """LeCun-normal over fan-in."""
    return (_randn(gen, shape) / math.sqrt(shape[in_axis])).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return (_randn(gen, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x_gate) * x_up


# ---------------------------------------------------------------------------
# RoPE (split-halves layout, computed in float32)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., :, None].float() * freqs                  # (..., seq, hd/2)
    angles = angles[..., :, None, :]                                   # (..., seq, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain path; the kernel path lives in repro_torch.kernels)
# ---------------------------------------------------------------------------
def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, kv, hd) -> (B, S, kv*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def attention_scores(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, H, hd)
    v: torch.Tensor,            # (B, Sk, H, hd)
    *,
    mask: Optional[torch.Tensor] = None,   # broadcastable to (B, H, Sq, Sk); True = keep
) -> torch.Tensor:
    """Dense-head attention (K/V already repeated to Hq heads).  Logits in
    float32; masked logits take ``finfo(f32).min``, as the reference."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, F32_MIN)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_scores_gqa(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Sk, Hkv, hd), Hkv divides Hq
    v: torch.Tensor,            # (B, Sk, Hkv, hd)
    *,
    mask: Optional[torch.Tensor] = None,   # broadcastable to (B, Sq, Sk); True = keep
) -> torch.Tensor:
    """Grouped attention without repeating K/V.  Logits in float32; masked
    logits take ``finfo(f32).min`` (not ``-inf``), as the reference."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, sq, hkv, rep, hd)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, F32_MIN)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, sq, hq, hd)


def causal_mask(sq: int, sk: int, q_offset: int = 0, device=None) -> torch.Tensor:
    """Queries at absolute positions q_offset..q_offset+sq-1 over keys at
    0..sk-1.  True = attend."""
    qp = torch.arange(sq, device=device)[:, None] + q_offset
    kp = torch.arange(sk, device=device)[None, :]
    return qp >= kp


def local_causal_mask(sq: int, sk: int, window: int, q_offset: int = 0,
                      device=None) -> torch.Tensor:
    """:func:`causal_mask` that also drops keys ``window`` or more
    positions behind the query (sliding-window attention)."""
    qp = torch.arange(sq, device=device)[:, None] + q_offset
    kp = torch.arange(sk, device=device)[None, :]
    return (qp >= kp) & (qp - kp < window)
