"""Mamba-2 (SSD, state-space duality) block, the chunked algorithm
(reference: ``repro/models/ssm.py``).

The chunked SSD recurrence *is* token slicing: each chunk consumes a carried
recurrent state and emits an updated one.  TeraPipe's sliced execution for
this family therefore carries ``(conv_state, ssm_state)`` between slices
instead of a KV cache, and the per-slice cost is about linear in the slice
length.

Shapes: x (B, L, H, P) heads x headdim; B/C (B, L, N) with ngroups=1; A (H,).

Plain PyTorch, as the reference computes all of it outside Pallas.  What
differs from the reference, and why the result does not:

* The reference's three-operand einsums are explicit two-step products in
  ``ssd_chunked``, in the order that never builds a tensor with both chunk
  axes and the head dim: ``(cb * seg) @ x̄`` holds the ``(b, c, H, t, s)``
  weights (671 MB in f32 at batch 4 x seq 2048, chunk 256, 80 heads),
  where ``einsum`` is free to build the ``(b, c, H, t, s, P)`` product (64
  times as large).
* The ``lax.scan`` over chunks is a Python loop of ``L / chunk`` steps, out
  of place, so autograd differentiates it as written.
* Manual tensor parallelism (``cfg.tp_axis``) raises, as the reference's
  assert does (``models/ssm.py:137``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init, rms_norm


def check_no_tp(cfg: ModelConfig) -> None:
    if cfg.tp_axis is not None:
        raise NotImplementedError("mamba2 blocks do not support manual tensor parallelism "
                                  "(cfg.tp_axis), as the reference asserts (models/ssm.py:137)")


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Lc) log-decays -> (..., Lc, Lc) with [t, s] = sum_{r=s+1..t} a_r
    for s <= t, -inf otherwise."""
    lc = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]          # [t,s] = cum_t - cum_s
    idx = torch.arange(lc, device=a.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x, dt, A, B, C, D, chunk: int, initial_state=None):
    """Chunked SSD scan.

    x: (b, L, H, P); dt: (b, L, H) (post-softplus); A: (H,) (negative);
    B, C: (b, L, N); D: (H,) skip.
    Returns (y (b, L, H, P) in x's dtype, final_state (b, H, P, N) f32).
    """
    b, L, H, P = x.shape
    N = B.shape[-1]
    assert L % chunk == 0, (L, chunk)
    nc = L // chunk
    f32 = torch.float32
    xr = x.reshape(b, nc, chunk, H, P).to(f32)
    dtr = dt.reshape(b, nc, chunk, H).to(f32)
    Br = B.reshape(b, nc, chunk, N).to(f32)
    Cr = C.reshape(b, nc, chunk, N).to(f32)
    a = dtr * A.to(f32)[None, None, None, :]              # (b, nc, Lc, H) log decay
    a_h = a.transpose(-1, -2)                             # (b, nc, H, Lc)
    cum = torch.cumsum(a_h, dim=-1)                       # (b, nc, H, Lc)
    seg = torch.exp(_segsum(a_h))                         # (b, nc, H, Lc, Lc)

    xdt = xr * dtr[..., None]                             # x̄ = dt * x
    xdt_h = xdt.permute(0, 1, 3, 2, 4)                    # (b, nc, H, Lc, P)
    # intra-chunk (quadratic, "attention-like" term):
    # "bcts,bchts,bcshp->bcthp" as (cb * seg) @ x̄
    cb = Cr @ Br.transpose(-1, -2)                        # (b, nc, Lc, Lc)
    y_intra = (cb[:, :, None] * seg) @ xdt_h              # (b, nc, H, Lc, P)

    # per-chunk end state contribution: sum_s exp(cum_end - cum_s) B_s x̄_s
    # ("bchs,bcsn,bcshp->bchpn" as (decay * x̄)^T @ B)
    decay_to_end = torch.exp(cum[..., -1:] - cum)         # (b, nc, H, Lc)
    chunk_state = (xdt_h * decay_to_end[..., None]).transpose(-1, -2) @ Br[:, :, None]
    chunk_decay = torch.exp(cum[..., -1])                 # (b, nc, H)

    S = (torch.zeros((b, H, P, N), dtype=f32, device=x.device) if initial_state is None
         else initial_state.to(f32))
    s_ins = []
    for c in range(nc):                                   # state entering each chunk
        s_ins.append(S)
        S = S * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    S_ins = torch.stack(s_ins, dim=1)                     # (b, nc, H, P, N)

    # inter-chunk: y_t += C_t · (exp(cum_t) * S_in)
    # ("bctn,bcht,bchpn->bcthp" as (C @ S_in^T) * exp(cum))
    y_inter = (Cr[:, :, None] @ S_ins.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4) + xr * D.to(f32)[None, None, None, :, None]
    return y.reshape(b, L, H, P).to(x.dtype), S


def init_mamba2(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=gen.device)
    return {
        # projections: z (gate), x, B, C, dt
        "in_proj": dense_init(gen, (d, 2 * d_inner + 2 * N + H)),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim)) * 0.1,
        "conv_b": zeros(conv_dim),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=gen.device)),
        "D": torch.ones((H,), dtype=torch.float32, device=gen.device),
        "dt_bias": zeros(H),
        "norm": zeros(d_inner),
        "out_proj": dense_init(gen, (d_inner, d)),
        "ln": zeros(d),
    }


def mamba2_specs(cfg: ModelConfig):
    """The logical axes of :func:`init_mamba2`'s leaves."""
    return {"in_proj": ("embed", "ff"), "conv_w": (None, "ff"), "conv_b": ("ff",),
            "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
            "norm": ("ff",), "out_proj": ("ff", "embed"), "ln": (None,)}


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    H = d_inner // cfg.ssm_head_dim
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    return z, xbc, dt                                      # (…,d_inner), (…,d_inner+2N), (…,H)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  xbc (b, L, Cc); w (k, Cc).
    conv_state (b, k-1, Cc) = trailing inputs from the previous slice."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                      # (b, L+k-1, Cc)
    L = xbc.shape[1]
    out = sum(xp[:, i:i + L, :] * w[i][None, None, :].to(xbc.dtype) for i in range(k))
    new_state = xp[:, -(k - 1):, :]
    return F.silu(out + bias.to(xbc.dtype)), new_state


def mamba2_block(p, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Full/sliced forward.  x (b, L, d).  state = (conv_state, ssm_state) | None.
    Returns (y, new_state)."""
    check_no_tp(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = d_inner // P
    h = rms_norm(x, p["ln"])
    proj = h @ p["in_proj"].to(h.dtype)
    z, xbc, dt = _split_proj(cfg, proj)
    conv_state = None if state is None else state[0]
    ssm_state = None if state is None else state[1]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, B, C = torch.split(xbc, [d_inner, N, N], dim=-1)
    b, L, _ = xs.shape
    xs = xs.reshape(b, L, H, P)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    chunk = min(cfg.ssm_chunk, L)
    while L % chunk:                       # largest divisor of L <= ssm_chunk
        chunk -= 1
    y, new_ssm = ssd_chunked(xs, dt, A, B, C, p["D"], chunk, initial_state=ssm_state)
    y = y.reshape(b, L, d_inner) * F.silu(z)
    y = rms_norm(y, p["norm"])
    out = y @ p["out_proj"].to(y.dtype)
    return x + out, (new_conv, new_ssm)


def mamba2_decode(p, cfg: ModelConfig, x_tok: torch.Tensor, state):
    """Single-token recurrent step.  x_tok (b, 1, d)."""
    check_no_tp(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = d_inner // P
    conv_state, ssm_state = state
    h = rms_norm(x_tok, p["ln"])
    proj = h @ p["in_proj"].to(h.dtype)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, B, C = torch.split(xbc, [d_inner, N, N], dim=-1)
    b = xs.shape[0]
    xs = xs.reshape(b, H, P).float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"][None, :])          # (b, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])                                 # (b, H)
    Bf, Cf = B[:, 0].float(), C[:, 0].float()                          # (b, N)
    # "bhp,bn,bh->bhpn" and "bn,bhpn->bhp"
    new_ssm = (ssm_state.float() * decay[..., None, None]
               + (xs * dt[..., None])[..., None] * Bf[:, None, None, :])
    y = (new_ssm @ Cf[:, None, :, None])[..., 0] + xs * p["D"][None, :, None]
    y = y.reshape(b, 1, d_inner).to(x_tok.dtype) * F.silu(z)
    y = rms_norm(y, p["norm"])
    return x_tok + y @ p["out_proj"].to(y.dtype), (new_conv, new_ssm)


def init_ssm_state(cfg: ModelConfig, batch: int, n_layers: int, device=None):
    """Zero ``(conv, ssm)`` states of ``n_layers`` layers, float32 whatever
    the activation dtype (as the reference's)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    conv = torch.zeros((n_layers, batch, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state),
                       dtype=torch.float32, device=device)
    ssm = torch.zeros((n_layers, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device)
    return conv, ssm
