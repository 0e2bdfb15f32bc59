"""The rounding points of the port's tensor-core kernels against the JAX
package's Pallas kernels.

The bf16 forward and dK/dV kernels (``csrc/terapipe_attention_fwd.cu::
fwd_kernel_bf16``, ``csrc/terapipe_attention_bwd.cu::dkv_kernel_bf16``) run
their products on the tensor cores: f32 scores from bf16 operands, the
probabilities P (forward) and P^T (dK/dV) rounded to bf16 before the
products that consume them, dS^T split into two bf16 parts (hi + its
rounding error, two products), f32 accumulation.  The f32 SIMT kernels they
replace kept P and dS in f32.  A plain emulation of that arithmetic, local
to this file (64-key tiles and the guarded online softmax for the forward),
is held against the Pallas kernels in interpret mode on the cases and at
the bf16 tolerances of ``tests/test_torch_kernels.py`` (forward, 2e-2) and
``tests/test_torch_kernels_bwd.py`` (backward, 5e-2).  The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.terapipe_attention import terapipe_attention_fwd as jax_fwd
from repro_torch.kernels.ref import terapipe_attention_ref

from test_torch_kernels import PREFILL
from test_torch_kernels_bwd import CASES

KEY_TILE = 64     # keys per K/V tile of fwd_kernel_bf16


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 and back, as the kernels' operand packing."""
    return t.to(torch.bfloat16).float()


def _expand(t: torch.Tensor, rep: int) -> torch.Tensor:
    return t.float().repeat_interleave(rep, dim=2)


def tc_forward(q, k, v, ctx: int):
    """fwd_kernel_bf16's arithmetic: per 64-key tile, f32 scores of bf16
    operands, the online softmax in f32 with the guarded rescale, P rounded
    to bf16 for P.V, the denominator summed from f32 P; returns (O, lse)."""
    b, l, hq, hd = q.shape
    rep = hq // k.shape[2]
    qf, kf, vf = q.float(), _expand(k, rep), _expand(v, rep)
    qpos = ctx + torch.arange(l)
    m = torch.full((b, hq, l), -math.inf)
    s = torch.zeros((b, hq, l))
    acc = torch.zeros((b, hq, l, hd))
    for t0 in range(0, ctx + l, KEY_TILE):
        keys = torch.arange(t0, min(t0 + KEY_TILE, ctx + l))
        x = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, keys]) / math.sqrt(hd)
        x = x.masked_fill(keys[None, :] > qpos[:, None], -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.where(m == -math.inf, 0.0, torch.exp(m - m_new))
        p = torch.exp(x - torch.where(m_new == -math.inf, 0.0, m_new)[..., None])
        s = s * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", _bf16(p), vf[:, keys])
        m = m_new
    den = s.clamp_min(1e-30)
    out = (acc / den[..., None]).transpose(1, 2).to(torch.bfloat16)
    return out, m + torch.log(den)


def tc_dkv(q, k, v, do, lse, delta, ctx: int):
    """dkv_kernel_bf16's arithmetic: P^T = exp(scale*S^T - lse) in f32 from
    bf16 operands, dV = bf16(P^T).dO, dP^T = V.dO^T, dS^T = P^T*(dP^T -
    delta) in f32, dK = scale * (hi + lo).Q with hi = bf16(dS^T) and lo =
    bf16(dS^T - hi), all accumulated in f32 and summed over each kv head's
    query heads; returns (dK, dV) in bf16."""
    b, l, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1 / math.sqrt(hd)
    qf, dof, kf, vf = q.float(), do.float(), _expand(k, rep), _expand(v, rep)
    qpos = ctx + torch.arange(l)
    kpos = torch.arange(sk)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < ctx + l)      # (l, Sk)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), dof)
    ds_hi = _bf16(ds)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_hi + _bf16(ds - ds_hi), qf) * scale
    group = lambda t: t.reshape(b, sk, hkv, rep, hd).sum(3).to(torch.bfloat16)
    return group(dk), group(dv)


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("b,l,ctx,hq,hkv,hd,sk,scale", PREFILL)
def test_tc_forward_matches_pallas(b, l, ctx, hq, hkv, hd, sk, scale):
    """O and lse with P rounded to bf16 before P.V: within 2e-2 of the
    Pallas forward and of the port's plain version (P kept in f32)."""
    rng = np.random.RandomState(l + ctx + hd)
    arrs = [(rng.randn(b, l, hq, hd) * scale).astype(np.float32),
            rng.randn(b, sk, hkv, hd).astype(np.float32),
            rng.randn(b, sk, hkv, hd).astype(np.float32)]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    out, lse = tc_forward(tq, tk, tv, ctx)
    j_out, j_lse = jax_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in arrs), jnp.int32(ctx),
                           interpret=True)
    _close(out, j_out, 2e-2, "O")
    _close(lse, j_lse, 2e-2, "lse")
    ref_out, ref_lse = terapipe_attention_ref(tq, tk, tv, ctx)
    _close(out, ref_out.float().numpy(), 2e-2, "O vs plain")
    _close(lse, ref_lse.numpy(), 2e-2, "lse vs plain")


@pytest.mark.parametrize("b,l,ctx,hq,hkv,hd", CASES)
def test_tc_dkv_matches_pallas(b, l, ctx, hq, hkv, hd):
    """dK and dV with P^T rounded to bf16 and dS^T split into bf16 hi + lo,
    from the emulated forward's lse and delta = rowsum(dO*O) in f32 (as
    ``ops._FlashAttention.backward``), a 5-key stale tail: within 5e-2 of
    jax.vjp through the Pallas dQ/dK/dV kernels, and exactly zero on the
    tail."""
    rng = np.random.RandomState(0)
    sk = ctx + l + 5
    arrs = [rng.randn(*shape).astype(np.float32)
            for shape in ((b, l, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd), (b, l, hq, hd))]

    @jax.jit
    def jax_grads(q, k, v, g):
        _, vjp = jax.vjp(lambda q, k, v: jops.terapipe_attention(q, k, v, ctx_len=ctx), q, k, v)
        return vjp(g)

    _, j_dk, j_dv = jax_grads(*(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    out, lse = tc_forward(q, k, v, ctx)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = tc_dkv(q, k, v, do, lse, delta, ctx)
    _close(dk, j_dk, 5e-2, "dK")
    _close(dv, j_dv, 5e-2, "dV")
    assert torch.count_nonzero(dk[:, ctx + l:]) == 0
    assert torch.count_nonzero(dv[:, ctx + l:]) == 0
