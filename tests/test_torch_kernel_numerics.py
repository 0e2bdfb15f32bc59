"""The rounding points and reduction orders of the port's Hopper kernels
against the JAX package's Pallas kernels.

The bf16 forward, dQ and dK/dV kernels (``csrc/terapipe_attention_fwd.cu::
fwd_kernel_bf16``, ``csrc/terapipe_attention_bwd.cu::dq_kernel_bf16`` and
``::dkv_kernel_bf16``) run their products on the tensor cores: f32 scores
from bf16 operands, the probabilities P (forward) and P^T (dK/dV) rounded to
bf16 before the products that consume them, dS rounded to bf16 once before
dS.K (dQ), dS^T split into two bf16 parts (hi + its rounding error, two
products) before dS^T.Q (dK), f32 accumulation.  The forward (wgmma) keeps
its running max in raw score units per 128-key tile and takes P =
2^(scale*log2e*(S - m)) against it; the dK/dV kernel (wgmma) takes P^T =
2^(scale*log2e*S^T - lse*log2e), whole rows at once, as the dQ kernel (wgmma)
takes P.  The f32 SIMT kernels they replace kept P and dS in f32.  The decode
kernel (``csrc/decode_attention.cu::decode_kernel``) splits the valid keys
over a cluster of ``DECODE_CLUSTER`` CTAs (``tile_walk.decode_spans``); each
CTA's warps keep online softmax states over boxes of ``DECODE_BOX`` keys,
merged in warp order, then the CTAs' states in rank order.  Plain emulations of that
arithmetic, local to this file, are held against the Pallas kernels in
interpret mode on the cases and at the tolerances of
``tests/test_torch_kernels.py`` (forward bf16 2e-2; decode f32 2e-5, bf16
2e-2) and ``tests/test_torch_kernels_bwd.py`` (backward bf16, 5e-2).  The
CUDA kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_kernel as jax_decode
from repro.kernels.terapipe_attention import terapipe_attention_fwd as jax_fwd
from repro_torch.kernels import tile_walk
from repro_torch.kernels.ref import terapipe_attention_ref

from test_torch_kernels import DECODE, DTYPES, PREFILL
from test_torch_kernels_bwd import CASES

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

KEY_TILE = 128    # keys per K/V tile of fwd_kernel_bf16 (tile_walk.FWD_BK)
C, BOX = tile_walk.DECODE_CLUSTER, tile_walk.DECODE_BOX
LOG2E = 1 / math.log(2)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 and back, as the kernels' operand packing."""
    return t.to(torch.bfloat16).float()


def _expand(t: torch.Tensor, rep: int) -> torch.Tensor:
    return t.float().repeat_interleave(rep, dim=2)


def tc_forward(q, k, v, ctx: int):
    """fwd_kernel_bf16's arithmetic: per 128-key tile, f32 scores of bf16
    operands, the running max m of the raw scores, P = 2^(c*(S - m)) with c =
    log2e/sqrt(hd), the guarded rescale 2^(c*(m_old - m)), P rounded to bf16
    for P.V, the denominator summed from f32 P, lse = m*c*ln2 + log(den);
    returns (O, lse)."""
    b, l, hq, hd = q.shape
    rep = hq // k.shape[2]
    c = LOG2E / math.sqrt(hd)
    qf, kf, vf = q.float(), _expand(k, rep), _expand(v, rep)
    qpos = ctx + torch.arange(l)
    m = torch.full((b, hq, l), -math.inf)
    s = torch.zeros((b, hq, l))
    acc = torch.zeros((b, hq, l, hd))
    for t0 in range(0, ctx + l, KEY_TILE):
        keys = torch.arange(t0, min(t0 + KEY_TILE, ctx + l))
        x = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, keys])
        x = x.masked_fill(keys[None, :] > qpos[:, None], -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.where(m == -math.inf, 0.0, torch.exp2((m - m_new) * c))
        p = torch.exp2(x * c - torch.where(m_new == -math.inf, 0.0, m_new * c)[..., None])
        s = s * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", _bf16(p), vf[:, keys])
        m = m_new
    den = s.clamp_min(1e-30)
    out = (acc / den[..., None]).transpose(1, 2).to(torch.bfloat16)
    return out, m * c * math.log(2) + torch.log(den)


def tc_dkv(q, k, v, do, lse, delta, ctx: int):
    """dkv_kernel_bf16's arithmetic: P^T = 2^(scale*log2e*S^T - lse*log2e)
    in f32 from bf16 operands, dV = bf16(P^T).dO, dP^T = V.dO^T, dS^T = P^T*(dP^T -
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
    p = torch.where(mask, torch.exp2(s * (scale * LOG2E) - lse[..., None] * LOG2E), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), dof)
    ds_hi = _bf16(ds)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_hi + _bf16(ds - ds_hi), qf) * scale
    group = lambda t: t.reshape(b, sk, hkv, rep, hd).sum(3).to(torch.bfloat16)
    return group(dk), group(dv)


def tc_dq(q, k, v, do, lse, delta, ctx: int):
    """dq_kernel_bf16's arithmetic: P = exp(scale*S - lse) in f32 from bf16
    operands, dP = dO.V^T, dS = P*(dP - delta) in f32, dQ = scale *
    bf16(dS).K accumulated in f32, the scale applied at the end; returns dQ
    in bf16."""
    b, l, hq, hd = q.shape
    sk, rep = k.shape[1], hq // k.shape[2]
    scale = 1 / math.sqrt(hd)
    qf, dof, kf, vf = q.float(), do.float(), _expand(k, rep), _expand(v, rep)
    qpos = ctx + torch.arange(l)
    kpos = torch.arange(sk)
    mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < ctx + l)      # (l, Sk)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kf) * scale).to(torch.bfloat16)


def _merge(states):
    """(m, s, acc) states in log2 units merged in the given order: M = max
    m, weights 2^(m - M) (0 for a state that saw nothing, m = -inf)."""
    mx = states[0][0]
    for m, _, _ in states[1:]:
        mx = torch.maximum(mx, m)
    num, den = torch.zeros_like(states[0][2]), torch.zeros_like(states[0][1])
    for m, s, acc in states:
        w = torch.where(m == -math.inf, 0.0, torch.exp2(m - mx))
        num, den = num + acc * w[:, None], den + s * w
    return mx, den, num


def split_decode(q, k, v, kv_len):
    """decode_kernel's arithmetic: q pre-scaled by scale*log2e in f32; each
    rank's span of tile_walk.decode_spans(kv_len) (clamped to [0, L]) in
    boxes of BOX keys, warp w of the rank's tile_walk.decode_warps taking
    boxes w, w + W, ... with an online softmax in log2 units (m the running max, p = 2^(x - m), the
    earlier sums rescaled by 2^(m_old - m)); the warps' states merged in
    order, then the ranks' in rank order: O = sum acc 2^(m - M) /
    max(sum s 2^(m - M), 1e-30), 0 at kv_len 0."""
    b, _, hq, hd = q.shape
    L, rep = k.shape[1], hq // k.shape[2]
    lens = torch.as_tensor(kv_len).reshape(-1).expand(b).clamp(0, L)
    qs = q.float()[:, 0] * (LOG2E / math.sqrt(hd))                # (B, Hq, hd)
    kf, vf = _expand(k, rep), _expand(v, rep)
    n_warps = tile_walk.decode_warps(hd, q.element_size())
    empty = (torch.full((hq,), -math.inf), torch.zeros(hq), torch.zeros((hq, hd)))
    out = torch.zeros((b, 1, hq, hd))
    for bi in range(b):
        ranks = []
        for k0, k1 in tile_walk.decode_spans(int(lens[bi])):
            boxes = list(range(k0, k1, BOX))
            warps = []
            for w in range(n_warps):
                m, s, acc = empty
                for c0 in boxes[w::n_warps]:
                    keys = slice(c0, min(c0 + BOX, k1))
                    x = torch.einsum("hd,khd->hk", qs[bi], kf[bi, keys])
                    m_new = torch.maximum(m, x.amax(-1))
                    alpha = torch.where(m == -math.inf, 0.0, torch.exp2(m - m_new))
                    p = torch.exp2(x - m_new[:, None])
                    s = s * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + torch.einsum("hk,khd->hd", p, vf[bi, keys])
                    m = m_new
                warps.append((m, s, acc))
            ranks.append(_merge(warps))
        _, den, num = _merge(ranks)
        out[bi, 0] = num / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


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


@pytest.mark.parametrize("b,l,ctx,hq,hkv,hd,scale",
                         [c + (1.0,) for c in CASES] + [(1, 100, 0, 4, 4, 64, 30.0)])
def test_tc_dq_matches_pallas(b, l, ctx, hq, hkv, hd, scale):
    """dQ with dS rounded to bf16 once before dS.K, from the emulated
    forward's lse and delta = rowsum(dO*O) in f32, a 5-key stale tail:
    within 5e-2 of jax.vjp through the Pallas dQ kernel, also with logits
    x30 (large q rows), where dK needs dS^T split in two."""
    rng = np.random.RandomState(0)
    sk = ctx + l + 5
    arrs = [rng.randn(*shape).astype(np.float32)
            for shape in ((b, l, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd), (b, l, hq, hd))]
    arrs[0] *= scale

    @jax.jit
    def jax_dq(q, k, v, g):
        _, vjp = jax.vjp(lambda q, k, v: jops.terapipe_attention(q, k, v, ctx_len=ctx), q, k, v)
        return vjp(g)[0]

    j_dq = jax_dq(*(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    out, lse = tc_forward(q, k, v, ctx)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    _close(tc_dq(q, k, v, do, lse, delta, ctx), j_dq, 5e-2, "dQ")


@pytest.mark.parametrize("ndt,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,L,hq,hkv,hd,kv_len", DECODE + [
    (7, BOX * C + 43, 4, 2, 16, [0, 1, C - 1, C, BOX * C - 1, BOX * C + 1, BOX * C + 43]),
    (3, BOX * C + 43, 24, 2, 32, [BOX * C + 1, 0, C - 1])])
def test_split_decode_matches_pallas(b, L, hq, hkv, hd, kv_len, ndt, jdt, tdt, tol):
    """The cluster's split, its warps' online softmax and the merges in
    warp and rank order: within the decode tolerances of the Pallas decode
    kernel, on the DECODE cases and on lengths at the split's edges (0, 1,
    C-1, C, BOX*C-1, BOX*C+1, L), also with GQA 12 (two query-head groups
    of 8 and 4 in the kernel); exactly 0 where kv_len is 0."""
    rng = np.random.RandomState(L + hd)
    arrs = [rng.randn(*shape).astype(ndt)
            for shape in ((b, 1, hq, hd), (b, L, hkv, hd), (b, L, hkv, hd))]
    lens = np.asarray(kv_len, np.int32)
    out = split_decode(*(torch.from_numpy(a).to(tdt) for a in arrs), torch.from_numpy(lens))
    j_out = jax_decode(*(jnp.asarray(a, jdt) for a in arrs), jnp.asarray(lens), interpret=True)
    _close(out, j_out, tol, "O")
    empty = np.broadcast_to(lens, (b,)) == 0
    assert torch.count_nonzero(out[torch.from_numpy(empty)]) == 0
