"""The port's attention ops against the JAX package's Pallas kernels.

Identical numpy-seeded inputs go through ``repro.kernels`` (Pallas in
interpret mode, as ``tests/test_kernels.py`` runs it) and through
``repro_torch.kernels.ops`` on CPU tensors, i.e. the plain PyTorch
versions the CUDA kernels are held against on the card.  Tolerances are
the reference tests': f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_kernel as jax_decode
from repro.kernels.terapipe_attention import terapipe_attention_fwd as jax_fwd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import terapipe_attention_ref

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

DTYPES = [(np.float32, jnp.float32, torch.float32, 2e-5),
          (np.float32, jnp.bfloat16, torch.bfloat16, 2e-2)]


def _both(x, jdt, tdt):
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol)


# (B, l, ctx, Hq, Hkv, hd, Sk, logit scale): ragged l, ctx 0 and > 0, a
# stale tail (Sk > ctx + l), GQA rep 1/2/4, logits x30
PREFILL = [
    (1, 33, 0, 4, 4, 32, 33, 1.0),
    (2, 96, 64, 8, 2, 64, 200, 1.0),
    (1, 100, 100, 4, 2, 32, 256, 1.0),
    (2, 100, 0, 4, 1, 16, 128, 30.0),
]


@pytest.mark.parametrize("ndt,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l,ctx,hq,hkv,hd,sk,scale", PREFILL)
def test_terapipe_attention_matches_jax(b, l, ctx, hq, hkv, hd, sk, scale,
                                        ndt, jdt, tdt, tol):
    rng = np.random.RandomState(l + ctx + hd)
    q = (rng.randn(b, l, hq, hd) * scale).astype(ndt)
    k = rng.randn(b, sk, hkv, hd).astype(ndt)
    v = rng.randn(b, sk, hkv, hd).astype(ndt)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, jdt, tdt), _both(k, jdt, tdt), _both(v, jdt, tdt)

    out = ops.terapipe_attention(tq, tk, tv, ctx_len=ctx)
    _close(out, jops.terapipe_attention(jq, jk, jv, ctx_len=ctx), tol)

    j_out, j_lse = jax_fwd(jq, jk, jv, jnp.int32(ctx), interpret=True)
    t_out, t_lse = terapipe_attention_ref(tq, tk, tv, ctx)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (b, hq, l)
    _close(t_out, j_out, tol)
    _close(t_lse, j_lse, tol)
    assert torch.equal(out, t_out)


# (B, L, Hq, Hkv, hd, kv_len): scalar and per-row lengths, kv_len = 1,
# full length, GQA rep 1/2/4
DECODE = [
    (3, 128, 4, 4, 32, 77),
    (3, 128, 4, 2, 32, [1, 128, 50]),
    (2, 256, 8, 2, 64, [200, 3]),
    (2, 64, 4, 2, 16, 1),
]


@pytest.mark.parametrize("ndt,jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,L,hq,hkv,hd,kv_len", DECODE)
def test_decode_attention_matches_jax(b, L, hq, hkv, hd, kv_len, ndt, jdt, tdt, tol):
    rng = np.random.RandomState(L + hd)
    q = rng.randn(b, 1, hq, hd).astype(ndt)
    k = rng.randn(b, L, hkv, hd).astype(ndt)
    v = rng.randn(b, L, hkv, hd).astype(ndt)
    (jq, tq), (jk, tk), (jv, tv) = _both(q, jdt, tdt), _both(k, jdt, tdt), _both(v, jdt, tdt)
    lens = np.asarray(kv_len, np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    _close(out, jax_decode(jq, jk, jv, jnp.asarray(lens), interpret=True), tol)
    if lens.ndim == 0:                      # python-int kv_len takes the same path
        assert torch.equal(out, ops.decode_attention(tq, tk, tv, int(lens)))
