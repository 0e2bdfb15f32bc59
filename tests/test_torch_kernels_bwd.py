"""The port's flash-attention backward against the JAX package's.

Identical numpy-seeded inputs go through ``jax.vjp`` of
``repro.kernels.ops.terapipe_attention`` (the custom_vjp whose backward runs
the Pallas dQ and dK/dV kernels, in interpret mode as
``tests/test_kernels_bwd.py`` runs them) and through ``torch.autograd.grad``
of ``repro_torch.kernels.ops.terapipe_attention`` on CPU tensors, i.e. the
``torch.autograd.Function`` with the plain backward the CUDA kernels are held
against on the card.  Cases and tolerances are the reference test's: f32
2e-4, bf16 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import terapipe_attention_ref as jax_attention_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import terapipe_attention_bwd_ref, terapipe_attention_ref

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

DTYPES = [(jnp.float32, torch.float32, 2e-4), (jnp.bfloat16, torch.bfloat16, 5e-2)]

# (B, l, ctx, Hq, Hkv, hd): tests/test_kernels_bwd.py::test_fused_vjp_matches_reference
CASES = [
    (1, 8, 0, 1, 1, 64),       # tiny, no context, Hq/Hkv = 1
    (2, 64, 64, 4, 4, 64),     # ctx == l, dense heads
    (1, 96, 160, 4, 1, 64),    # GQA 4x, ragged 96
    (2, 33, 7, 4, 1, 32),      # GQA 4x, tiny odd shapes
    (1, 100, 0, 4, 4, 64),     # ragged, pure causal
]


def _inputs(b, l, ctx, hq, hkv, hd, sk_extra=0, seed=0):
    """q, k, v, dO as float32 numpy; Sk = ctx + l + sk_extra."""
    rng = np.random.RandomState(seed)
    sk = ctx + l + sk_extra
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((b, l, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd), (b, l, hq, hd))]


def _jax_vjp(fn, arrs, jdt):
    """(out, (dq, dk, dv)) of ``fn`` under one jit (faster than op-by-op)."""
    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(g)
    return run(*(jnp.asarray(a, jdt) for a in arrs))


def _torch_grad(fn, arrs, tdt):
    q, k, v = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in arrs[:3])
    out = fn(q, k, v)
    return out, torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrs[3]).to(tdt))


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _port_op(ctx):
    return lambda q, k, v: ops.terapipe_attention(q, k, v, ctx_len=ctx)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l,ctx,hq,hkv,hd", CASES)
def test_flash_grads_match_jax(b, l, ctx, hq, hkv, hd, jdt, tdt, tol):
    arrs = _inputs(b, l, ctx, hq, hkv, hd)
    j_out, j_grads = _jax_vjp(lambda q, k, v: jops.terapipe_attention(q, k, v, ctx_len=ctx),
                              arrs, jdt)
    t_out, t_grads = _torch_grad(_port_op(ctx), arrs, tdt)
    _close(t_out, j_out, tol, "out")
    for got, want, name in zip(t_grads, j_grads, ("dq", "dk", "dv")):
        assert got.dtype == tdt
        _close(got, want, tol, name)


def test_flash_grads_stale_cache_tail():
    """Sk > ctx + l: keys at and past ctx + l get exactly zero dK/dV."""
    ctx, l = 17, 33
    arrs = _inputs(1, l, ctx, 8, 2, 32, sk_extra=23)
    _, j_grads = _jax_vjp(lambda q, k, v: jops.terapipe_attention(q, k, v, ctx_len=ctx),
                          arrs, jnp.float32)
    _, t_grads = _torch_grad(_port_op(ctx), arrs, torch.float32)
    for got, want, name in zip(t_grads, j_grads, ("dq", "dk", "dv")):
        _close(got, want, 2e-4, name)
    for tail in (t_grads[1][:, ctx + l:], t_grads[2][:, ctx + l:]):
        assert tail.shape[1] == 23 and torch.count_nonzero(tail) == 0


@pytest.fixture(scope="module")
def jax_dyn_ctx():
    """The reference op with ctx as a traced int32 (the executors' path),
    one jit trace for every offset, and its vjp at a fixed cotangent."""
    @jax.jit
    def dyn(q, k, v, g, c):
        out, vjp = jax.vjp(lambda q, k, v: jops.terapipe_attention(q, k, v, ctx_len=c),
                           q, k, v)
        return out, vjp(g)
    return dyn


@pytest.mark.parametrize("ctx", [0, 5, 48])
def test_flash_grads_traced_ctx(ctx, jax_dyn_ctx):
    """tests/test_kernels_bwd.py::test_traced_ctx_matches_static: one K/V
    buffer of 64 keys, the 16-row slice at offsets 0, 5 and 48 (a stale tail
    for all but the last)."""
    arrs = _inputs(1, 16, 48, 4, 2, 32, seed=ctx)
    j_out, j_grads = jax_dyn_ctx(*(jnp.asarray(a) for a in arrs), jnp.int32(ctx))
    t_out, t_grads = _torch_grad(_port_op(torch.tensor(ctx)), arrs, torch.float32)
    _close(t_out, j_out, 2e-4, "out")
    for got, want, name in zip(t_grads, j_grads, ("dq", "dk", "dv")):
        _close(got, want, 2e-4, name)


@pytest.mark.parametrize("b,l,ctx,hq,hkv,hd", CASES)
def test_bwd_ref_matches_jax_vjp_of_ref(b, l, ctx, hq, hkv, hd):
    """The plain backward, fed the forward's lse and delta = rowsum(dO*O),
    against jax.vjp of the JAX package's dense oracle."""
    arrs = _inputs(b, l, ctx, hq, hkv, hd, sk_extra=5, seed=1)
    _, j_grads = _jax_vjp(lambda q, k, v: jax_attention_ref(q, k, v, ctx), arrs, jnp.float32)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    out, lse = terapipe_attention_ref(q, k, v, ctx)
    delta = torch.einsum("blhd,blhd->bhl", do, out)
    grads = terapipe_attention_bwd_ref(q, k, v, do, lse, delta, ctx)
    for got, want, name in zip(grads, j_grads, ("dq", "dk", "dv")):
        assert got.shape == want.shape
        _close(got, want, 2e-4, name)
    assert torch.count_nonzero(grads[1][:, ctx + l:]) == 0
