"""The port's qwen3 model against the JAX model, on converted weights.

qwen3 SMOKE at f32: the JAX parameters go through ``params_from_jax`` and
both models prefill and decode the same numpy-seeded tokens.  Logits and
caches must agree at the ``test_sliced_equivalence.py`` tolerance (2e-4),
with attention on the plain path and routed through the kernel ops
(``use_kernel``: Pallas interpret mode on the JAX side, the plain CPU
versions on the port's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import common as jc
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import common as tc
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
B, PROMPT, MAX_LEN = 2, 37, 64


def _models(use_kernel):
    jcfg = jax_get_config("qwen3-0.6b", smoke=True).replace(
        dtype=jnp.float32, use_kernel=use_kernel)
    jmodel = jax_build_model(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_config("qwen3-0.6b", smoke=True).replace(
        dtype=torch.float32, use_kernel=use_kernel)
    tmodel = build_model(tcfg, device="cpu")
    return jmodel, jparams, tmodel, params_from_jax(jax.device_get(jparams), "cpu")


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_decode_match_jax(use_kernel):
    jmodel, jparams, tmodel, tparams = _models(use_kernel)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 256, size=(B, PROMPT)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    assert tl.shape == (B, 1, 256) and tl.dtype == torch.float32
    _close(tl, jl)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        _close(tk, jk)
        _close(tv, jv)

    nxt = rng.randint(0, 256, size=(B, 1)).astype(np.int32)
    # a scalar position, and a per-row vector (rows at their own depths)
    for pos in (np.int32(PROMPT), np.array([PROMPT, 20], np.int32)):
        jl2, jc2 = jmodel.decode_step(jparams, jc, {"tokens": jnp.asarray(nxt)},
                                      jnp.asarray(pos))
        caches = [tuple(c.clone() for c in group) for group in tc]
        tl2, tc2 = tmodel.decode_step(tparams, caches, {"tokens": torch.from_numpy(nxt)},
                                      torch.from_numpy(np.asarray(pos)))
        _close(tl2, jl2)
        _close(tc2[0][0], jc2[0][0])
        _close(tc2[0][1], jc2[0][1])


def test_params_round_trip_and_bf16():
    jmodel, jparams, _, _ = _models(False)
    host = jax.device_get(jparams)
    flat_j = jax.tree_util.tree_leaves_with_path(host)

    def leaf(tree, path):
        for key in path:
            tree = tree[key.key]
        return tree

    f32 = params_from_jax(host, "cpu")
    bf16 = params_from_jax(host, "cpu", dtype=torch.bfloat16)
    from_bf16 = params_from_jax(jax.tree.map(lambda a: a.astype(jnp.bfloat16), host), "cpu")
    assert len(flat_j) == 13
    for path, a in flat_j:
        t = leaf(f32, path)
        assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
        assert np.array_equal(t.numpy(), np.asarray(a))
        want = np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
        assert leaf(bf16, path).dtype == torch.bfloat16
        assert np.array_equal(leaf(bf16, path).float().numpy(), want)
        assert leaf(from_bf16, path).dtype == torch.bfloat16
        assert np.array_equal(leaf(from_bf16, path).float().numpy(), want)


def test_layer_functions_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 4, 32).astype(np.float32)
    scale = rng.randn(32).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None, :] + 7
    tx = torch.from_numpy(x)
    _close(tc.rms_norm(tx, torch.from_numpy(scale)), jc.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    _close(tc.apply_rope(tx, torch.from_numpy(pos), 1e6),
           jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    _close(tc.swiglu(tx, tx + 1), jc.swiglu(jnp.asarray(x), jnp.asarray(x) + 1))
    _close(tc.repeat_kv(tx, 3), jc.repeat_kv(jnp.asarray(x), 3))
    mask = np.array(jc.causal_mask(5, 9, q_offset=4))        # a writable copy
    assert np.array_equal(tc.causal_mask(5, 9, q_offset=4).numpy(), mask)
    k = rng.randn(2, 9, 2, 32).astype(np.float32)
    _close(tc.attention_scores_gqa(tx, torch.from_numpy(k), torch.from_numpy(k),
                                   mask=torch.from_numpy(mask)[None]),
           jc.attention_scores_gqa(jnp.asarray(x), jnp.asarray(k), jnp.asarray(k),
                                   mask=jnp.asarray(mask)[None]))
