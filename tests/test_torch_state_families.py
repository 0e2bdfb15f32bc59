"""The port's state-carrying families against the JAX package: mamba2
(``models/ssm.py``, the ``ssm`` group) and recurrentgemma
(``models/rglru.py``, the ``super`` (rec, rec, windowed attn) and ``tail``
groups), with the windowed attention modes, the ring decode and the
pipeline's post-groups; also the three dense configs ported with them
(phi3-mini, phi4-mini, stablelm-12b).

SMOKE configs at f32: the JAX parameters go through ``params_from_jax`` and
both packages run the same numpy-seeded inputs, held at the
``tests/test_sliced_equivalence.py`` tolerance (2e-4).  Token slicing is
exact for a state family because the state is carried across slices and
reset at every microbatch; the pipelined loss is held to JAX's
``model.loss`` within 2e-5, the bound of the reference's
``tests/test_system.py::test_terapipe_state_family_pipeline_matches``.

The reference's ring decode attends past the window when the cache is
longer than the window (``repro/models/attention.py:255-260``; prefill
builds caches of ``max_len``); the port's does not, and
``test_ring_decode_past_window_continues_forward`` pins both.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh, use_mesh
from repro.configs import get_config as jax_get_config
from repro.core import pipeline as jax_pipeline
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad, value_and_grad
from repro_torch.launch import train as train_launch
from repro_torch.models import attention, build_model, lm, rglru, ssm
from repro_torch.tree import jax_items, tree_items, tree_leaves, tree_map
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
PIPE_LOSS_TOL = 2e-5
MAMBA, RG = "mamba2-2.7b", "recurrentgemma-9b"
ARCHS = (MAMBA, RG)
B, S = 4, 32                 # the reference system test's batch and length
SLICE_SETS = ((16, 8, 8), (8, 8, 8, 8), (24, 8))   # tests/test_sliced_equivalence.py's
WINDOW = 16                  # recurrentgemma SMOKE


def _configs(arch, **kw):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32, **kw)
    tcfg = get_config(arch, smoke=True).replace(dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """Per arch: the JAX model, one set of parameters as numpy arrays and
    the port's model.  The parameters are the port's init (JAX's eager init
    takes seconds), checked leaf for leaf against the structure, shapes and
    dtypes of the JAX init's."""
    out = {}
    for arch in ARCHS + ("phi3-mini-3.8b",):
        jcfg, tcfg = _configs(arch)
        jmodel, tmodel = jax_build_model(jcfg), build_model(tcfg, device="cpu")
        params = jax.tree.map(np.asarray, tree_map(lambda a: a.numpy(), tmodel.init(0)))
        shapes = jax.eval_shape(lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0))
        assert jax.tree.structure(params) == jax.tree.structure(shapes)
        for a, want in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
            assert a.shape == want.shape and a.dtype == want.dtype
        out[arch] = (jmodel, params, tmodel)
    return out


@pytest.fixture(scope="module")
def jax_loss_grads(models):
    """Per state arch: jax.value_and_grad(model.loss) on ``_batch()``."""
    out = {}
    for arch in ARCHS:
        jmodel, jparams, _ = models[arch]
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
            jparams, {k: jnp.asarray(v) for k, v in _batch().items()})
        out[arch] = float(loss), jax.device_get(grads)
    return out


def _batch(seed=0, b=B, s=S):
    toks = np.random.RandomState(seed).randint(0, 256, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


def _check_tree(port, ref):
    """Every leaf of ``port`` against ``ref``'s, matched by path."""
    want = dict(jax_items(ref))
    got = dict(tree_items(port))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[path]), rtol=TOL,
                                   atol=TOL, err_msg=path)
    return len(got)


def _layer0(jparams, group):
    """Layer 0's parameters of ``group`` (numpy)."""
    return jax.tree.map(lambda a: a[0], jparams["groups"][group])


# -------------------------------------------------------------- mamba2 parts
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "carried-state"])
def test_ssd_chunked_matches_jax(with_state):
    """Output and final state of the chunked SSD scan, 4 chunks of 8, with
    and without an initial state."""
    rng = np.random.RandomState(1)
    b, L, H, P, N = 2, 32, 3, 8, 5
    x = rng.randn(b, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, L, H))).astype(np.float32)
    A = -np.exp(rng.randn(H)).astype(np.float32)
    Bm, Cm = (rng.randn(b, L, N).astype(np.float32) for _ in range(2))
    D = rng.randn(H).astype(np.float32)
    s0 = rng.randn(b, H, P, N).astype(np.float32) if with_state else None
    jy, js = jax.jit(lambda *a: jax_ssm.ssd_chunked(*a, 8, initial_state=s0))(
        x, dt, A, Bm, Cm, D)
    ty, ts = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), _t(D), 8,
                             initial_state=None if s0 is None else _t(s0))
    assert ty.shape == (b, L, H, P) and ts.dtype == torch.float32
    _close(ty, jy)
    _close(ts, js)


def test_causal_conv_with_carried_state_matches_jax():
    """The depthwise causal conv on two slices, the second starting from the
    first's trailing state, against JAX's and against one pass."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 12, 6).astype(np.float32)
    w, bias = rng.randn(4, 6).astype(np.float32), rng.randn(6).astype(np.float32)
    conv = jax.jit(jax_ssm._causal_conv)
    j_one, _ = conv(x, w, bias)
    j_a, j_sa = conv(x[:, :5], w, bias)
    j_b, j_sb = conv(x[:, 5:], w, bias, j_sa)
    t_a, t_sa = ssm._causal_conv(_t(x[:, :5]), _t(w), _t(bias))
    t_b, t_sb = ssm._causal_conv(_t(x[:, 5:]), _t(w), _t(bias), t_sa)
    for t, j in ((t_a, j_a), (t_sa, j_sa), (t_b, j_b), (t_sb, j_sb)):
        _close(t, j)
    _close(torch.cat([t_a, t_b], 1), j_one)


def test_mamba2_block_and_decode_match_jax(models):
    """mamba2_block on a slice from a carried state (output and both new
    states), then mamba2_decode of one token from that state."""
    jmodel, jparams, _ = models[MAMBA]
    jcfg, tcfg = _configs(MAMBA)
    jp = _layer0(jparams, "blocks")
    tp = params_from_jax(jp, "cpu")
    rng = np.random.RandomState(3)
    x = rng.randn(2, 24, tcfg.d_model).astype(np.float32)
    tok = rng.randn(2, 1, tcfg.d_model).astype(np.float32)
    conv, st = (a[0] for a in jax_ssm.init_ssm_state(jcfg, 2, 1))
    conv = rng.randn(*conv.shape).astype(np.float32)
    st = rng.randn(*st.shape).astype(np.float32)
    jy, (jc, js) = jax.jit(lambda p, x, st: jax_ssm.mamba2_block(p, jcfg, x, st))(
        jp, x, (conv, st))
    ty, (tc, ts) = ssm.mamba2_block(tp, tcfg, _t(x), (_t(conv), _t(st)))
    for t, j in ((ty, jy), (tc, jc), (ts, js)):
        _close(t, j)
    jd, (jdc, jds) = jax.jit(lambda p, x, st: jax_ssm.mamba2_decode(p, jcfg, x, st))(
        jp, tok, (jc, js))
    td, (tdc, tds) = ssm.mamba2_decode(tp, tcfg, _t(tok), (tc, ts))
    for t, j in ((td, jd), (tdc, jdc), (tds, jds)):
        _close(t, j)


# ----------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
def test_rglru_scan_matches_jax(with_h0):
    """The doubling scan against associative_scan at a length that is no
    power of two, with decays near 0 and near 1."""
    rng = np.random.RandomState(4)
    a = np.exp(-8.0 * rng.rand(2, 37, 5)).astype(np.float32)
    a[:, :, 0] = 0.999
    b = rng.randn(2, 37, 5).astype(np.float32)
    h0 = rng.randn(2, 5).astype(np.float32) if with_h0 else None
    want = jax.jit(jax_rglru._rglru_scan)(a, b, h0)
    got = rglru._rglru_scan(_t(a), _t(b), None if h0 is None else _t(h0))
    _close(got, want)
    # and against the recurrence itself, token by token
    h = _t(h0) if with_h0 else torch.zeros(2, 5)
    for t in range(37):
        h = _t(a)[:, t] * h + _t(b)[:, t]
    _close(got[:, -1], h.numpy())


def test_rec_block_matches_jax(models):
    """rec_block from a carried (conv, h) state, then the one-token decode,
    and the tp_axis refusal."""
    _, jparams, _ = models[RG]
    jcfg, tcfg = _configs(RG)
    jp = _layer0(jparams, "tail")
    tp = params_from_jax(jp, "cpu")
    rng = np.random.RandomState(5)
    x = rng.randn(2, 20, tcfg.d_model).astype(np.float32)
    conv = rng.randn(2, tcfg.rglru_conv - 1, tcfg.d_model).astype(np.float32)
    h0 = rng.randn(2, tcfg.d_model).astype(np.float32)
    rec = jax.jit(lambda p, x, st: jax_rglru.rec_block(p, jcfg, x, st))
    jy, (jc, jh) = rec(jp, x, (conv, h0))
    ty, (tc, th) = rglru.rec_block(tp, tcfg, _t(x), (_t(conv), _t(h0)))
    for t, j in ((ty, jy), (tc, jc), (th, jh)):
        _close(t, j)
    jd, (jdc, jdh) = rec(jp, x[:, :1], (jc, jh))      # rec_block_decode is rec_block
    td, (tdc, tdh) = rglru.rec_block_decode(tp, tcfg, _t(x[:, :1]), (tc, th))
    for t, j in ((td, jd), (tdc, jdc), (tdh, jdh)):
        _close(t, j)
    with pytest.raises(NotImplementedError, match="w_a and w_i"):
        rglru.rec_block(tp, tcfg.replace(tp_axis="model"), _t(x))
    with pytest.raises(NotImplementedError, match="mamba2"):
        ssm.mamba2_block(_layer0(params_from_jax(models[MAMBA][1], "cpu"), "blocks"),
                         _configs(MAMBA)[1].replace(tp_axis="model"), _t(x))


# ------------------------------------------------------- windowed attention
def _attn_inputs(models, s, seed=6):
    _, jparams, _ = models[RG]
    jp = jax.tree.map(lambda a: a[0], jparams["groups"]["super"]["attn"]["attn"])
    x = np.random.RandomState(seed).randn(2, s, 64).astype(np.float32) * 0.5
    return jp, params_from_jax(jp, "cpu"), x


@pytest.mark.parametrize("s", [40, 2064], ids=["dense-mask", "blocked"])
def test_windowed_attn_full_matches_jax(models, s):
    """attn_full with the window at 40 tokens (the local causal mask) and
    at 2064 (the blocked path above 2048 tokens, which trims each query
    chunk's keys to its window); use_kernel stays on the plain route."""
    jcfg, tcfg = _configs(RG)
    jp, tp, x = _attn_inputs(models, s)
    x = x[:1]
    want = jax.jit(lambda p, x: jax_attn.attn_full(p, jcfg, x, window=WINDOW))(jp, x)
    got = attention.attn_full(tp, tcfg.replace(use_kernel=True), _t(x), window=WINDOW)
    _close(got, want)


def test_windowed_attention_blocked_matches_jax():
    """attention_blocked's window at small query chunks and an offset."""
    rng = np.random.RandomState(7)
    q = rng.randn(2, 24, 2, 8).astype(np.float32)
    k, v = (rng.randn(2, 40, 2, 8).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda *a: jax_attn.attention_blocked(*a, q_offset=16, q_chunk=8,
                                                         window=WINDOW))(q, k, v)
    got = attention.attention_blocked(_t(q), _t(k), _t(v), q_offset=16, q_chunk=8,
                                      window=WINDOW)
    _close(got, want)


@pytest.mark.parametrize("mode", ["sliced", "sliced_dyn"])
def test_windowed_sliced_attention_matches_jax(models, mode):
    """A slice of 8 at ctx 24, above the window of 16, over a cache whose
    prefix holds random K/V: output and updated cache."""
    jcfg, tcfg = _configs(RG)
    jp, tp, x = _attn_inputs(models, 8)
    rng = np.random.RandomState(8)
    ck, cv = (rng.randn(2, 40, 1, tcfg.hd).astype(np.float32) for _ in range(2))
    jfn = getattr(jax_attn, f"attn_{mode}")
    tfn = getattr(attention, f"attn_{mode}")
    want, (jk, jv) = jax.jit(lambda p, x, kv: jfn(p, jcfg, x, kv, 24, window=WINDOW))(
        jp, x, (ck, cv))
    got, (tk, tv) = tfn(tp, tcfg.replace(use_kernel=True), _t(x), (_t(ck), _t(cv)), 24,
                        window=WINDOW)
    for t, j in ((got, want), (tk, jk), (tv, jv)):
        _close(t, j)


@pytest.mark.parametrize("case", ["window-rows", "window-rows-batched", "ring-at-window"])
def test_windowed_decode_matches_jax(models, case):
    """One decode token at pos 29, above the window: over a 40-row cache
    with the window mask (scalar and per-row pos), and through a ring
    exactly ``window`` long, where the reference's ring mask is right."""
    jcfg, tcfg = _configs(RG)
    jp, tp, x = _attn_inputs(models, 1)
    rng = np.random.RandomState(9)
    rows = WINDOW if case == "ring-at-window" else 40
    ck, cv = (rng.randn(2, rows, 1, tcfg.hd).astype(np.float32) for _ in range(2))
    pos = np.array([29, 29], np.int32) if case.endswith("batched") else 29
    ring = case.startswith("ring")
    want, (jk, jv) = jax.jit(lambda p, x, kv, pos: jax_attn.attn_decode(
        p, jcfg, x, kv, pos, window=WINDOW, ring=ring))(jp, x, (ck, cv), pos)
    tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
    got, (tk, tv) = attention.attn_decode(tp, tcfg.replace(use_kernel=True), _t(x),
                                          (_t(ck), _t(cv)), tpos, window=WINDOW, ring=ring)
    for t, j in ((got, want), (tk, jk), (tv, jv)):
        _close(t, j)


def test_ring_decode_refuses_vector_pos(models):
    """Ring caches decode a single stream, in both packages."""
    jcfg, tcfg = _configs(RG)
    jp, tp, x = _attn_inputs(models, 1)
    kv = np.zeros((2, WINDOW, 1, tcfg.hd), np.float32)
    pos = np.array([3, 4], np.int32)
    with pytest.raises(AssertionError, match="single stream"):
        jax_attn.attn_decode(jp, jcfg, x, (kv, kv), pos, window=WINDOW, ring=True)
    with pytest.raises(ValueError, match="single stream"):
        attention.attn_decode(tp, tcfg, _t(x), (_t(kv), _t(kv)), _t(pos), window=WINDOW,
                              ring=True)


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("slices", SLICE_SETS, ids=lambda s: "-".join(map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_equals_full(arch, slices, models):
    """apply_groups_sliced over the slices gives the full forward's
    activations (state carried from slice to slice; recurrentgemma's
    windowed attention over the KV prefix), at f32."""
    _, jparams, tmodel = models[arch]
    params = params_from_jax(jparams, "cpu")
    x = tmodel.embed(params, {"tokens": torch.from_numpy(_batch(b=2)["tokens"])})
    with torch.no_grad():
        full = lm.apply_groups_full(tmodel, params, x)
        caches = tmodel.init_caches(2, S, dtype=torch.float32)
        outs, ctx = [], 0
        for length in slices:
            out, caches = lm.apply_groups_sliced(tmodel, params, x[:, ctx:ctx + length],
                                                 caches, ctx)
            outs.append(out)
            ctx += length
    torch.testing.assert_close(torch.cat(outs, 1), full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_outputs_and_states_match_jax(arch, models):
    """Each slice of (16, 8, 8) and the final caches (states, and the
    hybrid's KV) against JAX's apply_groups_sliced, the port's under
    autograd too (new stacked states rather than in-place writes)."""
    jmodel, jparams, tmodel = models[arch]
    params = params_from_jax(jparams, "cpu")
    tokens = _batch(b=2)["tokens"]
    slices = SLICE_SETS[0]

    @jax.jit
    def jax_run(jparams, tokens):
        x = jmodel.embed(jparams, {"tokens": tokens})
        caches, outs, ctx = jmodel.init_caches(2, S, dtype=jnp.float32), [], 0
        for length in slices:
            out, caches = jax_lm.apply_groups_sliced(jmodel, jparams, x[:, ctx:ctx + length],
                                                     caches, ctx)
            outs.append(out)
            ctx += length
        return outs, caches

    jouts, jcaches = jax.device_get(jax_run(jparams, jnp.asarray(tokens)))
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            x = tmodel.embed(params, {"tokens": torch.from_numpy(tokens)})
            caches, ctx = tmodel.init_caches(2, S, dtype=torch.float32), 0
            for length, jout in zip(slices, jouts):
                out, caches = lm.apply_groups_sliced(tmodel, params, x[:, ctx:ctx + length],
                                                     caches, ctx)
                _close(out, jout)
                ctx += length
        got, want = list(tree_leaves(caches)), jax.tree.leaves(jcaches)
        assert len(got) == len(want) == (2 if arch == MAMBA else 6)
        for a, w in zip(got, want):
            assert a.shape == w.shape
            _close(a, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, models, jax_loss_grads):
    """Model.loss and every gradient leaf against
    jax.value_and_grad(model.loss); the port also under remat."""
    _, jparams, _ = models[arch]
    j_loss, j_grads = jax_loss_grads[arch]
    for remat in (False, True):
        tmodel = build_model(_configs(arch)[1].replace(remat=remat), device="cpu")
        params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
        loss, grads = value_and_grad(tmodel.loss)(
            params, {k: torch.from_numpy(v) for k, v in _batch().items()})
        np.testing.assert_allclose(float(loss), j_loss, rtol=TOL, atol=TOL)
        assert _check_tree(grads, j_grads) == len(jax.tree.leaves(jparams))


def _prefill_decode(models, arch, prompt: int, total: int, max_len: int):
    """JAX's forward logits of ``total`` tokens, its prefill of ``prompt``
    into ``max_len`` and one decode step per remaining token (the given
    tokens, not greedy), and the port's prefill and decode of the same."""
    jmodel, jparams, tmodel = models[arch]
    params = params_from_jax(jparams, "cpu")
    tokens = np.random.RandomState(11).randint(0, 256, size=(2, total)).astype(np.int32)

    jfull = jax.jit(jmodel.forward)(jparams, {"tokens": tokens})
    logits, caches = jax.jit(jmodel.prefill, static_argnums=2)(
        jparams, {"tokens": tokens[:, :prompt]}, max_len)
    decode = jax.jit(jmodel.decode_step)              # one program for every pos
    jsteps = [logits[:, -1]]
    for t in range(prompt, total):
        step, caches = decode(jparams, caches, {"tokens": tokens[:, t:t + 1]}, jnp.int32(t))
        jsteps.append(step[:, 0])
    jfull, jsteps = jax.device_get((jfull, jsteps))
    with torch.no_grad():
        logits, caches = tmodel.prefill(params, {"tokens": torch.from_numpy(tokens[:, :prompt])},
                                        max_len)
        tsteps = [logits[:, -1]]
        for t in range(prompt, total):
            step, caches = tmodel.decode_step(params, caches,
                                              {"tokens": torch.from_numpy(tokens[:, t:t + 1])}, t)
            tsteps.append(step[:, 0])
    return jfull, jsteps, tsteps


@pytest.mark.parametrize("arch", ARCHS + ("phi3-mini-3.8b",))
def test_prefill_then_decode_matches_jax(arch, models):
    """As tests/test_models_smoke.py parametrises it: prefill 12 of 16
    tokens into max_len 16 (= the hybrid's window), then 4 decode steps;
    the port's logits against JAX's prefill and decode logits and against
    JAX's forward."""
    jfull, jsteps, tsteps = _prefill_decode(models, arch, 12, 16, 16)
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        _close(t, j)
        _close(t, jfull[:, 11 + i])


def test_decode_ring_is_window_long(models):
    """init_caches(mode="decode") sizes the hybrid's KV ring to
    min(max_len, window), as the reference's; the rec states are f32 and
    each layer's rows are its own tensor memory (no aliased view)."""
    jmodel, _, tmodel = models[RG]
    for max_len in (8, 40):
        want = jmodel.init_caches(2, max_len, dtype=jnp.float32, mode="decode")
        got = tmodel.init_caches(2, max_len, dtype=torch.bfloat16, mode="decode")
        for a, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.shape == w.shape
    (rec_conv, rec_h), (k, _) = got[0]
    assert k.shape[2] == WINDOW and k.dtype == torch.bfloat16
    assert rec_conv.dtype == rec_h.dtype == torch.float32
    rec_h[0].fill_(1.0)
    assert float(rec_h[1].abs().sum()) == 0.0


def test_ring_decode_past_window_continues_forward(models):
    """A fault of the reference that the port does not carry: prefill 28
    tokens into max_len 32, above the window of 16, then decode 4 steps.
    The port's decode continues JAX's forward within 2e-4; JAX's own
    attends past the window (its ring mask keeps every written slot) and
    misses by more than 0.1 (0.54-0.64 when recorded)."""
    jfull, jsteps, tsteps = _prefill_decode(models, RG, 28, 32, 32)
    _close(tsteps[0], jsteps[0])
    _close(tsteps[0], jfull[:, 27])
    ref_err = []
    for i, (t, j) in enumerate(zip(tsteps[1:], jsteps[1:])):
        _close(t, jfull[:, 28 + i])
        ref_err.append(float(np.abs(j - jfull[:, 28 + i]).max()))
    print(f"reference ring decode past the window: max abs error per step {ref_err}")
    assert min(ref_err) > 0.1, ref_err


# ------------------------------------------------------------- the pipeline
PIPE_CASES = {
    # arch, schedule, V, K, D, M, remat
    "mamba2-contiguous-K4-D2-M2": (MAMBA, "contiguous", 1, 4, 2, 2, False),
    "mamba2-interleaved-V2-K4-D2-M2": (MAMBA, "interleaved", 2, 4, 2, 2, False),
    "rg-contiguous-post-K2-D1-M4": (RG, "contiguous", 1, 2, 1, 4, False),
    "rg-contiguous-post-K2-D2-M2-remat": (RG, "contiguous", 1, 2, 2, 2, True),
}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipelined_step_matches_jax(case, models, jax_loss_grads):
    """The pipelined step against JAX's non-pipelined value_and_grad: the
    state resets at each microbatch (D 2) and is carried across its slices;
    recurrentgemma's rec tail runs after the pipeline as a post-group.  The
    loss within 2e-5 of JAX's model.loss, every gradient within 2e-4."""
    arch, schedule, V, K, D, M, remat = PIPE_CASES[case]
    _, jparams, _ = models[arch]
    model = build_model(_configs(arch)[1].replace(remat=remat), device="cpu")
    params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
    tcfg = TeraPipeConfig(n_token_slices=M, n_microbatches=D, cache_dtype=torch.float32,
                          schedule=schedule, virtual_stages=V)
    vg = make_terapipe_value_and_grad(model, tcfg, S, B, K)
    want_post = ["tail"] if arch == RG else []
    assert vg.plan.pre == [] and [g.name for g in vg.plan.post] == want_post
    loss, grads = vg(params, {k: torch.from_numpy(v) for k, v in _batch().items()})
    j_loss, j_grads = jax_loss_grads[arch]
    assert abs(float(loss) - j_loss) < PIPE_LOSS_TOL, (float(loss), j_loss)
    assert _check_tree(grads, j_grads) == len(jax.tree.leaves(jparams))


def test_pipeline_fresh_caches_follow_the_main_group(models):
    """Per-layer caches of the executor: the mamba2 states f32 whatever the
    cache dtype; the hybrid's rec states f32 and its KV in cache_dtype; the
    dense KV in cache_dtype.  Every leaf owns exactly its own storage: an
    out-of-place write into a row of a shared stack allocates the whole
    stack (at gpt3-1b's M 8 step that ran the card out of memory)."""
    for arch in ARCHS + ("phi3-mini-3.8b",):
        model = models[arch][2]
        vg = make_terapipe_value_and_grad(model, TeraPipeConfig(n_token_slices=2), S, B, 2)
        layer = vg.plan.fresh_caches(2)[1]
        leaves = list(tree_leaves(layer))
        dtypes = [a.dtype for a in leaves]
        if arch == MAMBA:
            assert dtypes == [torch.float32] * 2
            assert layer[1].shape == (B, 4, 32, 16)
        elif arch == RG:
            assert dtypes == [torch.float32] * 2 + [torch.bfloat16] * 2
            assert layer[1][0].shape == (B, S, 1, 16)
        else:
            assert dtypes == [torch.bfloat16] * 2 and layer[0].shape == (B, S, 4, 16)
        for a in leaves:
            assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
            written = torch.slice_scatter(a, torch.ones_like(a[:, :1]), dim=1, start=0, end=1)
            assert written.untyped_storage().nbytes() == a.untyped_storage().nbytes()


@pytest.fixture(scope="module")
def jax_specs(models):
    """Per state arch: a replicated spec tree of the JAX params (every axis
    None), enough for the reference's _Plan to reach its refusals."""
    return {arch: jax.tree.map(lambda a: (None,) * a.ndim, jax.eval_shape(
        lambda k: models[arch][0].init(k)[0], jax.random.PRNGKey(0))) for arch in ARCHS}


REFUSALS = {
    "nonuniform": (dict(slice_lens=(16, 8, 8)), "uniform slices"),
    "1f1b": (dict(schedule="1f1b"), None),
    "zb-h1": (dict(schedule="zb-h1"), None),
    "interleaved-1f1b": (dict(schedule="interleaved-1f1b", virtual_stages=2), None),
}


@pytest.mark.parametrize("refusal", sorted(REFUSALS))
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_refusals_match_reference(arch, refusal, models, jax_specs):
    """Non-uniform slices (state families need uniform ones) and the
    explicit-backward schedules (dense/moe only; recurrentgemma's tail is a
    post-group too) raise in both packages."""
    kw, match = REFUSALS[refusal]
    jmodel, _, tmodel = models[arch]
    mesh = make_mesh((1, 1), ("data", "pipe"))
    with use_mesh(mesh), pytest.raises(AssertionError):
        jax_pipeline.make_terapipe_value_and_grad(
            jmodel, jax_specs[arch], mesh, jax_pipeline.TeraPipeConfig(**kw), S, B)
    with pytest.raises(ValueError, match=match or "dense/moe|post-pipeline"):
        make_terapipe_value_and_grad(tmodel, TeraPipeConfig(**kw), S, B, 2)


@pytest.mark.parametrize("mode", ["gspmd", "terapipe"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_drives_state_families(arch, mode):
    """launch.train.main --device cpu --smoke, gspmd and terapipe (K 4)."""
    history = []
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--mode", mode, "--token-slices", "2"]
    train_launch.main(argv, history=history)
    assert len(history) == 2 and all(abs(r["loss"] - math.log(256)) < 1 for r in history)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS + ("phi3-mini-3.8b", "phi4-mini-3.8b", "stablelm-12b"))
def test_configs_match_reference(arch, smoke):
    """Every field of the port's config equals the reference's (dtype by
    name)."""
    port = dataclasses.asdict(get_config(arch, smoke=smoke))
    ref = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert port.keys() == ref.keys()
    assert str(port.pop("dtype")).split(".")[-1] == jnp.dtype(ref.pop("dtype")).name
    assert port == ref
