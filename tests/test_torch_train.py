"""The port's training step against the JAX package's, on converted weights.

gpt3 SMOKE at f32: the JAX parameters go through ``params_from_jax`` and
both packages compute the loss and its gradients, the sliced-dyn block, the
sliced-vs-full equivalence, AdamW updates, the data pipeline and a 3-step
training run from the same init and batches.  Tolerance: 2e-4, as
``tests/test_sliced_equivalence.py``; attention on the plain path and routed
through the kernel ops (``use_kernel``: Pallas interpret mode on the JAX
side, the plain CPU versions inside the port's autograd Function).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.models import build_model as jax_build_model
from repro.models import layers as jax_layers
from repro.models.attention import attention_blocked as jax_attention_blocked
from repro.models.lm import apply_groups_full as jax_apply_groups_full
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.launch import train as train_launch
from repro_torch.models import Model, build_model, layers
from repro_torch.models.attention import attention_blocked
from repro_torch.models.lm import apply_groups_full, apply_groups_sliced
from repro_torch.optim import adamw
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
ARCH = "gpt3-1b"
B, S = 2, 32


def _close(t, j, tol=TOL, what=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol,
                               err_msg=what)


def _match(check, tree, jax_tree):
    """``check(port_leaf, jax_leaf)`` for every leaf, matched by dict key
    (the JAX tree converted leaf-wise, in float32); returns the results."""
    out = []
    tree_map(lambda t, j: out.append(check(t, j.numpy())), tree,
             params_from_jax(jax_tree, "cpu", torch.float32))
    return out


def _configs(use_kernel=False, remat=False):
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=jnp.float32, use_kernel=use_kernel)
    tcfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32, use_kernel=use_kernel,
                                                remat=remat)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_params():
    jmodel = jax_build_model(_configs()[0])
    return jax.device_get(jmodel.init(jax.random.PRNGKey(0))[0])


def _batch(seed=0):
    toks = np.random.RandomState(seed).randint(0, 256, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_params):
    """jax.value_and_grad(model.loss) per use_kernel (JAX's remat does not
    change its values)."""
    out = {}
    for use_kernel in (False, True):
        jmodel = jax_build_model(_configs(use_kernel)[0])
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
            jax_params, {k: jnp.asarray(v) for k, v in _batch().items()})
        out[use_kernel] = (loss, jax.device_get(grads))
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_loss_and_grads_match_jax(use_kernel, remat, jax_params, jax_loss_and_grads):
    j_loss, j_grads = jax_loss_and_grads[use_kernel]
    model = build_model(_configs(use_kernel, remat)[1], device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), params_from_jax(jax_params, "cpu"))
    loss = model.loss(params, {k: torch.from_numpy(v) for k, v in _batch().items()})
    loss.backward()
    _close(loss, j_loss, what="loss")
    checked = _match(lambda p, w: _close(p.grad, w), params, j_grads)
    assert len(checked) == 12 and "lm_head" in params


@pytest.fixture(scope="module")
def jax_sliced_dyn():
    """The reference block with ctx traced (one trace per use_kernel): its
    output, new cache, and the vjp of the output."""
    fns = {}
    for use_kernel in (False, True):
        jcfg = _configs(use_kernel)[0]

        @jax.jit
        def run(p, x, ck, cv, g, ctx, jcfg=jcfg):
            def f(p, x, ck, cv):
                return jax_layers.dense_block_sliced_dyn(p, jcfg, x, (ck, cv), ctx)
            (out, cache), vjp = jax.vjp(f, p, x, ck, cv)
            zero = jax.tree.map(jnp.zeros_like, cache)
            return out, cache, vjp((g, zero))
        fns[use_kernel] = run
    return fns


@pytest.mark.parametrize("ctx", [0, 5, 48])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_dense_block_sliced_dyn_matches_jax(use_kernel, ctx, jax_params, jax_sliced_dyn):
    """One layer at offset ctx over a 64-row cache with a stale random tail:
    values, new cache and the vjp w.r.t. params, x and the cache."""
    l, lmax = 16, 64
    bp_j = jax.tree.map(lambda a: a[0], jax_params["groups"]["blocks"])
    rng = np.random.RandomState(ctx)
    x, g = (rng.randn(B, l, 64).astype(np.float32) for _ in range(2))
    ck, cv = (rng.randn(B, lmax, 4, 16).astype(np.float32) for _ in range(2))
    j_out, j_cache, j_grads = jax_sliced_dyn[use_kernel](
        bp_j, x, ck, cv, g, jnp.int32(ctx))

    tcfg = _configs(use_kernel)[1]
    bp = tree_map(lambda p: p.requires_grad_(True), params_from_jax(bp_j, "cpu"))
    tx, tck, tcv = (torch.from_numpy(a).requires_grad_(True) for a in (x, ck, cv))
    out, (nk, nv) = layers.dense_block_sliced_dyn(bp, tcfg, tx, (tck, tcv), torch.tensor(ctx))
    _close(out, j_out, what="out")
    _close(nk, j_cache[0], what="k cache")
    _close(nv, j_cache[1], what="v cache")
    assert torch.equal(tck, torch.from_numpy(ck))          # written out of place
    leaves = list(tree_leaves(bp))
    grads = torch.autograd.grad(out, leaves + [tx, tck, tcv], torch.from_numpy(g))
    want = jax.tree_util.tree_leaves(j_grads)
    assert len(want) == len(grads)
    for got, w in zip(grads, want):
        _close(got, w)


@pytest.fixture(scope="module")
def full_pair(jax_params):
    """Embedded inputs and the full-sequence stack output of both packages."""
    jcfg, tcfg = _configs()
    jmodel = jax_build_model(jcfg)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(7), (B, S), 0, 256))
    jx = jmodel.embed(jax_params, {"tokens": jnp.asarray(tokens)}, 0)
    j_full = jax.jit(lambda p, x: jax_apply_groups_full(jmodel, p, x))(jax_params, jx)
    model = build_model(tcfg, device="cpu")
    params = params_from_jax(jax_params, "cpu")
    with torch.no_grad():
        x = model.embed(params, {"tokens": torch.from_numpy(tokens)}, 0)
        full = apply_groups_full(model, params, x)
        logits = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    _close(full, j_full, what="full stack vs JAX")
    assert torch.equal(logits, model.head(params, full))
    return model, params, x, full


@pytest.mark.parametrize("slices", [(16, 8, 8), (8, 8, 8, 8), (24, 8)])
def test_sliced_equals_full(slices, full_pair):
    """tests/test_sliced_equivalence.py for the port: the token-sliced stack
    reproduces the full forward (which matches the JAX package's)."""
    model, params, x, full = full_pair
    caches = model.init_caches(B, S, torch.float32)
    outs, ctx = [], 0
    with torch.no_grad():
        for l in slices:
            o, caches = apply_groups_sliced(model, params, x[:, ctx:ctx + l], caches, ctx)
            outs.append(o)
            ctx += l
    _close(torch.cat(outs, dim=1), full.numpy())


def _opt_tree(rng, dtype):
    leaf = lambda *shape: rng.randn(*shape).astype(dtype)
    return {"w": leaf(4, 8), "blk": {"a": leaf(3), "b": leaf(2, 5)}}


def test_tree_items_and_unflatten():
    """Paths and order of the tree helpers the optimizer and the smoke
    script rely on: tree_unflatten inverts tree_leaves."""
    tree = {"b": [1, (2, 3)], "a": {"x": 4}, "c": 5}
    assert list(tree_items(tree)) == [("/b/0", 1), ("/b/1/0", 2), ("/b/1/1", 3),
                                      ("/a/x", 4), ("/c", 5)]
    assert list(tree_leaves(tree)) == [1, 2, 3, 4, 5]
    back = tree_unflatten(tree, (10 * x for x in tree_leaves(tree)))
    assert back == tree_map(lambda x: 10 * x, tree)
    assert isinstance(back["b"][1], tuple)


@pytest.mark.parametrize("master", [False, True], ids=["f32", "bf16-master"])
def test_adamw_updates_match_jax(master):
    """Three updates with clipping (grad norms ~10x the limit) through the
    cosine warmup, from the same params and grads."""
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if master else (torch.float32, jnp.float32)
    rng = np.random.RandomState(3)
    p_np = _opt_tree(rng, np.float32)
    j_opt = jax_adamw.adamw(jax_adamw.cosine_schedule(1e-2, 2, 10), master_weights=master)
    t_opt = adamw.adamw(adamw.cosine_schedule(1e-2, 2, 10), master_weights=master)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = tree_map(lambda a: torch.from_numpy(a).to(tdt), p_np)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for _ in range(3):
        g_np = tree_map(lambda a: 10 * a, _opt_tree(rng, np.float32))
        ju, js = j_opt.update(jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np), js, jp)
        tu, ts = t_opt.update(tree_map(lambda a: torch.from_numpy(a).to(tdt), g_np), ts, tp)
        jp, tp = jax_adamw.apply_updates(jp, ju), adamw.apply_updates(tp, tu)
        assert int(ts.step) == int(js.step)
        assert all(t.dtype == tdt for t in tree_leaves(tp))
        for t_tree, j_tree in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            _match(lambda t, j: _close(t.float(), j, tol=1e-6), t_tree, j_tree)
    g = tree_map(torch.from_numpy, g_np)
    _close(adamw.global_norm(g), jax_adamw.global_norm(g_np), tol=1e-6)
    clipped, _ = adamw.clip_by_global_norm(g, 1.0)
    _close(adamw.global_norm(clipped), np.float32(1.0), tol=1e-6)


def test_accumulate_grads_matches_jax(jax_params):
    jmodel = jax_build_model(_configs()[0])
    batches = {k: np.stack([_batch(1)[k][:1], _batch(2)[k][:1]]) for k in ("tokens", "labels")}
    j_loss, j_grads = jax.jit(lambda p, b: jax_adamw.accumulate_grads(jmodel.loss, p, b))(
        jax_params, {k: jnp.asarray(v) for k, v in batches.items()})
    model = build_model(_configs()[1], device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), params_from_jax(jax_params, "cpu"))
    loss, grads = adamw.accumulate_grads(
        model.loss, params, {k: torch.from_numpy(v) for k, v in batches.items()})
    _close(loss, j_loss)
    assert len(_match(_close, grads, j_grads)) == 12


def test_data_pipeline_is_bit_identical(tmp_path):
    jp = jax_pipeline.DataPipeline(jax_pipeline.SyntheticSource(50257, 3), 4, 16,
                                   n_shards=2, shard=1)
    tp = pipeline.DataPipeline(pipeline.SyntheticSource(50257, 3), 4, 16, n_shards=2, shard=1)
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.uint16).tofile(path)
    jb = jax_pipeline.DataPipeline(jax_pipeline.BinTokenSource(str(path), 1000), 2, 600)
    tb = pipeline.DataPipeline(pipeline.BinTokenSource(str(path), 1000), 2, 600)
    for step in (0, 1, 7):
        for a, b in ((jp, tp), (jb, tb)):
            want, got = a.batch_at(step), b.batch_at(step)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_train_main_matches_jax_loop(jax_params, monkeypatch, capsys):
    """Three steps of ``launch.train.main`` on the CPU (use_kernel: the
    autograd Function's plain path) against a jitted JAX loop of
    value_and_grad(model.loss) + adamw from the same init and batches."""
    steps, lr, warmup = 3, 1e-2, 2
    jmodel = jax_build_model(_configs(True)[0])
    opt = jax_adamw.adamw(jax_adamw.cosine_schedule(lr, warmup, steps))

    @jax.jit
    def step_fn(p, s, batch):
        loss, grads = jax.value_and_grad(jmodel.loss)(p, batch)
        updates, s = opt.update(grads, s, p)
        return jax_adamw.apply_updates(p, updates), s, loss

    data = jax_pipeline.DataPipeline(jax_pipeline.SyntheticSource(256, 0), B, S)
    p, s, want = jax_params, opt.init(jax_params), []
    for i in range(steps):
        p, s, loss = step_fn(p, s, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
        want.append(float(loss))

    # the port's own init draws other numbers: start it from the JAX init;
    # and run both at f32 (the smoke config computes in bf16), where 2e-4 holds
    monkeypatch.setattr(Model, "init", lambda self, seed: params_from_jax(jax_params, "cpu"))
    monkeypatch.setattr(train_launch, "get_config",
                        lambda arch, smoke: get_config(arch, smoke).replace(dtype=torch.float32))
    history = []
    final = train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--use-kernel",
                               "--steps", str(steps), "--batch", str(B), "--seq", str(S),
                               "--lr", str(lr), "--warmup", str(warmup), "--log-every", "1"],
                              history=history)
    got = [r["loss"] for r in history]
    assert [r["step"] for r in history] == list(range(1, steps + 1))
    printed = re.findall(r"^step +\d+ loss (\S+)", capsys.readouterr().out, flags=re.M)
    assert printed == [f"{x:.6f}" for x in got]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(final, want[-1], rtol=TOL, atol=TOL)
    assert want[0] != want[-1]      # the updates moved the loss


def test_attention_blocked_matches_jax():
    """The q-chunked causal path the plain ``attn_full`` takes past 2048
    tokens, at a small chunk (ragged last chunk, a q offset)."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 10, 3, 8).astype(np.float32) for _ in range(3))
    for q_offset in (0, 3):
        kk = np.concatenate([k, k[:, :q_offset]], axis=1)
        vv = np.concatenate([v, v[:, :q_offset]], axis=1)
        want = jax.jit(jax_attention_blocked, static_argnames=("q_offset", "q_chunk"))(
            jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), q_offset=q_offset, q_chunk=4)
        got = attention_blocked(*(torch.from_numpy(a) for a in (q, kk, vv)),
                                q_offset=q_offset, q_chunk=4)
        _close(got, want)
