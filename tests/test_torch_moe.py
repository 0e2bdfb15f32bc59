"""The port's MoE family (``models/moe.py``, the ``moe`` and ``dense0``
groups of ``models/lm.py``, the pipeline's pre-groups) against the JAX
package.

qwen3-moe and deepseek-moe SMOKE at f32: the JAX parameters go through
``params_from_jax`` and both packages run the same numpy-seeded inputs,
held at the ``tests/test_sliced_equivalence.py`` tolerance (2e-4):
``moe_ffn`` (output and gradients, at the default capacity and at a
capacity factor of 0.6, which drops choices) and ``aux_load_balance_loss``;
sliced execution on routing-block multiples; ``Model.loss`` and every
gradient; ``prefill`` and ``decode_step``; and the pipelined step, where
deepseek's ``dense0`` runs as a pre-group before the pipelined ``moe``
group, under ``contiguous`` and ``1f1b`` against JAX's non-pipelined
``value_and_grad``.  Also: the FULL and SMOKE configs equal the
reference's, a deepseek state restores into the JAX checkpoint manager bit
for bit, and ``launch.train.main`` drives the family.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad, value_and_grad
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, lm, moe
from repro_torch.optim import adamw
from repro_torch.tree import jax_items, tree_items, tree_leaves, tree_map, tree_unflatten
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-moe-16b")
B, S = 2, 32                 # four routing blocks of 8 tokens per row
SLICES = (8, 16, 8)          # token slices on routing-block multiples
DECODE_STEPS = 3


def _configs(arch, **kw):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32, **kw)
    tcfg = get_config(arch, smoke=True).replace(dtype=torch.float32, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """Per arch: the JAX model, one set of parameters as numpy arrays and
    the port's model.  The parameters are the port's init (JAX's eager init
    of these stacks is slow), checked leaf for leaf against the
    structure, shapes and dtypes of the JAX init's: both packages then read
    the same arrays, the port's through ``params_from_jax``."""
    out = {}
    for arch in ARCHS:
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
    """Per arch: jax.value_and_grad(model.loss) on ``_batch()``."""
    out = {}
    for arch, (jmodel, jparams, _) in models.items():
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
            jparams, {k: jnp.asarray(v) for k, v in _batch().items()})
        out[arch] = float(loss), jax.device_get(grads)
    return out


def _batch(seed=0, b=B, s=S):
    toks = np.random.RandomState(seed).randint(0, 256, size=(b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def _check_tree(port, ref):
    """Every leaf of ``port`` against ``ref``'s, matched by path."""
    want = dict(jax_items(ref))
    got = dict(tree_items(port))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(want[path]), rtol=TOL,
                                   atol=TOL, err_msg=path)
    return len(got)


# ------------------------------------------------------------ the MoE block
@pytest.mark.parametrize("cf", [1.25, 0.6], ids=["cf1.25", "cf0.6-drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_and_aux_loss_match_jax(arch, cf):
    """moe_ffn's output and its gradients (input and every parameter) and
    the auxiliary loss, on one layer's converted parameters; at cf 0.6
    choices past capacity are dropped, in the same pairs on both sides."""
    jcfg, tcfg = _configs(arch, capacity_factor=cf)
    jp, _ = jax_moe.init_moe(jax.random.PRNGKey(1), jcfg)
    jp = jax.device_get(jp)
    rng = np.random.RandomState(2)
    x = rng.randn(B, S, tcfg.d_model).astype(np.float32)
    r = rng.randn(B, S, tcfg.d_model).astype(np.float32)

    def jloss(p, x):
        out = jax_moe.moe_ffn(p, jcfg, x)
        return jnp.sum(out * r), (out, jax_moe.aux_load_balance_loss(p, jcfg, x))
    (_, (j_out, j_aux)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))

    p = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jp, "cpu"))
    xt = torch.from_numpy(x).requires_grad_(True)
    moe.ROUTING_LOG = []
    try:
        out = moe.moe_ffn(p, tcfg, xt)
        ((router, topi, keep, grad),) = moe.ROUTING_LOG
    finally:
        moe.ROUTING_LOG = None
    assert router is p["router"] and grad
    assert topi.shape == (B * S // tcfg.moe_block, tcfg.moe_block, tcfg.moe_top_k)
    _close(out, j_out)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), [xt] + list(tree_leaves(p)))
    _close(grads[0], j_gx)
    assert _check_tree(tree_unflatten(p, grads[1:]), jax.device_get(j_gp)) >= 4
    _close(moe.aux_load_balance_loss(p, tcfg, xt), j_aux)
    # the same capacity as the reference's, and at cf 0.6 choices are dropped
    capacity = math.ceil(cf * tcfg.moe_block * tcfg.moe_top_k / tcfg.n_experts)
    counts = torch.nn.functional.one_hot(topi.flatten(1), tcfg.n_experts).sum(1)
    assert int((~keep).sum()) == int(torch.clamp(counts - capacity, min=0).sum())
    if cf < 1:
        assert int((~keep).sum()) > 0


def test_gather_backward_is_the_scatter_add_it_replaces():
    """_Gather's backward, a gather through the inverse map, equals
    autograd's scatter-add through plain indexing, with drops."""
    cfg = get_config("deepseek-moe-16b", smoke=True).replace(dtype=torch.float32,
                                                            capacity_factor=0.6)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(3, 8, cfg.d_model, generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    g = torch.randn(3, 8, cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(moe._route_groups(p, cfg, x), x, g)[0]

    class _Plain(torch.autograd.Function):     # torch's own indexing backward
        @staticmethod
        def forward(ctx, src, idx, inv, fold):
            ctx.save_for_backward(idx)
            ctx.n = src.shape[0]
            return moe._pad_row(src)[idx]

        @staticmethod
        def backward(ctx, dout):
            (idx,) = ctx.saved_tensors
            d = dout.new_zeros((ctx.n + 1, dout.shape[-1])).index_add_(0, idx, dout)
            return d[:-1], None, None, None

    orig = moe._Gather
    moe._Gather = _Plain
    try:
        want = torch.autograd.grad(moe._route_groups(p, cfg, x), x, g)[0]
    finally:
        moe._Gather = orig
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert got.abs().max() > 0


def test_tp_axis_raises():
    """Expert parallelism takes a group (tests/test_torch_parallel.py); the
    reference's kind of ``tp_axis``, a mesh axis name, raises."""
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True).replace(tp_axis="model")
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(TypeError, match="group"):
        moe.moe_ffn(p, cfg, torch.zeros(1, 8, cfg.d_model))


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("arch", ARCHS)
def test_sliced_prefill_decode_match_jax(arch, models):
    """Slices on routing-block multiples (8, 16, 8) give the full forward's
    activations, and each slice's output and the caches equal JAX's
    apply_groups_sliced at the same ctx (deepseek runs dense0, then moe);
    prefill of the whole prompt gives JAX's last-token logits and caches,
    then 3 decode_steps of JAX's greedy tokens give its logits."""
    jmodel, jparams, tmodel = models[arch]
    assert [g.name for g in tmodel.groups] == [g.name for g in jmodel.groups]
    params = params_from_jax(jparams, "cpu")
    tokens = _batch()["tokens"]
    max_len = S + DECODE_STEPS

    @jax.jit
    def jax_run(jparams, tokens):
        """Sliced prefill, the head on the last token, greedy decode."""
        x = jmodel.embed(jparams, {"tokens": tokens})
        caches, outs, ctx = jmodel.init_caches(B, max_len, dtype=jnp.float32), [], 0
        for length in SLICES:
            out, caches = jax_lm.apply_groups_sliced(jmodel, jparams, x[:, ctx:ctx + length],
                                                     caches, ctx)
            outs.append(out)
            ctx += length
        logits = [jmodel.head(jparams, outs[-1][:, -1:])]
        prefill_caches, nxt = caches, []
        for pos in range(S, max_len):
            nxt.append(jnp.argmax(logits[-1][:, -1], axis=-1)[:, None].astype(jnp.int32))
            step, caches = jmodel.decode_step(jparams, caches, {"tokens": nxt[-1]}, pos)
            logits.append(step)
        return outs, prefill_caches, logits, nxt

    jouts, jcaches, jlogits, jnext = jax.device_get(jax_run(jparams, jnp.asarray(tokens)))
    x = tmodel.embed(params, {"tokens": torch.from_numpy(tokens)})
    full = lm.apply_groups_full(tmodel, params, x)
    caches = tmodel.init_caches(B, max_len, dtype=torch.float32)
    ctx = 0
    for length, jout in zip(SLICES, jouts):
        out, caches = lm.apply_groups_sliced(tmodel, params, x[:, ctx:ctx + length], caches, ctx)
        torch.testing.assert_close(out, full[:, ctx:ctx + length], rtol=TOL, atol=TOL)
        _close(out, jout)
        ctx += length
    logits, pcaches = tmodel.prefill(params, {"tokens": torch.from_numpy(tokens)}, max_len)
    _close(logits, jlogits[0])
    for sliced, prefilled, want in zip(caches, pcaches, jcaches):
        for a, b, w in zip(sliced, prefilled, want):
            _close(a, w)
            _close(b, w)
    for pos, nxt, want in zip(range(S, max_len), jnext, jlogits[1:]):
        logits, pcaches = tmodel.decode_step(params, pcaches, {"tokens": torch.tensor(nxt)}, pos)
        _close(logits, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, models, jax_loss_grads):
    """Model.loss and every gradient leaf (deepseek's dense0 included)
    against jax.value_and_grad(model.loss); the port also under remat."""
    _, jparams, _ = models[arch]
    batch = _batch()
    j_loss, j_grads = jax_loss_grads[arch]
    for remat in (False, True):
        tmodel = build_model(_configs(arch)[1].replace(remat=remat), device="cpu")
        params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
        loss, grads = value_and_grad(tmodel.loss)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(loss), j_loss, rtol=TOL, atol=TOL)
        n = _check_tree(grads, j_grads)
        assert n == len(jax.tree.leaves(jparams))
        if arch.startswith("deepseek"):
            assert float(grads["groups"]["dense0"]["ffn"]["w_up"].abs().max()) > 0


# -------------------------------------------------------------- the pipeline
PIPE_CASES = {
    # (schedule, slicing, K, D, use_kernel + remat)
    "contiguous-uniform-K2": ("contiguous", dict(n_token_slices=4), 2, 1, False),
    "contiguous-blocks-K4-kernel-remat": ("contiguous", dict(slice_lens=(8, 16, 8)), 4, 2, True),
    "1f1b-uniform-K4": ("1f1b", dict(n_token_slices=4), 4, 1, False),
    "1f1b-blocks-K2-kernel-remat": ("1f1b", dict(slice_lens=(16, 8, 8)), 2, 2, True),
}


@pytest.mark.parametrize("case", sorted(PIPE_CASES))
def test_pipelined_step_with_pre_group_matches_jax(case, models, jax_loss_grads):
    """deepseek SMOKE (dense0 + 2 MoE layers) through the pipelined step:
    dense0 runs in the prologue, the 2 MoE layers on K ranks (at K 4 two
    ranks hold only pad rows), uniform slices or slices on routing-block
    multiples, D 1 or 2; the loss and every gradient, dense0's included,
    within 2e-4 of JAX's non-pipelined value_and_grad."""
    schedule, slicing, K, D, kernel = PIPE_CASES[case]
    _, jparams, _ = models["deepseek-moe-16b"]
    model = build_model(_configs("deepseek-moe-16b")[1].replace(use_kernel=kernel,
                                                                remat=kernel), device="cpu")
    params = tree_map(lambda a: a.requires_grad_(True), params_from_jax(jparams, "cpu"))
    tcfg = TeraPipeConfig(n_microbatches=D, cache_dtype=torch.float32, schedule=schedule,
                          **slicing)
    vg = make_terapipe_value_and_grad(model, tcfg, S, B, K)
    assert [g.name for g in vg.plan.pre] == ["dense0"] and vg.plan.main.name == "moe"
    loss, grads = vg(params, {k: torch.from_numpy(v) for k, v in _batch().items()})
    j_loss, j_grads = jax_loss_grads["deepseek-moe-16b"]
    np.testing.assert_allclose(float(loss), j_loss, rtol=TOL, atol=TOL)
    assert _check_tree(grads, j_grads) == len(jax.tree.leaves(jparams))


def test_train_main_drives_moe_pipeline():
    """launch.train.main --mode terapipe on deepseek SMOKE (dense0 as the
    pre-group), and the reference's seq >= moe_block bump under gspmd."""
    history = []
    train_launch.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu", "--steps",
                       "2", "--mode", "terapipe", "--schedule", "1f1b", "--token-slices", "2",
                       "--batch", "2", "--seq", "16", "--log-every", "1"], history=history)
    assert len(history) == 2 and all(abs(r["loss"] - math.log(256)) < 1 for r in history)
    history = []
    train_launch.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--device", "cpu",
                       "--steps", "1", "--batch", "1", "--seq", "4", "--log-every", "1"],
                      history=history)
    assert history[0]["tok_s"] > 0 and abs(history[0]["loss"] - math.log(256)) < 1


# ------------------------------------------------------ configs, checkpoints
@pytest.mark.parametrize("smoke", [False, True], ids=["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch, smoke):
    """Every field of the port's config equals the reference's (dtype by
    name)."""
    port = dataclasses.asdict(get_config(arch, smoke=smoke))
    ref = dataclasses.asdict(jax_get_config(arch, smoke=smoke))
    assert port.keys() == ref.keys()
    assert str(port.pop("dtype")).split(".")[-1] == jnp.dtype(ref.pop("dtype")).name
    assert port == ref


def test_deepseek_checkpoint_restores_into_jax(tmp_path, models):
    """A port deepseek SMOKE state after one AdamW update restores into
    the JAX manager bit for bit: the leaf order of groups/dense0 before
    groups/moe is jax.tree.flatten's."""
    jmodel, _, tmodel = models["deepseek-moe-16b"]
    params = tmodel.init(7)
    opt = adamw.adamw(1e-2)
    gen = torch.Generator().manual_seed(3)
    grads = tree_map(lambda a: torch.randn(a.shape, generator=gen), params)
    updates, opt_state = opt.update(grads, opt.init(params), params)
    state = {"params": adamw.apply_updates(params, updates), "opt": opt_state, "step": 1}
    CheckpointManager(str(tmp_path)).save(1, state)
    jparams = jax.eval_shape(lambda k: jmodel.init(k)[0], jax.random.PRNGKey(0))
    jopt = jax.eval_shape(jax_adamw.adamw(1e-2).init, jparams)
    jtarget = {"params": jparams, "opt": jopt, "step": 0}
    back = JaxCheckpointManager(str(tmp_path)).restore(target=jtarget)
    got, want = [leaf for _, leaf in jax_items(state)], jax.tree.leaves(back)
    assert len(got) == len(want)
    for a, w in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == np.shape(w) and np.array_equal(a, np.asarray(w))
    paths = [p for p, _ in jax_items(state["params"])]
    assert paths.index("/groups/dense0/attn/wk") < paths.index("/groups/moe/attn/wk")
