"""The port's executor under the schedules beyond ``contiguous``: ``1f1b``,
``zb-h1``, ``interleaved`` and ``interleaved-1f1b`` (``core/pipeline.py``),
against the JAX package's non-pipelined ``jax.value_and_grad(model.loss)``.

gpt3 SMOKE at f32 with f32 caches, B 4 x S 32, on one device and without a
subprocess, as ``tests/test_torch_pipeline.py`` does for ``contiguous``:
every schedule at K = 2 and 4, uniform and non-uniform slices, D = 1 and 2,
loss and every gradient within 2e-4 (8 layers for K 4 at V 2, as
``tests/test_pipeline_executor.py`` uses).  Also: the residual store's peak
equals ``peak_live_items(D·M)`` and the saved cache rows are unchanged at
their backward tick; appended idle ticks leave the interleaved caches
bit-identical and equal to the JAX prefill; a tied-head GQA model; the
kernel route with remat; ``launch.train.main`` and its ``--dp-plan`` under
the new schedules.
"""
import argparse
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pipeline as jax_pipeline
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_data
from repro.launch import train as jax_train
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.configs import get_config
from repro_torch.core import pipeline
from repro_torch.core.cost_model import TPU_V5E
from repro_torch.core.pipeline import (LocalRing, TeraPipeConfig, make_terapipe_caches_fn,
                                       make_terapipe_loss, make_terapipe_value_and_grad)
from repro_torch.core.schedules import get_schedule
from repro_torch.launch import train as train_launch
from repro_torch.models import Model, build_model
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
B, S = 4, 32
SCHEDULES = [("1f1b", 1), ("zb-h1", 1), ("interleaved", 2), ("interleaved-1f1b", 2)]
EXPLICIT = [s for s in SCHEDULES if s[0] != "interleaved"]
SLICINGS = {"uniform": dict(n_token_slices=4), "dp": dict(slice_lens=(5, 11, 9, 7))}


def _configs(arch="gpt3-1b", n_layers=None, use_kernel=False, remat=False):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype=jnp.float32, use_kernel=use_kernel)
    tcfg = get_config(arch, smoke=True).replace(dtype=torch.float32, use_kernel=use_kernel,
                                                remat=remat)
    if n_layers:
        jcfg, tcfg = jcfg.replace(n_layers=n_layers), tcfg.replace(n_layers=n_layers)
    return jcfg, tcfg


def _batch(seed=0):
    toks = np.random.RandomState(seed).randint(0, 256, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


@pytest.fixture(scope="module")
def reference():
    """``(arch, n_layers, use_kernel) -> (jax params, (loss, grads))``:
    jax.value_and_grad(model.loss), not pipelined, computed once per key
    (the Pallas kernels in interpret mode when use_kernel)."""
    memo = {}

    def get(arch="gpt3-1b", n_layers=None, use_kernel=False):
        key = (arch, n_layers, use_kernel)
        if key not in memo:
            jmodel = jax_build_model(_configs(arch, n_layers)[0].replace(use_kernel=use_kernel))
            params = jax.device_get(jmodel.init(jax.random.PRNGKey(0))[0])
            loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
                params, {k: jnp.asarray(v) for k, v in _batch().items()})
            memo[key] = params, (float(loss), params_from_jax(jax.device_get(grads), "cpu",
                                                              torch.float32))
        return memo[key]

    return get


def _port(jax_params, **kw):
    model = build_model(_configs(**kw)[1], device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), params_from_jax(jax_params, "cpu"))
    return model, params


def _check(loss, grads, ref):
    """Loss and every gradient leaf, matched by key, within 2e-4."""
    j_loss, j_grads = ref
    np.testing.assert_allclose(float(loss), j_loss, rtol=TOL, atol=TOL)
    checked = []
    tree_map(lambda g, w: checked.append(
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)), grads, j_grads)
    assert len(checked) == len(list(tree_leaves(j_grads)))


def _n_layers(K, V):
    return 8 if K * V > 4 else None


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("slicing", sorted(SLICINGS))
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("schedule,V", SCHEDULES, ids=[s for s, _ in SCHEDULES])
def test_schedule_matches_jax_loss_and_grads(schedule, V, K, slicing, D, reference):
    """Loss and every gradient of make_terapipe_value_and_grad against
    JAX's non-pipelined step; an explicit-backward schedule's residual
    store peaks at the IR's peak_live_items(D·M)."""
    n_layers = _n_layers(K, V)
    jax_params, ref = reference(n_layers=n_layers)
    model, params = _port(jax_params, n_layers=n_layers)
    tcfg = TeraPipeConfig(n_microbatches=D, cache_dtype=torch.float32, schedule=schedule,
                          virtual_stages=V, **SLICINGS[slicing])
    vg = make_terapipe_value_and_grad(model, tcfg, S, B, K)
    loss, grads = vg(params, _torch_batch())
    _check(loss, grads, ref)
    if (schedule, V) in EXPLICIT:
        assign = get_schedule(schedule, n_ranks=K, n_layers=model.cfg.n_layers,
                              virtual_stages=V, n_microbatches=D)
        assert vg.residual_peak == assign.peak_live_items(D * 4)


class _CheckedStore(pipeline._ResidualStore):
    """Residual store that copies a forward unit's cache rows [0, ctx + l)
    when it saves them and checks them bit for bit at the backward tick."""
    reads = 0

    def put(self, k, v, i, value):
        if isinstance(value, pipeline._Saved):
            end = value.ctx + value.x.shape[1]
            value = (value, [c[:, :end].clone() for kv in value.caches for c in kv])
        super().put(k, v, i, value)

    def get(self, k, v, i):
        value = super().get(k, v, i)
        if isinstance(value, tuple) and isinstance(value[0], pipeline._Saved):
            saved, rows = value
            end = saved.ctx + saved.x.shape[1]
            now = [c[:, :end] for kv in saved.caches for c in kv]
            assert all(torch.equal(a, b) for a, b in zip(now, rows)), (k, v, i)
            _CheckedStore.reads += 1
            return saved
        return value


@pytest.mark.parametrize("schedule,V", EXPLICIT, ids=[s for s, _ in EXPLICIT])
def test_saved_cache_rows_unchanged_at_backward(schedule, V, reference, monkeypatch):
    """Forward units write their caches in place; the rows a unit read must
    still hold the same values when its backward recomputes from them (D 2,
    so microbatch 1 runs forward units while microbatch 0's backward is
    live)."""
    monkeypatch.setattr(pipeline, "_ResidualStore", _CheckedStore)
    _CheckedStore.reads = 0
    jax_params, ref = reference()
    model, params = _port(jax_params)
    tcfg = TeraPipeConfig(n_microbatches=2, cache_dtype=torch.float32, schedule=schedule,
                          virtual_stages=V, **SLICINGS["dp"])
    loss, grads = make_terapipe_value_and_grad(model, tcfg, S, B, 2)(params, _torch_batch())
    _check(loss, grads, ref)
    assert _CheckedStore.reads >= 2 * 4 * 2 * V    # every unit's backward read its rows


@pytest.mark.parametrize("K", [2, 4])
def test_interleaved_idle_ticks_leave_caches_bit_identical(K, reference):
    """Appended all-idle ticks are no-ops under interleaved (V 2), and the
    final caches, in global-stage order, are the K/V of the LAST
    microbatch: the JAX prefill of its rows."""
    n_layers = _n_layers(K, 2)
    jax_params, _ = reference(n_layers=n_layers)
    model, params = _port(jax_params, n_layers=n_layers)
    jmodel = jax_build_model(_configs(n_layers=n_layers)[0])
    _, want = jmodel.prefill(jax_params, {"tokens": jnp.asarray(_batch()["tokens"][B // 2:])}, S)
    caches = []
    for extra in (0, 3):
        tcfg = TeraPipeConfig(n_microbatches=2, cache_dtype=torch.float32, extra_ticks=extra,
                              schedule="interleaved", virtual_stages=2, **SLICINGS["dp"])
        caches.append(make_terapipe_caches_fn(model, tcfg, S, B, K)(params, _torch_batch()))
    for a, b in zip(caches[0], caches[1]):
        assert torch.equal(a, b)
    for got, ref in zip(caches[0], want[0]):
        assert np.max(np.abs(np.asarray(ref))) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def test_one_f_one_b_tied_head_gqa_matches_jax(reference):
    """qwen3 smoke: the head is the embedding's transpose (its gradient
    joins the embedding's) and K/V have half the query heads."""
    jax_params, ref = reference(arch="qwen3-0.6b")
    model, params = _port(jax_params, arch="qwen3-0.6b")
    assert model.cfg.tie_embeddings and model.cfg.n_kv_heads < model.cfg.n_heads
    tcfg = TeraPipeConfig(n_microbatches=2, cache_dtype=torch.float32, schedule="1f1b",
                          **SLICINGS["dp"])
    loss, grads = make_terapipe_value_and_grad(model, tcfg, S, B, 2)(params, _torch_batch())
    _check(loss, grads, ref)


@pytest.mark.parametrize("schedule", ["1f1b", "zb-h1"])
def test_kernel_route_with_remat_matches_jax(schedule, reference):
    """use_kernel and remat: the autograd Function (its plain CPU path) in
    every forward unit and recompute, against the JAX loss through the
    Pallas kernels."""
    jax_params, ref = reference(use_kernel=True)
    model, params = _port(jax_params, use_kernel=True, remat=True)
    tcfg = TeraPipeConfig(n_microbatches=2, cache_dtype=torch.float32, schedule=schedule,
                          **SLICINGS["dp"])
    loss, grads = make_terapipe_value_and_grad(model, tcfg, S, B, 3)(params, _torch_batch())
    _check(loss, grads, ref)


def test_explicit_schedules_have_no_loss_function(reference):
    model, _ = _port(reference()[0])
    with pytest.raises(ValueError, match="make_terapipe_value_and_grad"):
        make_terapipe_loss(model, TeraPipeConfig(schedule="1f1b"), S, B, 2)


def test_local_ring_reverse_shift_goes_to_the_predecessor():
    assert LocalRing(4).shift(["a", "b", "c", "d"], step=-1) == ["b", "c", "d", "a"]


STEPS, LR, WARMUP = 3, 1e-2, 2


@pytest.fixture(scope="module")
def jax_losses(reference):
    """The losses of a jitted JAX loop of value_and_grad(model.loss) +
    AdamW, STEPS steps from the JAX init."""
    jax_params, _ = reference()
    jmodel = jax_build_model(_configs()[0])
    opt = jax_adamw.adamw(jax_adamw.cosine_schedule(LR, WARMUP, STEPS))

    @jax.jit
    def step_fn(p, s, batch):
        loss, grads = jax.value_and_grad(jmodel.loss)(p, batch)
        updates, s = opt.update(grads, s, p)
        return jax_adamw.apply_updates(p, updates), s, loss

    data = jax_data.DataPipeline(jax_data.SyntheticSource(256, 0), B, S)
    p, s, out = jax_params, opt.init(jax_params), []
    for i in range(STEPS):
        p, s, loss = step_fn(p, s, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
        out.append(float(loss))
    return out


@pytest.mark.parametrize("extra", [["--schedule", "1f1b"],
                                   ["--schedule", "interleaved-1f1b", "--virtual-stages", "2"]],
                         ids=["1f1b", "interleaved-1f1b"])
def test_train_main_schedule_matches_jax_loop(extra, reference, jax_losses, monkeypatch,
                                              capsys):
    """Three steps of launch.train.main --mode terapipe under the schedule
    on the CPU (f32, from the JAX init) against the jitted JAX gspmd loop."""
    jax_params, _ = reference()
    monkeypatch.setattr(Model, "init", lambda self, seed: params_from_jax(jax_params, "cpu"))
    monkeypatch.setattr(train_launch, "get_config",
                        lambda arch, smoke: get_config(arch, smoke).replace(dtype=torch.float32))
    history = []
    argv = ["--arch", "gpt3-1b", "--smoke", "--device", "cpu", "--mode", "terapipe",
            "--microbatches", "2", "--token-slices", "4", "--steps", str(STEPS), "--batch",
            str(B), "--seq", str(S), "--lr", str(LR), "--warmup", str(WARMUP),
            "--log-every", "1"] + extra
    final = train_launch.main(argv, history=history)
    np.testing.assert_allclose([r["loss"] for r in history], jax_losses, rtol=TOL, atol=TOL)
    assert final == history[-1]["loss"]
    assert "mode terapipe" in capsys.readouterr().out


def test_dp_plan_interleaved_one_f_one_b_matches_jax(capsys, monkeypatch):
    """plan_slices for --schedule interleaved-1f1b --virtual-stages 2 on the
    full gpt3-1b at seq 2048 prints the reference trainer's [dp-plan] lines
    (TPU_V5E, the reference's own target), its slices planned at V 2 and
    made executable for that schedule."""
    monkeypatch.setattr(jax_pipeline, "make_terapipe_value_and_grad", lambda *a, **k: (None, None))
    args = argparse.Namespace(mode="terapipe", dp_plan=True, schedule="interleaved-1f1b",
                              virtual_stages=2, seq=2048, batch=B, microbatches=1,
                              token_slices=4, unroll=False, use_kernel=False)
    capsys.readouterr()
    jax_train.build_value_and_grad(jax_build_model(jax_get_config("gpt3-1b")), None,
                                   types.SimpleNamespace(shape={"pipe": 4}), args)
    lines = lambda text: [ln for ln in text.splitlines() if ln.startswith("[dp-plan]")]
    want = lines(capsys.readouterr().out)
    slices, _ = train_launch.plan_slices(get_config("gpt3-1b"), 2048, 4, TPU_V5E,
                                         schedule="interleaved-1f1b", virtual_stages=2)
    assert lines(capsys.readouterr().out) == want and want[0].startswith("[dp-plan] slices [")
    assert len(slices) % 4 == 0 and sum(slices) == 2048
