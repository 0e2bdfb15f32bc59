"""The port's pipelined step (``core/pipeline.py``, the contiguous schedule
on virtual ranks) against the JAX package's non-pipelined step.

gpt3 SMOKE at f32 (4 layers): the JAX parameters go through
``params_from_jax`` and the port's ``make_terapipe_value_and_grad`` must
give ``jax.value_and_grad(model.loss)``'s loss and every gradient within
2e-4, the target ``tests/test_pipeline_executor.py`` holds the JAX executor
to, on one device and without a subprocess: K = 2, 3 (uneven stages, one of
them all pad rows) and 4, uniform and non-uniform slices, D = 1 and 2, and
GPipe (D = 2, M = 1).  Caches are float32 there, as in the JAX executor's
tests.  Also: idle ticks leave the caches bit-identical and the caches
equal the JAX prefill of the last microbatch, the other four schedules
run there too (``tests/test_torch_pipeline_schedules.py`` holds them in
full), and ``launch.train.main`` drives the pipelined modes and the DP
plan on the CPU.
"""
import argparse
import math
import re
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
from repro_torch.core.cost_model import H100, TPU_V5E
from repro_torch.core.pipeline import (LocalRing, TeraPipeConfig, make_gpipe_loss,
                                       make_terapipe_caches_fn, make_terapipe_value_and_grad,
                                       value_and_grad)
from repro_torch.launch import train as train_launch
from repro_torch.models import Model, build_model
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
ARCH = "gpt3-1b"
B, S = 4, 32


def _configs(use_kernel=False):
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype=jnp.float32, use_kernel=use_kernel)
    tcfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32, use_kernel=use_kernel)
    return jcfg, tcfg


def _batch(seed=0):
    toks = np.random.RandomState(seed).randint(0, 256, size=(B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jax_build_model(_configs()[0]).init(jax.random.PRNGKey(0))[0])


@pytest.fixture(scope="module")
def jax_reference(jax_params):
    """jax.value_and_grad(model.loss), not pipelined, per use_kernel (the
    Pallas kernels in interpret mode)."""
    out = {}
    for use_kernel in (False, True):
        jmodel = jax_build_model(_configs(use_kernel)[0])
        loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(
            jax_params, {k: jnp.asarray(v) for k, v in _batch().items()})
        out[use_kernel] = (float(loss),
                           params_from_jax(jax.device_get(grads), "cpu", torch.float32))
    return out


def _port(jax_params, use_kernel=False, remat=False):
    model = build_model(_configs(use_kernel)[1].replace(remat=remat), device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), params_from_jax(jax_params, "cpu"))
    return model, params


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _check(loss, grads, ref):
    """Loss and every gradient leaf, matched by key, within 2e-4."""
    j_loss, j_grads = ref
    np.testing.assert_allclose(float(loss), j_loss, rtol=TOL, atol=TOL)
    checked = []
    tree_map(lambda g, w: checked.append(
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)), grads, j_grads)
    assert len(checked) == len(list(tree_leaves(j_grads))) == 12


SLICINGS = {"uniform": dict(n_token_slices=4), "dp": dict(slice_lens=(5, 11, 9, 7))}


@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("slicing", sorted(SLICINGS))
@pytest.mark.parametrize("K", [2, 3, 4])
def test_contiguous_matches_jax_loss_and_grads(K, slicing, D, jax_params, jax_reference):
    model, params = _port(jax_params)
    tcfg = TeraPipeConfig(n_microbatches=D, cache_dtype=torch.float32, **SLICINGS[slicing])
    loss, grads = make_terapipe_value_and_grad(model, tcfg, S, B, K)(params, _torch_batch())
    _check(loss, grads, jax_reference[False])


@pytest.mark.parametrize("K", [2, 4])
def test_gpipe_matches_jax_loss_and_grads(K, jax_params, jax_reference):
    model, params = _port(jax_params)
    loss_fn = make_gpipe_loss(model, n_microbatches=2, seq_len=S, global_batch=B, n_ranks=K,
                              cache_dtype=torch.float32)
    loss, grads = value_and_grad(loss_fn)(params, _torch_batch())
    _check(loss, grads, jax_reference[False])


@pytest.mark.parametrize("remat", [False, True], ids=["no-remat", "remat"])
def test_kernel_route_matches_jax(remat, jax_params, jax_reference):
    """use_kernel: the autograd Function (its plain CPU path) in every
    stage, each block under checkpoint when remat, against the JAX loss
    through the Pallas kernels; the model's config picks the route."""
    model, params = _port(jax_params, use_kernel=True, remat=remat)
    tcfg = TeraPipeConfig(n_microbatches=2, cache_dtype=torch.float32, **SLICINGS["dp"])
    loss, grads = make_terapipe_value_and_grad(model, tcfg, S, B, 3)(params, _torch_batch())
    _check(loss, grads, jax_reference[True])


def test_idle_ticks_leave_caches_bit_identical(jax_params):
    """Appended all-idle ticks are no-ops, and the final caches are the K/V
    of the LAST microbatch: the JAX prefill of its rows (D = 2, M = 1, as
    the JAX executor's test, and a sliced D = 2 run)."""
    model, params = _port(jax_params)
    batch = _torch_batch()
    jmodel = jax_build_model(_configs()[0])
    _, ref = jmodel.prefill(jax_params, {"tokens": jnp.asarray(_batch()["tokens"][B // 2:])}, S)
    for kw in (dict(n_token_slices=1), SLICINGS["dp"]):
        caches = []
        for extra in (0, 3):
            tcfg = TeraPipeConfig(n_microbatches=2, cache_dtype=torch.float32,
                                  extra_ticks=extra, **kw)
            caches.append(make_terapipe_caches_fn(model, tcfg, S, B, 2)(params, batch))
        for a, b in zip(caches[0], caches[1]):
            assert torch.equal(a, b)
        for got, want in zip(caches[0], ref[0]):
            assert np.max(np.abs(np.asarray(want))) > 0
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_local_ring_shifts_to_the_successor():
    assert LocalRing(4).shift(["a", "b", "c", "d"]) == ["d", "a", "b", "c"]
    assert LocalRing(1).shift(["a"]) == ["a"]


@pytest.mark.parametrize("schedule,V", [("1f1b", 1), ("interleaved", 2),
                                        ("interleaved-1f1b", 2), ("zb-h1", 1)])
def test_unported_schedules_raise(schedule, V, jax_params, jax_reference):
    """The four schedules beyond contiguous, which the executor and the
    trainer once refused, run at K 2 (D 2, non-uniform slices) and match
    JAX's non-pipelined step; the trainer takes their flags (one step)."""
    model, params = _port(jax_params)
    tcfg = TeraPipeConfig(n_microbatches=2, cache_dtype=torch.float32, schedule=schedule,
                          virtual_stages=V, **SLICINGS["dp"])
    loss, grads = make_terapipe_value_and_grad(model, tcfg, S, B, 2)(params, _torch_batch())
    _check(loss, grads, jax_reference[False])
    history = []
    train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1",
                       "--mode", "terapipe", "--schedule", schedule, "--virtual-stages", str(V),
                       "--microbatches", "2", "--batch", "2", "--seq", "16", "--log-every", "1"],
                      history=history)
    assert len(history) == 1 and abs(history[0]["loss"] - math.log(256)) < 1


STEPS, LR, WARMUP = 3, 1e-2, 2


@pytest.fixture(scope="module")
def jax_losses(jax_params):
    """The losses of a jitted JAX loop of value_and_grad(model.loss) +
    AdamW, STEPS steps from the JAX init."""
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


@pytest.mark.parametrize("mode", ["terapipe", "gpipe"])
def test_train_main_pipelined_matches_jax_loop(mode, jax_params, jax_losses, monkeypatch,
                                               capsys):
    """Three steps of launch.train.main in a pipelined mode on the CPU
    (f32, from the JAX init) against the jitted JAX gspmd loop: pipelining
    changes no number beyond 2e-4."""
    monkeypatch.setattr(Model, "init", lambda self, seed: params_from_jax(jax_params, "cpu"))
    monkeypatch.setattr(train_launch, "get_config",
                        lambda arch, smoke: get_config(arch, smoke).replace(dtype=torch.float32))
    history = []
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", mode, "--microbatches",
            "2", "--token-slices", "4", "--steps", str(STEPS), "--batch", str(B), "--seq",
            str(S), "--lr", str(LR), "--warmup", str(WARMUP), "--log-every", "1", "--unroll"]
    final = train_launch.main(argv, history=history)
    np.testing.assert_allclose([r["loss"] for r in history], jax_losses, rtol=TOL, atol=TOL)
    assert final == history[-1]["loss"]
    assert f"mode {mode}" in capsys.readouterr().out


def _dp_lines(text):
    return [line for line in text.splitlines() if line.startswith("[dp-plan]")]


def _jax_dp_lines(jcfg, seq, capsys, monkeypatch):
    """The reference's --dp-plan block (repro/launch/train.py), run on a
    stand-in 4-rank mesh up to the point where it builds the executor."""
    monkeypatch.setattr(jax_pipeline, "make_terapipe_value_and_grad", lambda *a, **k: (None, None))
    args = argparse.Namespace(mode="terapipe", dp_plan=True, schedule="contiguous",
                              virtual_stages=1, seq=seq, batch=B, microbatches=1,
                              token_slices=4, unroll=False, use_kernel=False)
    capsys.readouterr()
    jax_train.build_value_and_grad(jax_build_model(jcfg), None,
                                   types.SimpleNamespace(shape={"pipe": 4}), args)
    return _dp_lines(capsys.readouterr().out)


def test_dp_plan_of_gpt3_1b_matches_jax(capsys, monkeypatch):
    """plan_slices on the full gpt3-1b at seq 2048 prints the reference's
    [dp-plan] lines exactly (TPU_V5E, the reference's own target)."""
    want = _jax_dp_lines(jax_get_config(ARCH), 2048, capsys, monkeypatch)
    slices, plan = train_launch.plan_slices(get_config(ARCH), 2048, 4, TPU_V5E)
    assert _dp_lines(capsys.readouterr().out) == want
    assert len(slices) > 1 and sum(slices) == 2048 and math.isfinite(plan.latency)


@pytest.mark.parametrize("batch", [2, 4])
def test_dp_plan_on_h100_prices_the_batch_per_slice(batch, capsys):
    """On the H100 spec no byte crosses a link (the ranks are virtual), so
    every unit's time scales with the sequences per slice: the plan at the
    executor's batch is the plan of one sequence, at ``batch`` times its
    latency."""
    one, plan_one = train_launch.plan_slices(get_config(ARCH), 2048, 4, H100)
    slices, plan = train_launch.plan_slices(get_config(ARCH), 2048, 4, H100, batch=batch)
    assert slices == one and sum(slices) == 2048
    np.testing.assert_allclose(plan.latency, batch * plan_one.latency, rtol=1e-12)


def test_train_main_dp_plan_on_cpu(jax_params, capsys, monkeypatch):
    """launch.train.main --mode terapipe --dp-plan on the CPU: the printed
    plan equals the reference's optimal_slicing plan, the steps run on it,
    and --dp-plan outside --mode terapipe is refused."""
    seq = 256
    want = _jax_dp_lines(_configs()[0], seq, capsys, monkeypatch)
    history = []
    train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mode", "terapipe",
                       "--dp-plan", "--use-kernel", "--steps", "1", "--batch", "2", "--seq",
                       str(seq), "--log-every", "1"], history=history)
    out = capsys.readouterr().out
    assert _dp_lines(out) == want and want[0].startswith("[dp-plan] slices [")
    slices = [int(x) for x in re.search(r"slices \[([\d, ]+)\]", want[0]).group(1).split(",")]
    assert sum(slices) == seq
    assert len(history) == 1 and abs(history[0]["loss"] - math.log(256)) < 1
    with pytest.raises(SystemExit):
        train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--dp-plan"])
