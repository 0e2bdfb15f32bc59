"""The port's checkpoint manager against the JAX package's.

The on-disk format is the reference's (``repro/checkpoint/manager.py``), so
checkpoints cross between the packages in both directions bit for bit:
the JAX manager's checkpoint of 2 JAX training steps of gpt3 smoke restores
into the port and the port's ``launch.train --resume`` takes step 3 within
2e-4 of JAX's (f32, as ``tests/test_torch_train.py``); a port checkpoint
restores into the JAX manager, which writes the same manifest for it.  The
port's versions of
``tests/test_substrate.py::test_checkpoint_{roundtrip_and_retention,atomic_no_partial,elastic_resharding}``
run on the port alone.
"""
import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint import CheckpointManager, meta_target
from repro_torch.configs import get_config
from repro_torch.launch import train as train_launch
from repro_torch.optim import adamw
from repro_torch.tree import jax_leaves, jax_unflatten, tree_map
from repro_torch.weights import params_from_jax

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
ARCH = "gpt3-1b"
B, S = 2, 32


def _bits(leaf) -> np.ndarray:
    """A leaf of either package as raw integer bits (bf16 as uint16)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.detach().view(torch.int16).numpy().view(np.uint16)
        leaf = leaf.detach().numpy()
    a = np.asarray(leaf)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(port_tree, jax_tree):
    got, want = jax_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _bits(g), _bits(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype, w.dtype, g.shape)
        assert np.array_equal(g, w), f"leaf {i} differs"


def _jax_model():
    return jax_build_model(jax_get_config(ARCH, smoke=True).replace(dtype=jnp.float32))


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(_jax_model().init(jax.random.PRNGKey(0))[0])


# ------------------------------------------------------------ the port alone
def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    opt = adamw.adamw(0.1, master_weights=True)
    params = {"w": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
              "nested": {"b": torch.ones(4, dtype=torch.bfloat16)}}
    tree = {"params": params, "opt": opt.init(params), "step": 5,
            "ids": torch.arange(3, dtype=torch.int64)}
    for s in (10, 20, 30):
        mgr.save(s, tree)
    assert mgr.all_steps() == [20, 30]          # retention
    assert [r["op"] for r in mgr.log] == ["save"] * 3 and mgr.log[-1]["bytes"] > 0
    out = mgr.restore(target=tree)
    assert out["params"]["nested"]["b"].dtype == torch.bfloat16
    assert out["opt"].step.dtype == torch.int32 and out["opt"].master["w"].dtype == torch.float32
    assert out["ids"].dtype == torch.int64
    assert out["step"].dtype == torch.int64 and int(out["step"]) == 5
    assert type(out["opt"]) is adamw.AdamWState
    for a, b in zip(jax_leaves(out), jax_leaves(tree)):
        assert np.array_equal(_bits(a), _bits(torch.as_tensor(b)))
    with np.load(tmp_path / "step_00000030" / "proc0.npz") as data:   # plain npz members
        assert sorted(data.files) == sorted(f"leaf_{i}" for i in range(len(jax_leaves(tree))))
        # keys sorted: "ids", then "opt" (whose step field comes first)
        assert [data[f"leaf_{i}"].dtype for i in (0, 1)] == [np.int64, np.int32]
    assert mgr.log[-1]["op"] == "restore"


def test_checkpoint_atomic_no_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3)})
    # a stale tmp dir from a crashed writer must not be listed
    (tmp_path / "step_00000099.tmp0").mkdir()
    assert mgr.all_steps() == [1]
    assert int(mgr.restore(target={"w": torch.zeros(3)})["w"].sum()) == 3


def test_checkpoint_elastic_restore_onto_any_device_and_mismatches_raise(tmp_path):
    """Saved from one layout, restored onto a target that holds only shapes
    (meta tensors) on the device asked for; a target that does not match
    the manifest raises rather than reinitialising."""
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(16.0).reshape(4, 4), "k": torch.arange(3, dtype=torch.int32)}
    mgr.save(1, tree)
    out = mgr.restore(target=meta_target(tree), device="cpu")
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], tree["w"]) and torch.equal(out["k"], tree["k"])
    bad = [({"w": torch.zeros(4, 5), "k": tree["k"]}, "shape"),
           ({"w": tree["w"], "k": tree["k"].long()}, "dtype"),
           ({"w": tree["w"]}, "count")]
    for target, what in bad:
        with pytest.raises(ValueError):
            mgr.restore(target=target)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(target=tree)


def test_meta_target_keeps_no_reference_to_the_state():
    """The launcher builds its restore target once, at init: a meta copy
    that kept the parameters alive (through a grad_fn) would hold a second
    copy of them for the whole run."""
    p = torch.ones(3, requires_grad=True)
    target = meta_target({"p": p, "opt": adamw.adamw(0.1).init({"p": p})})
    assert target["p"].device.type == "meta" and target["p"].grad_fn is None
    ref = weakref.ref(p)
    del p
    gc.collect()
    assert ref() is None


def test_jax_order_flatten_matches_jax_tree():
    """Dict keys sorted, named tuples in field order, None dropped: the
    order of jax.tree.flatten, which the checkpoint's leaf indices follow."""
    tree = {"b": [np.zeros(1), (np.ones(2), None)], "a": {"y": np.full(3, 2.0), "x": None},
            "opt": jax_adamw.AdamWState(np.int32(0), {"q": np.zeros(1)}, {"q": np.ones(1)})}
    got = jax_leaves(tree)
    want = jax.tree.leaves(tree)
    assert len(got) == len(want) and all(g is w for g, w in zip(got, want))
    back = jax_unflatten(tree, got)
    assert back["a"]["x"] is None and back["b"][1][1] is None
    assert type(back["opt"]) is jax_adamw.AdamWState and list(back) == ["b", "a", "opt"]
    with pytest.raises(ValueError):
        jax_unflatten(tree, got[:-1])


# -------------------------------------------------------- across the packages
def test_jax_checkpoint_restores_into_the_port_and_training_continues(
        tmp_path, jax_params, monkeypatch):
    """2 JAX steps, saved by the JAX manager; the port restores every leaf
    bit for bit, and ``launch.train --resume`` takes step 3 within 2e-4 of
    JAX's step 3."""
    steps, lr, warmup = 3, 1e-2, 2
    jmodel = _jax_model()
    opt = jax_adamw.adamw(jax_adamw.cosine_schedule(lr, warmup, steps))

    @jax.jit
    def step_fn(p, s, batch):
        loss, grads = jax.value_and_grad(jmodel.loss)(p, batch)
        updates, s = opt.update(grads, s, p)
        return jax_adamw.apply_updates(p, updates), s, loss

    data = jax_pipeline.DataPipeline(jax_pipeline.SyntheticSource(256, 0), B, S)
    p, s, want = jax_params, opt.init(jax_params), []
    for i in range(steps):
        if i == 2:
            JaxCheckpointManager(str(tmp_path)).save(2, {"params": p, "opt": s, "step": 2})
        p, s, loss = step_fn(p, s, {k: jnp.asarray(v) for k, v in data.batch_at(i).items()})
        want.append(float(loss))
    saved = JaxCheckpointManager(str(tmp_path)).restore(
        target={"params": jax_params, "opt": opt.init(jax_params), "step": 0})

    # the port's own structure as the target (its init draws other numbers)
    port_params = params_from_jax(jax_params, "cpu")
    target = {"params": port_params, "opt": adamw.adamw(lr).init(port_params), "step": 0}
    got = CheckpointManager(str(tmp_path)).restore(target=target)
    _assert_bit_equal(got, saved)

    monkeypatch.setattr(train_launch, "get_config",
                        lambda arch, smoke: get_config(arch, smoke).replace(dtype=torch.float32))
    history, out = [], {}
    train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", str(steps),
                       "--batch", str(B), "--seq", str(S), "--lr", str(lr), "--warmup",
                       str(warmup), "--log-every", "1", "--checkpoint-dir", str(tmp_path),
                       "--resume"], history=history, out=out)
    assert [r["step"] for r in history] == [3]
    np.testing.assert_allclose(history[0]["loss"], want[2], rtol=TOL, atol=TOL)
    assert out["checkpoints"][0]["op"] == "restore" and out["checkpoints"][0]["step"] == 2
    assert int(out["state"]["opt"].step) == 3


@pytest.mark.parametrize("bf16_master", [False, True], ids=["f32", "bf16+master"])
def test_port_checkpoint_restores_into_jax_with_the_same_manifest(
        tmp_path, jax_params, bf16_master):
    """A port state after one AdamW update (bf16 parameters with f32 master
    weights, or f32 without) restores into the JAX manager bit for bit, and
    the JAX manager's checkpoint of that state has the port's manifest."""
    jparams = (jax.tree.map(lambda a: np.asarray(a, jnp.bfloat16), jax_params)
               if bf16_master else jax_params)
    params = params_from_jax(jparams, "cpu")
    opt = adamw.adamw(1e-2, master_weights=bf16_master)
    gen = torch.Generator().manual_seed(3)
    grads = tree_map(lambda a: torch.randn(a.shape, generator=gen).to(a.dtype), params)
    updates, opt_state = opt.update(grads, opt.init(params), params)
    state = {"params": adamw.apply_updates(params, updates), "opt": opt_state, "step": 1}
    CheckpointManager(str(tmp_path / "port")).save(1, state)

    jopt = jax_adamw.adamw(1e-2, master_weights=bf16_master)
    jtarget = {"params": jparams, "opt": jopt.init(jparams), "step": 0}
    back = JaxCheckpointManager(str(tmp_path / "port")).restore(target=jtarget)
    _assert_bit_equal(state, back)
    JaxCheckpointManager(str(tmp_path / "jax")).save(1, back)
    port_m, jax_m = ((tmp_path / d / "step_00000001" / "manifest.json").read_text()
                     for d in ("port", "jax"))
    assert port_m == jax_m
    dtypes = {e["dtype"] for e in json.loads(port_m)["leaves"]}
    assert dtypes == ({"bfloat16", "float32", "int32", "int64"} if bf16_master
                      else {"float32", "int32", "int64"})
