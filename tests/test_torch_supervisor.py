"""The port's training supervisor (``launch.train``) against the reference's
fault-tolerance contract (PR 3; ``tests/test_system.py::test_train_driver_fault_{tolerance,no_checkpoint_dir}``),
in process, under gspmd and the pipelined step with the contiguous and
1f1b schedules:

* a fault after step k with a checkpoint dir restores the latest
  checkpoint and ends bit-equal to an uninterrupted run (final npz);
* with a checkpoint dir and nothing saved yet the run raises "cannot
  retry";
* without a checkpoint dir the step is replayed from the rescue
  references: the same ``done:`` line and final state;
* ``--resume`` continues from the latest checkpoint to the same state;
* a gspmd checkpoint resumes under 1f1b (another layout) within 2e-4.

gpt3 smoke at f32 (the tolerance of ``tests/test_torch_train.py``).
"""
import re
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import train as train_launch
from repro_torch.tree import jax_leaves

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

TOL = 2e-4
STEPS, EVERY, FAULT = 4, 2, 3
COMMON = ["--arch", "gpt3-1b", "--smoke", "--device", "cpu", "--steps", str(STEPS),
          "--batch", "2", "--seq", "32", "--log-every", "1", "--lr", "1e-2", "--warmup", "2"]
MODES = {"gspmd": [],
         "contiguous": ["--mode", "terapipe", "--token-slices", "4"],
         "1f1b": ["--mode", "terapipe", "--token-slices", "4", "--schedule", "1f1b"]}


@pytest.fixture(autouse=True)
def f32(monkeypatch):
    monkeypatch.setattr(train_launch, "get_config",
                        lambda arch, smoke: get_config(arch, smoke).replace(dtype=torch.float32))


def _run(mode, *extra, capsys=None):
    """``launch.train.main`` under ``mode``: (history, out, stdout + stderr)."""
    history, out = [], {}
    train_launch.main(COMMON + MODES[mode] + list(extra), history=history, out=out)
    text = ""
    if capsys is not None:
        cap = capsys.readouterr()
        text = cap.out + cap.err
    return history, out, text


def _state_equal(a, b) -> bool:
    return all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
               for x, y in zip(jax_leaves(a), jax_leaves(b)))


def _npz_equal(a, b) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return x.files == y.files and all(np.array_equal(x[k], y[k]) for k in x.files)


def _done(text):
    return re.findall(r"^done:.*$", text, flags=re.M)


@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """One uninterrupted run per mode with checkpoints every EVERY steps."""
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(train_launch, "get_config",
               lambda arch, smoke: get_config(arch, smoke).replace(dtype=torch.float32))
    try:
        for mode in MODES:
            d = tmp_path_factory.mktemp(f"base-{mode}")
            history, o, _ = _run(mode, "--checkpoint-dir", str(d),
                                 "--checkpoint-every", str(EVERY))
            out[mode] = {"dir": d, "history": history, "out": o}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_fault_with_checkpoint_dir_restores_bit_exactly(mode, baselines, tmp_path, capsys):
    base = baselines[mode]
    _, out, text = _run(mode, "--checkpoint-dir", str(tmp_path), "--checkpoint-every",
                        str(EVERY), "--simulate-failure-at", str(FAULT), capsys=capsys)
    assert f"[fault] step {FAULT}: injected fault" in text
    assert f"[fault] restored checkpoint at step {EVERY}" in text
    final = f"step_{STEPS:08d}/proc0.npz"
    assert _npz_equal(base["dir"] / final, tmp_path / final)
    assert _state_equal(out["state"], base["out"]["state"])
    ops = [(r["op"], r["step"]) for r in out["checkpoints"]]
    assert ops == [("save", 2), ("restore", 2), ("save", 4)]


@pytest.mark.parametrize("mode", list(MODES))
def test_fault_before_any_checkpoint_cannot_retry(mode, tmp_path, capsys):
    with pytest.raises(RuntimeError, match="injected fault"):
        _run(mode, "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "100",
             "--simulate-failure-at", "1")
    assert "cannot retry" in capsys.readouterr().err


@pytest.mark.parametrize("mode", list(MODES))
def test_fault_without_checkpoint_dir_retries_from_rescue_references(mode, baselines, capsys):
    _, _, plain = _run(mode, capsys=capsys)
    _, out, retried = _run(mode, "--simulate-failure-at", str(FAULT), capsys=capsys)
    assert "retrying step with rescue references" in retried
    assert _done(plain) and _done(plain) == _done(retried)
    assert _state_equal(out["state"], baselines[mode]["out"]["state"])
    assert out["checkpoints"] == []


@pytest.mark.parametrize("mode", list(MODES))
def test_resume_continues_to_the_same_state(mode, baselines, tmp_path):
    base = baselines[mode]
    shutil.copytree(base["dir"] / f"step_{EVERY:08d}", tmp_path / f"step_{EVERY:08d}")
    history, out, _ = _run(mode, "--checkpoint-dir", str(tmp_path), "--resume")
    assert [r["step"] for r in history] == list(range(EVERY + 1, STEPS + 1))
    assert [r["loss"] for r in history] == [r["loss"] for r in base["history"][EVERY:]]
    assert _state_equal(out["state"], base["out"]["state"])


def test_gspmd_checkpoint_resumes_under_1f1b(baselines, tmp_path):
    """The elastic contract: the layout that reads a checkpoint (the
    pipelined step on 4 virtual ranks) differs from the one that wrote it."""
    base = baselines["gspmd"]
    shutil.copytree(base["dir"] / f"step_{EVERY:08d}", tmp_path / f"step_{EVERY:08d}")
    history, _, _ = _run("1f1b", "--checkpoint-dir", str(tmp_path), "--resume")
    want = [r["loss"] for r in base["history"][EVERY:]]
    np.testing.assert_allclose([r["loss"] for r in history], want, rtol=TOL, atol=TOL)
