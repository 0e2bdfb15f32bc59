"""Runs of the cells at SMOKE size on the CPU, the look for a chip skipped,
with the timed path broken underneath: each fault a cell can have must
turn ``correct`` false.  The four-card cell runs its four ranks under
``torch.distributed.run`` on gloo, as the chip runs them on NCCL."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402
from perfbench.tests.smoke import smoke_cell  # noqa: E402

torch.set_num_threads(1)
SEED = 2**31 + 977


def _unchanged_state(vg_fn, opt, state, batch):
    """A step that computes its loss and returns the state unchanged."""
    loss, _ = vg_fn(state["params"], batch)
    return loss.detach()


def _half_batch(step_fn):
    """The step on the first half of the batch's rows alone: the mean over
    the rest."""
    def step(vg_fn, opt, state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step_fn(vg_fn, opt, state, half)
    return step


def _altered_answer(step_fn):
    """One gradient leaf altered where the backward pass produces it."""
    def step(vg_fn, opt, state, batch):
        def vg(params, b):
            loss, grads = vg_fn(params, b)
            grads["lm_head"] = grads["lm_head"] * 1.5
            return loss, grads
        return step_fn(vg, opt, state, batch)
    return step


def _run(cell, fault=None, monkeypatch=None):
    from repro_torch.launch import train as launch
    if fault is not None:
        step = fault if fault is _unchanged_state else fault(launch.train_step)
        monkeypatch.setattr(launch, "train_step", step)
    out = harness.setup_and_window(cell, SEED, 0.2, False, "cpu")
    ref = harness.reference_readings(cell, SEED, "cpu")
    return harness.judge(out, ref, cell.limits)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["gpt3-1b.gspmd", "deepseek-moe-16b.gspmd"])
def test_a_fault_in_the_whole_sequence_step_is_not_correct(name, fault, monkeypatch):
    correct, check = _run(smoke_cell(name), FAULTS[fault], monkeypatch)
    assert not correct, check


@pytest.mark.parametrize("name", ["gpt3-1b.gspmd", "gpt3-1b.terapipe-m8",
                                  "deepseek-moe-16b.gspmd"])
def test_a_sound_run_is_correct(name):
    correct, check = _run(smoke_cell(name))
    assert correct, check


def test_a_number_without_a_limit_is_not_compared():
    ref = {"loss": [1.0, 1.0], "grad_norm": {"a": 1.0, "b": 2.0},
           "change_norm": {"a": 1.0, "b": 1.0}}
    prog = {"losses": [1.5, 1.0], "first_grad": {"a": 1.0, "b": 2.0},
            "change": {"a": 1.0, "b": 1.0}, "nonfinite": 0}
    correct, check = harness.judge(prog, ref, {"grad_gap": 0.1, "change_gap": 0.1})
    assert correct and "loss_gap" not in check
    correct, check = harness.judge(prog, ref, {"loss_gap": 0.1})
    assert not correct and check["loss_gap"] == {"value": 0.5, "limit": 0.1}
    correct, _ = harness.judge(dict(prog, nonfinite=1), ref, {})
    assert not correct


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer"])
def test_a_fault_in_the_pipelined_step_is_not_correct(fault, monkeypatch):
    correct, check = _run(smoke_cell("gpt3-1b.terapipe-m8"), FAULTS[fault], monkeypatch)
    assert not correct, check


def test_half_the_batch_in_the_pipelined_step_is_not_correct(monkeypatch):
    """The executor is built for its batch: the fault is a step whose
    value-and-grad was built for, and sees, half of the rows."""
    from repro_torch.core.pipeline import TeraPipeConfig, make_terapipe_value_and_grad
    cell = smoke_cell("gpt3-1b.terapipe-m8")
    real = harness.Program.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        t = cell.traffic
        tcfg = TeraPipeConfig(n_token_slices=t["token_slices"], n_microbatches=1)
        half = make_terapipe_value_and_grad(self.model, tcfg, t["seq"], t["batch"] // 2, 4)
        self.vg = lambda params, batch: half(params, {k: v[: t["batch"] // 2]
                                                      for k, v in batch.items()})
    monkeypatch.setattr(harness.Program, "__init__", init)
    correct, check = _run(cell)
    assert not correct, check


RANK_SCRIPT = r"""
import sys, time
from pathlib import Path
root, run_dir, fault = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path[:0] = [root, root + "/src"]
import torch
torch.set_num_threads(1)
from perfbench import harness
from perfbench.tests.smoke import smoke_cell
if fault == "exchange":
    from repro_torch.distributed import transport
    shift = transport.DistRing.shift
    def lost(self, sent, step=1):
        got = shift(self, sent, step)
        return [None if g is None else torch.zeros_like(g) for g in got]
    transport.DistRing.shift = lost
cell = smoke_cell("gpt3-1b.terapipe-m8.4card")
sys.exit(harness.run_rank(cell, %d, 0.5, False, time.time(), Path(run_dir), device="cpu"))
""" % SEED


@pytest.mark.parametrize("fault", ["none", "exchange"])
def test_four_ranks_on_gloo(fault, tmp_path):
    """The four-card cell's ranks as processes on the CPU: a sound run is
    correct, and one whose ring shifts deliver zeros is not."""
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t = time.time()
    done = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "4", str(script), str(ROOT), str(tmp_path), fault],
                          capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 4,
                              "memory_peak_bytes": 0}
    assert set(line["metrics"]) == {"tok_s_4card", "peak_gib", "setup_s"}
    assert 0 < line["metrics"]["setup_s"]["value"] < time.time() - t
    assert line["correct"] is (fault == "none"), line["check"]
