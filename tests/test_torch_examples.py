"""The port's examples run on the CPU at a small size, in process:
``examples/dp_planner_demo_torch.py`` prints the JAX demo's plan (the
planning layer is a numpy copy), ``quickstart_torch.py`` trains,
``terapipe_train_torch.py`` trains through the pipeline, checkpoints, and
resumes from its checkpoint, and ``serve_decode_torch.py`` serves through
the engine and the prefill and decode steps."""
import importlib.util
from pathlib import Path

import torch

# the suite runs several workers on the same cores: one intra-op thread
# each keeps torch's pool from oversubscribing them
torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod



def test_dp_planner_demo_prints_the_jax_demos_plan(capsys):
    _load("dp_planner_demo").main()
    want = capsys.readouterr().out
    _load("dp_planner_demo_torch").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want


def test_quickstart_trains(capsys):
    loss = _load("quickstart_torch").main(["--device", "cpu", "--steps", "2"])
    assert 4.0 < loss < 7.0 and "quickstart OK" in capsys.readouterr().out


def test_terapipe_train_checkpoints_and_resumes(tmp_path, capsys):
    mod = _load("terapipe_train_torch")
    args = ["--device", "cpu", "--batch", "2", "--seq", "16", "--slices", "2",
            "--ckpt", str(tmp_path), "--ckpt-every", "1"]
    mod.main(args + ["--steps", "1"])
    assert (tmp_path / "step_00000001" / "manifest.json").exists()
    loss = mod.main(args + ["--steps", "2", "--resume"])
    assert "resumed at step 1" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001", "step_00000002"]
    assert 8.0 < loss < 10.0


def test_serve_decode_serves_every_family(capsys):
    out = _load("serve_decode_torch").main(["--device", "cpu"])
    eng = out["engine"]
    assert eng["tokens"] == eng["solo"] and len(eng["tokens"]) == 16
    assert eng["prefill_chunks"] == 5 and eng["decode_rounds"] > 15
    for arch in ("mamba2-2.7b", "recurrentgemma-9b", "whisper-medium"):
        assert len(out[arch]) == 4 and all(len(row) == 16 for row in out[arch])
    printed = capsys.readouterr().out
    assert "single-request degenerate case matches" in printed
    assert printed.rstrip().endswith("serving OK")
