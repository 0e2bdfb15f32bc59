"""The manifest against the benchmark's contract, cells found by name, and
a run at SMOKE size on the CPU, set-up to the reference's check: what it
imports and what it opens."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from perfbench import cells  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|^(d_model|d_ff|d_expert|hidden|intermediate|head|moe_top_k)")


def test_manifest_keeps_to_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["paths"] == ["perfbench"] and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024
    every = m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[kind]]
        assert len(names) == len(set(names))
    for e in every:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    configs = {c["name"] for c in m["configs"]}
    assert configs == {w["config"] for w in m["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert [w["name"] for w in four] == ["gpt3-1b.terapipe-m8.4card"]
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert set(e2e) == {"tok_s", "tok_s_4card", "peak_gib", "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert set(e) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert e["moves"] in e2e and e["source"] in ("device_trace", "program_span",
                                                   "program_counter", "host_clock")
    for w in m["workloads"]:
        cell = cells.load_cell(w["name"])
        reported = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        for metric in cell.per_layer:
            assert metric["moves"] in reported
    pb = ROOT / "perfbench"
    for w in m["workloads"]:
        assert (pb / "traffic" / f"{w['traffic']}.json").is_file()
        assert (pb / "limits" / f"{w['name']}.json").is_file()
    for e in m["per_layer"]:
        assert (pb / "metrics" / f"{e['name']}.py").is_file()


def test_the_command_names_no_file_outside_its_paths():
    for word in MANIFEST["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert word.split("/")[0] in MANIFEST["paths"]


def test_a_new_cell_is_picked_up_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "gpt3-1b-copy", "source": "https://arxiv.org/abs/2005.14165",
                         "file": "perfbench/configs/gpt3-1b-copy.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "gpt3-1b-copy.new", "config": "gpt3-1b-copy",
                           "traffic": "new-mix", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "new_metric", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "tok_s",
                           "workloads": ["gpt3-1b-copy.new"]})
    m["end_to_end"][0]["workloads"].append("gpt3-1b-copy.new")
    pb = tmp_path / "perfbench"
    shutil.copy(pb / "configs" / "gpt3-1b.json", pb / "configs" / "gpt3-1b-copy.json")
    traffic = json.loads((pb / "traffic" / "gspmd-16x2048.json").read_text())
    (pb / "traffic" / "new-mix.json").write_text(json.dumps(dict(traffic, batch=4)))
    (pb / "limits" / "gpt3-1b-copy.new.json").write_text('{"loss_gap": 0.1}')
    (pb / "metrics" / "new_metric.py").write_text("def read(run):\n    return 42.0\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = cells.load_cell("gpt3-1b-copy.new", root=tmp_path)
    assert cell.traffic["batch"] == 4 and cell.limits == {"loss_gap": 0.1}
    assert [e["name"] for e in cell.end_to_end] == ["tok_s", "peak_gib", "setup_s"]
    assert [e["name"] for e in cell.per_layer] == ["new_metric"]
    assert cells.load_reader("new_metric", root=tmp_path)({}) == 42.0
    with pytest.raises(KeyError):
        cells.load_cell("gpt3-1b-copy.new")            # the repository's manifest lacks it


SETUP_SCRIPT = r"""
import sys
root, cell_name = sys.argv[1], sys.argv[2]
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args else None)
sys.path[:0] = [root, root + "/src"]
import torch
torch.set_num_threads(1)
from perfbench import harness
from perfbench.tests.smoke import smoke_cell
cell = smoke_cell(cell_name)
out = harness.setup_and_window(cell, 2**33 + 5, 0.2, False, "cpu")
assert out["steps"] >= 1 and out["peak_bytes"] == 0
ref = harness.reference_readings(cell, 2**33 + 5, "cpu")
correct, check = harness.judge(out, ref, cell.limits)
print("TOPLEVEL", " ".join(sorted({m.split(".")[0] for m in sys.modules})))
print("OPENED", "\n".join(opened))
"""


@pytest.mark.parametrize("cell", ["gpt3-1b.terapipe-m8", "deepseek-moe-16b.gspmd"])
def test_setup_loads_no_jax_and_opens_nothing_of_the_jax_package(cell):
    done = subprocess.run([sys.executable, "-c", SETUP_SCRIPT, str(ROOT), cell],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.splitlines()
    top = next(x for x in lines if x.startswith("TOPLEVEL")).split()[1:]
    assert "repro_torch" in top
    for bad in ("jax", "jaxlib", "flax", "repro"):
        assert bad not in top, bad
    opened = done.stdout.split("OPENED", 1)[1].split()
    for path in opened:
        assert not path.startswith(str(ROOT / "benchmarks")), path
        assert not path.startswith(str(ROOT / "src" / "repro") + "/"), path


def test_no_source_of_the_benchmark_names_the_jax_package_or_its_benchmarks():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro|benchmarks)\b", re.M)
    folder = "".join(["bench", "marks/"])          # not spelled out: this file is scanned too
    for src in (ROOT / "perfbench").rglob("*.py"):
        text = src.read_text()
        assert not pattern.search(text), src
        assert folder not in text, src
