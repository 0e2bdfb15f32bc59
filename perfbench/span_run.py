"""Runs one cell's set-up, window and traced steps with the program's spans
reduced beside the trace, and prints what the span metrics read:

    python3 perfbench/span_run.py --workload gpt3-1b.terapipe-m8 --seed 7 --seconds 30 \\
        --out build/spans.gpt3-1b.terapipe-m8.json

The traced steps' reduction is ``trace.summarize``'s with
``spans.reduce``'s under its ``"spans"`` key.  The last line of standard
output (and ``--out``) holds the card's name, each card's untraced step
time (the window's), traced step time (the profiled steps'), trace and
span reduction, the cell's own per-layer metrics and the readers of
``SPAN_METRICS`` on those traces.  No reference runs: ``run.py`` decides
``correct``.  A cell on several cards starts one process per card under
``torch.distributed.run`` (this file again, with ``--rank``).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
#: the readers of the program's spans (``perfbench/metrics``)
SPAN_METRICS = ("optimizer_ms", "moe_route_ms", "unit_host_ratio", "unit_host_ratio.4card",
                "shift_wait_share.4card")


def _with_spans() -> None:
    """``trace.summarize`` with ``spans.reduce`` of the same trace beside it."""
    from perfbench import spans, trace
    summarize = trace.summarize

    def both(prof, steps):
        out = summarize(prof, steps)
        out["spans"] = spans.reduce(prof, steps)
        return out

    trace.summarize = both


def measure(cell, seed: int, seconds: float, device, dist=None, barrier=None, say=None) -> dict:
    from perfbench import harness
    out = harness.setup_and_window(cell, seed, seconds, True, device, dist, barrier,
                                   say or harness.log)
    t = out["trace"]
    return {"step_s": out["window_s"] / out["steps"], "traced_step_s": t["window_s"] / t["steps"],
            "steps": out["steps"], "trace": t}


def result(cell, runs, device_kind: str) -> dict:
    from perfbench import cells, harness
    ctx = {"cfg": cell.config, "traffic": cell.traffic, "chips": cell.chips,
           "step_s": runs[0]["step_s"], "ranks": [r["trace"] for r in runs]}
    return {"workload": cell.name, "device": device_kind, "cards": runs,
            "metrics": harness.per_layer_metrics(cell, runs, runs[0]["step_s"]),
            "span_metrics": {n: cells.load_reader(n)(ctx) for n in SPAN_METRICS}}


def _rank(cell, args) -> int:
    from perfbench import harness
    from repro_torch.launch import train as launch
    mesh, groups, device = launch._start_processes(SimpleNamespace(mode=cell.traffic["mode"],
                                                                   device="cuda"))
    world = groups["world"]
    m = measure(cell, args.seed, args.seconds, device, SimpleNamespace(mesh=mesh, groups=groups),
                world.barrier, harness.log if world.rank == 0 else harness.quiet)
    (Path(args.run_dir) / f"rank{world.rank}.json").write_text(json.dumps(m))
    world.barrier()
    import torch
    torch.distributed.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--run-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    from perfbench import run
    run._environment()
    import torch
    torch.set_num_threads(1)
    from perfbench import cells, harness
    _with_spans()
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"[span_run] {cell.name} needs {cell.chips} CUDA device(s)")
        return 3
    if args.rank:
        return _rank(cell, args)
    from repro_torch.kernels import _build
    _build.build_all(run.KERNEL_SOURCES)
    if cell.chips == 1:
        runs = [measure(cell, args.seed, args.seconds, "cuda")]
    else:
        run_dir = tempfile.mkdtemp(prefix="perfbench-")
        try:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc-per-node", str(cell.chips), str(Path(__file__).resolve()),
                   "--workload", cell.name, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--rank", "--run-dir", run_dir]
            rc = subprocess.run(cmd, env=dict(os.environ, NCCL_SHM_DISABLE="1"),
                                cwd=ROOT).returncode
            if rc:
                return rc
            runs = [json.loads((Path(run_dir) / f"rank{r}.json").read_text())
                    for r in range(cell.chips)]
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
    line = json.dumps(result(cell, runs, torch.cuda.get_device_name(0)))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
