"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 perfbench/run.py --workload gpt3-1b.terapipe-m8 --seed 7 --seconds 30 --trace 0

A one-card cell runs in this process.  A cell on several cards starts one
process per card under ``torch.distributed.run`` (this file again, with
``--rank``), after building the CUDA kernels once; its rank 0 prints the
line.  Every cache the program builds stays inside the checkout, under
``build/``.  Without CUDA, or with fewer cards than the cell asks for, it
exits with code 3 and prints no result.
"""
from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the CUDA sources the training step launches
KERNEL_SOURCES = ("terapipe_attention_fwd", "terapipe_attention_bwd")


def _environment() -> None:
    """The port on the path, its caches in the checkout, and one CPU thread
    for torch's own operators: the host's work is launching kernels, and
    an idle thread pool only takes cores from it."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["OMP_NUM_THREADS"] = "1"
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--run-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    _environment()
    import torch
    torch.set_num_threads(1)

    from perfbench import cells, harness

    cell = cells.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        harness.log(f"[perfbench] {cell.name} needs {cell.chips} CUDA device(s); "
                    f"this machine has {found}")
        return 3
    traced = bool(args.trace)
    if args.rank:
        return harness.run_rank(cell, args.seed, args.seconds, traced,
                                float(os.environ["PERFBENCH_T0"]), Path(args.run_dir))
    from repro_torch.kernels import _build
    _build.build_all(KERNEL_SOURCES)
    if cell.chips == 1:
        return harness.run_one_process(cell, args.seed, args.seconds, traced, T0)
    return _spawn(cell, args)


def _spawn(cell, args) -> int:
    """The cell's ranks, one process per card, under torch.distributed.run
    on a free port (the kernels are built already); their measurements pass
    through a directory under ``TMPDIR``, removed at the end.  NCCL's
    shared-memory transport is off (the cards talk over NVLink), so that
    nothing is written to ``/dev/shm``."""
    run_dir = tempfile.mkdtemp(prefix="perfbench-")
    env = dict(os.environ, PERFBENCH_T0=repr(T0), NCCL_SHM_DISABLE="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(cell.chips), str(Path(__file__).resolve()),
           "--workload", cell.name, "--seed", str(args.seed), "--seconds", str(args.seconds),
           "--trace", str(args.trace), "--rank", "--run-dir", run_dir]
    try:
        return subprocess.run(cmd, env=env, cwd=ROOT).returncode
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
