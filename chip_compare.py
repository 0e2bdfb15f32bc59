"""Kernel times of this tree beside another tree's (its parent), from one
call on one GPU.

    mkdir -p build/parent && git archive <parent commit> | tar -x -C build/parent
    python3 chip_compare.py build/parent

Runs phase 1 (build) and phase 5 (times) of each tree's ``chip_smoke.py``,
each in a process of its own, in the order other, this, this, other, and
prints their ``[times]`` lines.  Both trees are timed with this tree's
``repro_torch.timing.time_ms``, so a change of timing method does not show
as a change of the kernels.  Needs one CUDA GPU and nvcc; fails without.
"""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _one(root: Path) -> None:
    """Build and time the kernels of the tree at ``root``."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    if Path(cs.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {cs.__file__}, not {root}/chip_smoke.py")
    spec = importlib.util.spec_from_file_location(
        "timing_here", HERE / "src" / "repro_torch" / "timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    cs.time_ms = timing.time_ms
    print(f"=== {root}", flush=True)
    cs.phase_build()
    cs.phase_times(dict.fromkeys(cs.COUNTERS, 0.0), dict.fromkeys(cs.COUNTERS, 0))


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--one":
        _one(Path(argv[2]).resolve())
        return 0
    if len(argv) != 2 or not (Path(argv[1]) / "chip_smoke.py").exists():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[1]).resolve()
    for root in (other, HERE, HERE, other):
        subprocess.run([sys.executable, __file__, "--one", str(root)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
