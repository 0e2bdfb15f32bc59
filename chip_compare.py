"""Kernel times of this tree beside another tree's (its parent), from one
call on one GPU.

    mkdir -p build/parent && git archive <parent commit> | tar -x -C build/parent
    python3 chip_compare.py build/parent

Runs phase 1 (build) and phase 9 (times) of each tree's ``chip_smoke.py``,
each in a process of its own, in the order other, this, this, other, and
prints their ``[times]`` lines.  Both trees are timed with this tree's
``repro_torch.timing.time_ms``, so a change of timing method does not show
as a change of the kernels.  A tree whose phase 9 does not time the
pipelined step's slice (B 4, l 256, ctx 1792) gets its forward, dQ and
dK/dV timed there too.  Needs one CUDA GPU and nvcc; fails without.
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
    if not hasattr(cs, "_slice_times"):
        _slice(cs)


def _slice(cs) -> None:
    """The forward, dQ and dK/dV of ``cs``'s tree at the pipelined step's
    last slice (its PIPE_CASES[-1]), as this tree's phase 9 times them."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, l, ctx, hq, hkv, hd = cs.PIPE_CASES[-1][:6]
    args = cs._bwd_inputs(b, l, ctx, hq, hkv, hd, 1.0, torch.bfloat16, gen, tail=0) + (ctx,)
    q, k, v = args[:3]
    shape = f"B={b} l={l} ctx={ctx} Sk={ctx + l} Hq={hq} Hkv={hkv} hd={hd} bf16"
    for name, fn in (("terapipe_attention_fwd", lambda: cs.terapipe_attention_fwd(q, k, v, ctx)),
                     ("terapipe_attention_dq", lambda: cs.terapipe_attention_dq(*args)),
                     ("terapipe_attention_dkv", lambda: cs.terapipe_attention_dkv(*args))):
        print(f"[times] {name} ({shape}): kernel {cs.time_ms(fn):.4f} ms", flush=True)


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
