"""The control of a cell's comparison, and its faults, read on the chip at
the cell's own size; the benchmark's runs never run this.

    python3 perfbench/control.py --workload gpt3-1b.gspmd --seeds 11 12 13

For each seed the reference runs as the benchmark runs it (float32, TF32
off), then in the program's place:

* ``control``: every product in fp8 (``reference/lowp.py``), the precision
  below the configurations' bfloat16;
* ``half_batch``: the first half of each batch's rows alone, the mean over
  them;
* ``altered_answer``: the head's gradient times 1.5 where it is produced;

and each is compared with the float32 run by the benchmark's own numbers
(``harness.gaps``), printed one JSON line per seed and variant.  (A state
left unchanged reads 1 in ``change_gap`` by the measure's definition.)
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def as_program(r: dict) -> dict:
    """Reference readings in the program's place, for ``harness.gaps``."""
    return {"losses": r["loss"], "first_grad": r["grad_norm"], "change": r["change_norm"],
            "nonfinite": 0}


def _alter(grads: dict) -> None:
    grads["lm_head"] *= 1.5


def variants(batch: int) -> dict:
    from perfbench.reference.lowp import fp8_matmul
    return {"control": {"mm": fp8_matmul}, "half_batch": {"rows": batch // 2},
            "altered_answer": {"on_grads": _alter}}


def readings(name: str, seed: int, device, only=None) -> list:
    """``[{"workload", "seed", "variant", "loss_gap", "grad_gap", "change_gap"}]``."""
    from perfbench import cells, harness
    cell = cells.load_cell(name)
    base = harness.reference_readings(cell, seed, device)
    out = []
    for variant, kw in variants(cell.traffic["batch"]).items():
        if only and variant not in only:
            continue
        t = time.time()
        got = harness.gaps(as_program(harness.reference_readings(cell, seed, device, **kw)),
                           base)
        out.append({"workload": name, "seed": seed, "variant": variant,
                    **{k: v["value"] for k, v in got.items()},
                    "at": {k: v["at"] for k, v in got.items()},
                    "seconds": time.time() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("the control is read on the chip", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for row in readings(args.workload, seed, "cuda", args.only):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
