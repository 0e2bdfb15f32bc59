"""The attention kernels' share of their roofline (%): the least time of the
attention work a step needs (every layer's forward, dQ and dK/dV at the
cell's shapes, ``perfbench/yardstick.py``) over the device time of every
attention kernel in the trace (the forward, its recompute under remat, dQ,
dK/dV), per step.  Nothing when the trace holds none of them."""
import re

from perfbench import yardstick

#: the port's attention kernels (``src/repro_torch/kernels/csrc``)
KERNELS = re.compile(r"\b(fwd|dq|dkv)_kernel_(bf16|f32)\b")


def read(run):
    spent = [sum(v[1] for n, v in r["by_kernel"].items() if KERNELS.search(n)) / r["steps"]
             for r in run["ranks"]]
    per_step = sum(spent) / len(spent)
    if per_step <= 0:
        return None
    t = run["traffic"]
    return 100.0 * yardstick.attention_bound_per_step_s(run["cfg"], t["batch"], t["seq"]) / per_step
