"""The whole step's share of the cards' bf16 peak (%): the configuration's
model FLOPs per step (``perfbench/yardstick.py``) over the four-card step time of the
window, which runs before the profiler starts, times the peak and the
cards."""
from perfbench import yardstick


def read(run):
    t = run["traffic"]
    flops = yardstick.model_flops_per_step(run["cfg"], t["batch"], t["seq"])
    return 100.0 * flops / (run["step_s"] * yardstick.PEAK_BF16_FLOPS * run["chips"])
