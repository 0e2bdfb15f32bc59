"""The device time of the optimizer's update and its application, per step
(ms), averaged over the cards: what the kernels launched inside the
program's ``step.optimizer`` span took (``perfbench/spans.py``).  Nothing
where the program has no such span."""
from perfbench import spans


def read(run):
    return spans.per_card(run["ranks"], lambda r, found: spans.device_incl_ms_per_step(
        ("step.optimizer",), r, found))
