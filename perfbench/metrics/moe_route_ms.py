"""The device time of MoE routing, dispatch and combine per step (ms),
averaged over the cards: the kernels launched inside the program's
``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans, in the forward
and in remat's recompute (their backward is autograd's, under
``grad.backward``).  Nothing where the program has no such spans."""
from perfbench import spans


def read(run):
    return spans.per_card(run["ranks"], lambda r, found: spans.device_incl_ms_per_step(
        ("moe.route", "moe.dispatch", "moe.combine"), r, found))
