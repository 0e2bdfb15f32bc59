"""The host's time in the tick loop's units (the program's ``pipe.fwd``,
``pipe.bwd``, ``pipe.bwd_input`` and ``pipe.bwd_weight`` spans) over the
device time they launched, averaged over the cards: above 1, issuing a
unit takes longer than running it.  Nothing where the program has no such
spans."""
from perfbench import spans


def read(run):
    return spans.per_card(run["ranks"], spans.unit_host_ratio)
