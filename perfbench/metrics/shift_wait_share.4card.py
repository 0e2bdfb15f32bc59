"""Share of each card's traced window in which an NCCL kernel launched in
the ring's header exchange (the program's ``ring.header`` span) runs and
no other device activity does (%), averaged over the cards: the exposed
exchange that waits for the peer.  ``comm_exposed_share.4card`` minus it
is the exposed transfer.  Nothing where the program has no such span."""
from perfbench import spans


def read(run):
    return spans.per_card(run["ranks"], spans.shift_wait_share)
