"""Share of each card's traced window in which an NCCL kernel runs and no
other kernel does (%), averaged over the cards: the exchange between the
pipeline's stages that nothing hides, waiting for the peer included."""


def read(run):
    ranks = run["ranks"]
    return 100.0 * sum(r["nccl_exclusive_s"] / r["window_s"] for r in ranks) / len(ranks)
