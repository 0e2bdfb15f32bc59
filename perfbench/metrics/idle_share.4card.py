"""Share of the traced window in which nothing ran on the card (%),
averaged over the cards: torch.profiler's CUDA activity (kernels, copies,
sets) over the profiled steps of the four-card cell, each card its own trace."""


def read(run):
    ranks = run["ranks"]
    return 100.0 * sum(1.0 - r["busy_s"] / r["window_s"] for r in ranks) / len(ranks)
