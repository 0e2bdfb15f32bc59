"""Device kernels per step in the trace, per card, averaged over the cards:
what the host issues through the executor's tick loop and the model's
ops (copies and sets not counted)."""


def read(run):
    ranks = run["ranks"]
    return sum(r["kernels"] / r["steps"] for r in ranks) / len(ranks)
