"""The cards' idle share of the traced steps: for each rank, 1 - (the
union of its device records' intervals) / (its traced wall time); the
mean over the ranks, in %."""


def read(t):
    if t.kind != "step" or any(r["busy_s"] <= 0 or r["window_s"] <= 0 for r in t.ranks):
        return None
    return 100.0 * sum(1.0 - r["busy_s"] / r["window_s"] for r in t.ranks) / len(t.ranks)
