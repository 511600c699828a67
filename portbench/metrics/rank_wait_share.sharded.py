"""The share of a step that the cards wait at the all-reduce for the
slowest share: in each traced step, each rank's NCCL all-reduce kernel ms
less the least of any rank's in that step (the last rank to arrive waits
for no one), summed over the steps and taken over the rank's traced wall
ms; the mean over the ranks, in %."""


def read(t):
    ar = t.allreduce_steps() if t.kind == "step" else None
    if ar is None:
        return None
    least = [min(step) for step in zip(*ar)]
    shares = [sum(a - m for a, m in zip(mine, least)) / (r["window_s"] * 1e3)
              for mine, r in zip(ar, t.ranks)]
    return 100.0 * sum(shares) / len(shares)
