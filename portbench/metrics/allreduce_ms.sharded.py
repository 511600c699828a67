"""The exchange itself: in each traced step the least over the ranks of
the NCCL all-reduce kernel's device ms (the last rank to arrive waits for
no one), averaged over the steps."""


def read(t):
    ar = t.allreduce_steps() if t.kind == "step" else None
    if ar is None:
        return None
    least = [min(step) for step in zip(*ar)]
    return sum(least) / len(least)
