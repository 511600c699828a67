"""K3 + K4 against their roofline: the summed bound (``harness/work.py``,
the node rows and blocks read and the tests made counted by the
reference's plain walk on each sampled launch's own inputs) over the
summed device time of the same launches, in %."""


def read(t):
    calls = t.kernel_calls.get("walk")
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(d for _, d in calls)
