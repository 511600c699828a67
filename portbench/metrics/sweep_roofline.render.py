"""K5c + K5a against their roofline: the summed bound (``harness/work.py``:
bytes at the HBM rate or f32 operations at the f32 rate, counted by the
reference's plain sweep on each launch's own rays) over the summed device
time of the same launches of a pass, each timed by events behind a spin
kernel, in %."""


def read(t):
    calls = t.kernel_calls.get("sweep")
    if not calls:
        return None
    return 100.0 * sum(b for b, _ in calls) / sum(d for _, d in calls)
