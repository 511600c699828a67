"""The 95th percentile of the window's frame times (each from the start of
its accumulate step to its PNG bytes), in ms, over all frames."""

import numpy as np


def read(w):
    return float(np.percentile(np.asarray(w.times) * 1e3, 95)) if w.unit == "frame" else None
