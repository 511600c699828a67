"""Vectorized fixed-trip-count binary search (port of
``tinsel_tpu/core/search.py``)."""

from __future__ import annotations

import numpy as np
import torch


def lower_bound(flat, lo0, n: int, value):
    """First index i in [lo0, lo0+n) with flat[i] >= value (per lane).

    flat: (L,) tensor; lo0: int tensor (per-lane window start); n: window
    length; value: per-lane search value. Returns int32 indices (== lo0 + n
    when every element < value).
    """
    value = torch.as_tensor(value, device=flat.device)
    lo = torch.as_tensor(lo0, dtype=torch.int32, device=flat.device)
    lo = lo + torch.zeros(value.shape, dtype=torch.int32, device=flat.device)
    hi = lo + n
    steps = int(np.ceil(np.log2(max(n, 2)))) + 1
    last = flat.shape[0] - 1
    for _ in range(steps):
        active = lo < hi
        mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
        v = flat[torch.clamp(mid, 0, last).long()]
        go_right = v < value
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo
