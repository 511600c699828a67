"""The median per frame of the host-clock span from the end of the
accumulate step to the PNG bytes (resolve with the AOVs where due, the
guided NLM, the host copy, ``encode_png``; each sub-span ends in a sync),
in ms."""

import statistics


def read(t):
    if t.kind != "frame" or not t.post_ms:
        return None
    return statistics.median(t.post_ms)
