"""The device's idle share of the traced window: 1 - (the union of the
device records' intervals) / (the window's wall time), in %."""


def read(t):
    if t.kind != "pass" or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
