"""Camera paths (pixel samples) of the window's whole passes over its
seconds, in millions a second."""


def read(w):
    return w.iterations * w.paths / w.seconds / 1e6 if w.unit == "pass" else None
