"""Camera paths (pixel samples) of the window's whole passes (or, over
several cards, whole steps of the whole image) over its seconds, in
millions a second."""


def read(w):
    return w.iterations * w.paths / w.seconds / 1e6 if w.unit in ("pass", "step") else None
