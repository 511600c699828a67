"""The miss distance of every search (``tinsel_tpu/geometry/intersect.py``'s
``INF``)."""

INF = float("inf")
