"""Procedural mesh builders (host-side NumPy): the port's own copy of
``tinsel_tpu/scene/procedural.py``, cut to the UV sphere that the
ajaxenv stand-in mesh starts from. Each returns an un-built ``Mesh``; ``mesh.build()`` computes
normals, the area CDF and the BVH.
"""

from __future__ import annotations

import numpy as np

from .model import Mesh


def sphere(radius: float = 1.0, n_theta: int = 16, n_phi: int = 32) -> Mesh:
    """UV-sphere (poles duplicated per longitude ring row for simplicity)."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    pos = np.stack(
        [
            radius * np.sin(T) * np.cos(P),
            radius * np.cos(T),
            radius * np.sin(T) * np.sin(P),
        ],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    i = np.arange(n_theta)[:, None]
    j = np.arange(n_phi)[None, :]
    a = i * n_phi + j
    b = i * n_phi + (j + 1) % n_phi
    c = (i + 1) * n_phi + j
    d = (i + 1) * n_phi + (j + 1) % n_phi
    idx = np.concatenate(
        [
            np.stack([a, c, b], axis=-1).reshape(-1, 3),
            np.stack([b, c, d], axis=-1).reshape(-1, 3),
        ]
    ).astype(np.int32)
    return Mesh(positions=pos, indices=idx, name="sphere")
