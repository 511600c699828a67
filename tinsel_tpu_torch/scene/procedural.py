"""Procedural mesh builders (host-side NumPy): the port's own copy of
``tinsel_tpu/scene/procedural.py`` (quad, disc, tetrahedron, UV sphere,
capsule). Each returns an un-built ``Mesh``; ``mesh.build()`` computes
normals, the area CDF and the BVH.
"""

from __future__ import annotations

import numpy as np

from .model import Mesh


def quad(size: float = 0.5, y: float = 0.0) -> Mesh:
    """XZ-plane quad centered at origin, +y normal, half-extent `size`."""
    s = size
    pos = np.array(
        [[-s, y, s], [s, y, s], [s, y, -s], [-s, y, -s]], np.float32
    )
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return Mesh(positions=pos, indices=idx, name="quad")


def disc(radius: float = 1.0, segments: int = 32) -> Mesh:
    """Fan-triangulated disc in the XZ plane, +y normal."""
    a = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    rim = np.stack(
        [radius * np.cos(a), np.zeros_like(a), radius * np.sin(a)], axis=-1
    )
    pos = np.concatenate([[[0.0, 0.0, 0.0]], rim]).astype(np.float32)
    i = np.arange(segments, dtype=np.int32)
    idx = np.stack([np.zeros_like(i), 1 + (i + 1) % segments, 1 + i], axis=-1)
    return Mesh(positions=pos, indices=idx.astype(np.int32), name="disc")


def tetrahedron(ground: float = 0.0, height: float = 1.0) -> Mesh:
    """Regular tetrahedron with base at y=ground, apex at y=ground+height."""
    h = height
    base = ground
    pos = np.array(
        [
            [-h * 0.5, base, -h * 0.5 / np.sqrt(3.0)],
            [h * 0.5, base, -h * 0.5 / np.sqrt(3.0)],
            [0.0, base, h / np.sqrt(3.0)],
            [0.0, base + h, 0.0],
        ],
        np.float32,
    )
    idx = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]], np.int32)
    return Mesh(positions=pos, indices=idx, name="tetrahedron")


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


def capsule(radius: float = 0.5, half_height: float = 0.5,
            slices: int = 16, segments: int = 32) -> Mesh:
    """Capsule along the y axis: two hemispheres joined by a cylinder."""
    # latitude rings: top hemisphere, then bottom hemisphere; the equator rows
    # are offset by +/- half_height, producing the cylindrical side wall.
    th_top = np.linspace(0.0, np.pi / 2, slices + 1)
    th_bot = np.linspace(np.pi / 2, np.pi, slices + 1)
    th = np.concatenate([th_top, th_bot])  # duplicated equator row => wall
    off = np.concatenate(
        [np.full(slices + 1, half_height), np.full(slices + 1, -half_height)]
    )
    ph = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    O = np.repeat(off[:, None], segments, axis=1)
    pos = np.stack(
        [
            radius * np.sin(T) * np.cos(P),
            radius * np.cos(T) + O,
            radius * np.sin(T) * np.sin(P),
        ],
        axis=-1,
    ).reshape(-1, 3).astype(np.float32)
    n_rows = th.shape[0]
    i = np.arange(n_rows - 1)[:, None]
    j = np.arange(segments)[None, :]
    a = i * segments + j
    b = i * segments + (j + 1) % segments
    c = (i + 1) * segments + j
    d = (i + 1) * segments + (j + 1) % segments
    idx = np.concatenate(
        [
            np.stack([a, c, b], axis=-1).reshape(-1, 3),
            np.stack([b, c, d], axis=-1).reshape(-1, 3),
        ]
    ).astype(np.int32)
    return Mesh(positions=pos, indices=idx, name="capsule")
