"""Monte-Carlo sampling primitives and the port's source of uniforms.

The geometric samplers are ports of ``tinsel_tpu/core/sampling.py``; each
takes its uniforms as tensors.

Randomness. The JAX package derives every draw from a key by a chain of
``fold_in`` calls. The port names each draw by that chain instead: a
``UniformSource`` answers ``uniform(path, shape)``, where ``path`` is the
tuple of ints the JAX package folds into the pass key before it calls
``jax.random.uniform(key, shape)`` (and ``randint(path, shape, low,
high)`` for ``jax.random.randint``). The JAX bits depend on the shape as
well as the path, so each draw keeps the JAX shape. The draws of one pass
(bounce i; d counts the probe as draw 0 when the scene has one, then the
lights) are:

==============================================  ============================
draw                                             path
==============================================  ============================
raster jitter, ``(S, H, W, 2)``                  ``(0,)``
  blue noise: pixel shift, ``(1, H, W, 2)``      ``(0,)``
shutter time, ``(S, H, W)``                      ``(1,)``
  blue noise: time shift, ``(1, H, W)``          ``(1,)``
blue-noise points: first ``(2,)``, then point    ``(3, 0)``, ``(3, j)``
  j's candidates ``(32, 2)``
lens, ``(S, H, W, 2)``                           ``(5,)``
probe NEE uniform k, ``(R,)``                    ``(2, i, 1, 0, k)``, k<2
NEE uniform k of light draw d, sample s          ``(2, i, 1, d, s, k)``, k<3
power mode: light pick, ``(R,)``                 ``(2, i, 1, d, 999)``
power mode: light jj's uniform k, ``(R,)``       ``(2, i, 1, d, jj, k)``, k<3
BSDF uniform k, ``(R,)``                         ``(2, i, 2, k)``, k<6
Russian roulette, ``(R,)``                       ``(2, i, 3)``
==============================================  ============================

Adaptive sampling (``render/adaptive.py``) folds the round index r in
first, then draws jitter ``(r, 0)`` of shape ``(spp, N, 2)``, times
``(r, 1)`` of ``(spp * N,)``, lens ``(r, 4)`` of ``(spp * N, 2)``, paths
under ``(r, 2, ...)`` and, in a uniform round, its first tile as
``randint`` under ``(r, 9)``.

Read from ``tinsel_tpu/render/renderer.py:55-92, :128-129, :150-152``,
``render/integrator.py:116, :220, :233, :251``, ``render/lights.py:68-70,
:120-126, :149-169, :232``, ``render/adaptive.py:89-103, :126``,
``core/sampling.py:79-105`` and ``bsdf/disney.py:180-181``;
``make_accumulate_fn`` folds the pass index in first. A source built on
``jax.random`` therefore reproduces the JAX package's draws exactly (the
tests do this). ``PathUniforms``, the default of every entry point, draws
on the device as a function of (seed, path) alone, as the JAX package's
draws are a function of (key, path), so a pass draws the same samples
whichever passes ran before it (the CLI's resume and the viewer's restart
rest on this, and ``render(seed=s)`` equals the CLI's ``-seed s``).
``Lanes`` gives a shard of a path batch its lanes of the whole batch's
draws.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch

from .math import TWO_PI


class UniformSource(Protocol):
    def uniform(self, path: tuple, shape: Sequence[int]) -> torch.Tensor:
        """f32 uniforms in [0, 1) of ``shape`` for the draw named ``path``."""

    def randint(self, path: tuple, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        """Integers in [low, high) of ``shape`` for the draw named ``path``."""


_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finalizer: a bijection of 64-bit ints that spreads
    every input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def path_seed(seed: int, path) -> int:
    """A 64-bit generator seed that is a hash of (seed, *path): each entry
    mixed in turn, then the path's length, so (1,) and (1, 0) differ."""
    h = _mix64(int(seed) & _M64)
    for p in path:
        h = _mix64(h ^ (int(p) & _M64))
    return _mix64(h ^ len(path))


class PathUniforms:
    """Deterministic per path, drawn on ``device``: each draw reseeds a
    ``torch.Generator`` on the device with ``path_seed(seed, path)``. A
    draw depends on (seed, path, shape) only, never on the draws made
    before it."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def _seeded(self, path):
        self.generator.manual_seed(path_seed(self.seed, path))
        return self.generator

    def uniform(self, path, shape):
        return torch.rand(tuple(shape), generator=self._seeded(path),
                          device=self.device, dtype=torch.float32)

    def randint(self, path, shape, low, high):
        return torch.randint(int(low), int(high), tuple(shape),
                             generator=self._seeded(path), device=self.device)


class NumpyUniforms:
    """Deterministic per path: seeds numpy's PCG64 with ``(seed, *path)``.
    Gives the same numbers on every device, which lets a run on the card be
    compared with a run on the CPU at equal draws."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def uniform(self, path, shape):
        rng = np.random.default_rng([self.seed, *[int(p) for p in path]])
        a = rng.random(tuple(shape), dtype=np.float32)
        return torch.from_numpy(a).to(self.device)

    def randint(self, path, shape, low, high):
        rng = np.random.default_rng([self.seed, *[int(p) for p in path]])
        return torch.from_numpy(np.asarray(rng.integers(low, high, tuple(shape)))).to(self.device)


class Prefixed:
    """A source whose paths are ``prefix + path`` in ``base``: the port's
    form of ``jax.random.fold_in``."""

    def __init__(self, base, *prefix: int):
        if isinstance(base, Prefixed):
            prefix = base.prefix + prefix
            base = base.base
        self.base = base
        self.prefix = tuple(int(p) for p in prefix)

    def uniform(self, path, shape):
        return self.base.uniform(self.prefix + tuple(path), shape)

    def randint(self, path, shape, low, high):
        return self.base.randint(self.prefix + tuple(path), shape, low, high)


class Lanes:
    """The draws of some lanes of a batch of ``n``: a draw of shape
    ``(len(index), ...)`` reads ``base`` at the whole batch's
    ``(n, ...)`` and keeps the rows ``index``. A shard of a path batch
    (``parallel/sharding.py``) so draws exactly the numbers the whole batch
    gives its lanes: the JAX package's bits, like ``PathUniforms``'
    generator, depend on the shape of the draw."""

    def __init__(self, base, index: torch.Tensor, n: int):
        self.base = base
        self.index = index
        self.n = int(n)

    def _full(self, shape):
        shape = tuple(shape)
        if not shape or shape[0] != self.index.numel():
            raise ValueError(f"a draw of {shape} is not one of {self.index.numel()} lanes")
        return (self.n, *shape[1:])

    def uniform(self, path, shape):
        return self.base.uniform(path, self._full(shape)).index_select(0, self.index)

    def randint(self, path, shape, low, high):
        return self.base.randint(path, self._full(shape), low, high).index_select(0, self.index)


def uniform_sample_sphere(u1, u2):
    """Uniform direction on the unit sphere from two uniforms."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_hemisphere(u1, u2):
    """Uniform direction on the +z hemisphere (local frame)."""
    z = u1
    w = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u2
    return torch.stack([torch.cos(phi) * w, torch.sin(phi) * w, z], dim=-1)


def uniform_sample_disc(u1, u2):
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def cosine_sample_hemisphere(u1, u2):
    """Cosine-weighted direction on the +z hemisphere (pdf = cos/pi)."""
    s = uniform_sample_disc(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - s[..., 0] ** 2 - s[..., 1] ** 2, min=0.0))
    return torch.stack([s[..., 0], s[..., 1], z], dim=-1)


def uniform_sample_triangle(u1, u2):
    """Uniform barycentric (u, v) on a triangle."""
    r = torch.sqrt(u1)
    return 1.0 - r, u2 * r


def stratified_offsets_2d(n_x: int, n_y: int, source):
    """Jittered-stratified sample positions in [0,1)^2, shape (n_x*n_y, 2);
    the jitter is ``source`` at path ()."""
    jit = source.uniform((), (n_x * n_y, 2))
    i = torch.arange(n_x * n_y, device=jit.device)
    grid = torch.stack([i % n_x, i // n_x], dim=-1).to(torch.float32)
    scale = torch.tensor([1.0 / n_x, 1.0 / n_y], dtype=torch.float32, device=jit.device)
    return (grid + jit) * scale


def stratified_offsets_1d(n: int, source):
    """Jittered-stratified samples in [0,1), shape (n,); the jitter is
    ``source`` at path ()."""
    jit = source.uniform((), (n,))
    return (torch.arange(n, dtype=torch.float32, device=jit.device) + jit) / n


def _toroidal_dist2(p, q):
    """Squared toroidal distance between point sets p (..., D) and q (..., D)."""
    d = torch.abs(p - q)
    d = torch.minimum(d, 1.0 - d)
    return torch.sum(d * d, dim=-1)


def _best_candidate(n: int, source, k: int, axis_weight2: float | None):
    first = source.uniform((0,), (2,))
    pts = torch.zeros((n, 2), dtype=torch.float32, device=first.device)
    pts[0] = first
    slots = torch.arange(n, device=first.device)
    for i in range(1, n):
        cand = source.uniform((i,), (k, 2))
        d2 = _toroidal_dist2(cand[:, None, :], pts[None, :, :])  # (k, n)
        if axis_weight2 is not None:
            dx = _toroidal_dist2(cand[:, None, :1], pts[None, :, :1]) * axis_weight2
            dy = _toroidal_dist2(cand[:, None, 1:], pts[None, :, 1:]) * axis_weight2
            d2 = torch.minimum(d2, torch.minimum(dx, dy))
        d2 = torch.where((slots < i)[None, :], d2, torch.inf)
        # argmax takes the first of equal scores, as jnp.argmax
        pts[i] = cand[torch.argmax(d2.min(dim=1).values)]
    return pts


def best_candidate_2d(n: int, source, candidates_per_point: int = 32):
    """Best-candidate (Mitchell) blue-noise point set in [0, 1)^2, (n, 2):
    point 0 reads ``source`` at (0,), point i >= 1 keeps, of the k
    candidates drawn at (i,), the one farthest (toroidally) from the points
    before it."""
    return _best_candidate(n, source, candidates_per_point, None)


def best_candidate_projective_2d(n: int, source, candidates_per_point: int = 32,
                                 axis_weight: float | None = None):
    """Projective blue noise: candidates are scored by the min of the 2D
    toroidal distance and each axis projection's distance scaled by
    ``axis_weight`` (default sqrt(n)), so the set is well spread in 2D and
    in both 1D projections. Draws as ``best_candidate_2d``."""
    w1 = axis_weight if axis_weight is not None else float(n) ** 0.5
    return _best_candidate(n, source, candidates_per_point, w1 * w1)


def toroidal_shift(points, source):
    """Cranley-Patterson rotation: shift a point set by one uniform offset
    (``source`` at path ()) mod 1."""
    off = source.uniform((), (points.shape[-1],))
    return torch.remainder(points + off, 1.0)
