"""Monte-Carlo sampling primitives and the port's source of uniforms.

The geometric samplers are ports of ``tinsel_tpu/core/sampling.py``; each
takes its uniforms as tensors.

Randomness. The JAX package derives every draw from a key by a chain of
``fold_in`` calls. The port names each draw by that chain instead: a
``UniformSource`` answers ``uniform(path, shape)``, where ``path`` is the
tuple of ints the JAX package folds into the pass key before it calls
``jax.random.uniform(key, shape)``. The draws of one pass are:

=========================================  ============================
draw                                        path
=========================================  ============================
raster jitter, ``(S, H, W, 2)``             ``(0,)``
shutter time, ``(S, H, W)``                 ``(1,)``
lens, ``(S, H, W, 2)``                      ``(5,)``
NEE uniform k of light draw d, sample s     ``(2, i, 1, d, s, k)``, k<3
BSDF uniform k at bounce i                  ``(2, i, 2, k)``, k<6
=========================================  ============================

read from ``tinsel_tpu/render/renderer.py:55-56, :128-129, :150-152``,
``render/integrator.py:116, :220, :233``, ``render/lights.py:68-70, :232``
and ``bsdf/disney.py:180-181``; ``make_accumulate_fn`` folds the pass index
in first. A source built on ``jax.random`` therefore reproduces the JAX
package's draws exactly (the tests do this); the default source below
draws from a ``torch.Generator`` and ignores the path.
"""

from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch

from .math import TWO_PI


class UniformSource(Protocol):
    def uniform(self, path: tuple, shape: Sequence[int]) -> torch.Tensor:
        """f32 uniforms in [0, 1) of ``shape`` for the draw named ``path``."""


class GeneratorUniforms:
    """Draws from one ``torch.Generator`` on ``device``; ignores the path,
    so the stream depends on the order of the draws only."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, path, shape):
        return torch.rand(
            tuple(shape), generator=self.generator, device=self.device,
            dtype=torch.float32,
        )


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
