"""The draws of every run: a frozen copy of the port's
``core/sampling.py::PathUniforms`` (its SplitMix64 ``path_seed`` and a
device generator reseeded per draw). The timed path and the reference
take the same object, so what is compared is what was timed."""

from __future__ import annotations

import contextlib

import torch

_M64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finalizer."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def path_seed(seed: int, path) -> int:
    """A 64-bit generator seed hashed from (seed, *path) and the path's
    length."""
    h = _mix64(int(seed) & _M64)
    for p in path:
        h = _mix64(h ^ (int(p) & _M64))
    return _mix64(h ^ len(path))


class PathUniforms:
    """Deterministic per path, drawn on ``device``: each draw reseeds one
    ``torch.Generator`` with ``path_seed(seed, path)``, so a draw depends
    on (seed, path, shape) only. ``quiet``: a context manager entered
    around each draw (the low-precision control pauses its rounding
    there: the draws are inputs, not computation)."""

    def __init__(self, seed: int, device, quiet=contextlib.nullcontext):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.quiet = quiet

    def _seeded(self, path):
        self.generator.manual_seed(path_seed(self.seed, path))
        return self.generator

    def uniform(self, path, shape):
        with self.quiet():
            return torch.rand(tuple(shape), generator=self._seeded(path),
                              device=self.device, dtype=torch.float32)

    def randint(self, path, shape, low, high):
        with self.quiet():
            return torch.randint(int(low), int(high), tuple(shape),
                                 generator=self._seeded(path), device=self.device)


class Prefixed:
    """A source whose paths are ``prefix + path`` in ``base``."""

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
