"""HDR probes for scenes (port of ``tinsel_tpu/scene/probe_io.py``):
``load_probe`` reads a Radiance ``.hdr``/``.pic`` or a ``.pfm`` lat-long map
(``io/hdr.py``) and builds its luminance CDF; ``create_test_probe`` is the
procedural disc-light probe."""

from __future__ import annotations

import time

import numpy as np

from ..io.hdr import load_hdr, load_pfm
from .model import HostProbe


def load_probe(path: str) -> HostProbe:
    t0 = time.perf_counter()
    if path.lower().endswith((".hdr", ".pic")):
        data = load_hdr(path)
    elif path.lower().endswith(".pfm"):
        data = load_pfm(path)
    else:
        raise ValueError(f"unsupported probe format: {path}")
    probe = HostProbe(data=np.asarray(data, np.float32))
    probe.build_cdf()
    print(
        f"Imported probe {path} ({probe.width}x{probe.height}) "
        f"in {(time.perf_counter() - t0) * 1000:.1f}ms"
    )
    return probe


def create_test_probe(width: int = 100, height: int = 50) -> HostProbe:
    """Procedural disc-light probe: a bright circular disc around +Y on a
    black background."""
    v, u = np.meshgrid(
        (np.arange(height) + 0.0) / height,
        (np.arange(width) + 0.0) / width,
        indexing="ij",
    )
    theta = v * np.pi
    phi = u * 2.0 * np.pi
    dirs = np.stack(
        [-np.sin(theta) * np.cos(phi), np.cos(theta), -np.sin(theta) * np.sin(phi)],
        axis=-1,
    )
    mask = (dirs @ np.array([0.0, 1.0, 0.0])) >= 0.95
    data = np.repeat(np.where(mask[..., None], 10.0, 0.0).astype(np.float32), 3, axis=-1)
    probe = HostProbe(data=data)
    probe.build_cdf()
    return probe
