"""HDR probes for scenes (port of ``tinsel_tpu/scene/probe_io.py``): the
procedural test probe. Loading a probe from a file needs the HDR readers
(``io/hdr.py``), which are ported with the loaders in slice 5."""

from __future__ import annotations

import numpy as np

from .model import HostProbe


def load_probe(path: str) -> HostProbe:
    raise NotImplementedError(
        f"load_probe({path!r}): the HDR/PFM readers (io/hdr.py) are ported in slice 5"
    )


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
