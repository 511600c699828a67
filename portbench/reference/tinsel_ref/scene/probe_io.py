"""HDR probes for scenes (port of ``tinsel_tpu/scene/probe_io.py``):
``load_probe`` reads a Radiance ``.hdr``/``.pic`` lat-long map
(``io/hdr.py``) and builds its luminance CDF."""

from __future__ import annotations

import time

import numpy as np

from ..io.hdr import load_hdr
from .model import HostProbe


def load_probe(path: str) -> HostProbe:
    t0 = time.perf_counter()
    if path.lower().endswith((".hdr", ".pic")):
        data = load_hdr(path)
    else:
        raise ValueError(f"unsupported probe format: {path}")
    probe = HostProbe(data=np.asarray(data, np.float32))
    probe.build_cdf()
    print(
        f"Imported probe {path} ({probe.width}x{probe.height}) "
        f"in {(time.perf_counter() - t0) * 1000:.1f}ms"
    )
    return probe
