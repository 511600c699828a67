"""AOV passes: per-pixel normal, depth and albedo, the guide inputs of the
guided NLM denoiser, and their PFM files (port of
``tinsel_tpu/render/aov.py``). One closest-hit trace at pixel centers."""

from __future__ import annotations

import numpy as np
import torch

from ..io.hdr import save_pfm
from ..scene.model import SceneFlat
from ..utils.profiling import traced
from .camera import CameraParams, generate_rays
from .trace import trace_closest


@traced("app.aovs")
@torch.no_grad()
def render_aovs(scene: SceneFlat, cam: CameraParams, width: int, height: int):
    """Returns dict(normal=(H,W,3) in [-1,1], depth=(H,W,1) hit distance
    (0 on miss), albedo=(H,W,3) base color (0 on miss))."""
    dev = cam.position.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    raster = torch.stack(
        [xs.expand(height, width), ys.expand(height, width)], dim=-1
    ).reshape(-1, 2)
    origins, dirs = generate_rays(cam, width, height, raster)
    times = cam.shutter_start.expand(height * width)
    hit = trace_closest(scene, origins, dirs, times)
    found = (hit.prim >= 0)[..., None]

    normal = torch.where(found, hit.normal, 0.0)
    depth = torch.where(found, hit.t[..., None], 0.0)
    albedo = torch.where(
        found, scene.materials.select(torch.clamp(hit.prim, min=0)).color, 0.0
    )
    shp = (height, width)
    return dict(
        normal=normal.reshape(*shp, 3),
        depth=depth.reshape(*shp, 1),
        albedo=albedo.reshape(*shp, 3),
    )


def write_aovs(prefix: str, aovs: dict) -> list:
    """Write each AOV tensor of ``aovs`` (``render_aovs``' dict) as
    ``{prefix}_{name}.pfm``, a one-channel AOV as RGB; returns the paths.
    The tensors come to the host in one copy."""
    names = list(aovs)
    host = torch.cat([aovs[k].detach().float() for k in names], dim=-1).cpu().numpy()
    widths = np.cumsum([aovs[k].shape[-1] for k in names])[:-1]
    paths = []
    for name, a in zip(names, np.split(host, widths, axis=-1)):
        if a.shape[-1] == 1:
            a = np.repeat(a, 3, axis=-1)  # grayscale PFM as RGB
        path = f"{prefix}_{name}.pfm"
        save_pfm(path, a)
        paths.append(path)
    return paths
