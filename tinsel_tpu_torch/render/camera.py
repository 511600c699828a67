"""Camera: raster -> world rays, pinhole and thin lens (port of
``tinsel_tpu/render/camera.py``). Aperture 0 gives the pinhole rays."""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.math import normalize, quat_rotate
from ..device import resolve_device
from ..utils.profiling import count_sync


@dataclasses.dataclass(frozen=True)
class CameraParams:
    position: torch.Tensor  # (3,)
    rotation: torch.Tensor  # (4,) quat
    fov: torch.Tensor  # () radians
    shutter_start: torch.Tensor  # ()
    shutter_end: torch.Tensor  # ()
    aperture: torch.Tensor  # () lens radius; 0 = pinhole
    focal_distance: torch.Tensor  # () distance to the focus plane

    @staticmethod
    def from_host(cam, device=None) -> "CameraParams":
        device = resolve_device(device)

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return CameraParams(
            position=t(cam.position),
            rotation=t(cam.rotation),
            fov=t(cam.fov),
            shutter_start=t(cam.shutter_start),
            shutter_end=t(cam.shutter_end),
            aperture=t(getattr(cam, "aperture", 0.0)),
            focal_distance=t(getattr(cam, "focal_distance", 1.0)),
        )


def raster_to_world_matrix(cam: CameraParams, width: int, height: int):
    """rasterToWorld = cameraToWorld @ screenToCamera @ rasterToScreen."""
    dev = cam.position.device
    e = torch.eye(3, dtype=torch.float32, device=dev)
    cols = torch.stack([quat_rotate(cam.rotation, e[i]) for i in range(3)], dim=1)
    cam_to_world = torch.zeros((4, 4), dtype=torch.float32, device=dev)
    cam_to_world[:3, :3] = cols
    cam_to_world[:3, 3] = cam.position
    cam_to_world[3, 3] = 1.0
    count_sync()  # the scalar's host-to-device copy waits for the card

    raster_to_screen = torch.tensor(
        [
            [2.0 / width, 0.0, 0.0, -1.0],
            [0.0, -2.0 / height, 0.0, 1.0],
            [0.0, 0.0, 1.0, 1.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=torch.float32,
        device=dev,
    )
    count_sync()  # and so does the table's
    f = torch.tan(cam.fov * 0.5)
    aspect = width / height
    one = torch.ones_like(f)
    screen_to_camera = torch.diag(torch.stack([f * aspect, f, -one, one]))
    return cam_to_world @ screen_to_camera @ raster_to_screen, cam_to_world


def generate_rays(cam: CameraParams, width: int, height: int, raster_xy,
                  lens_uv=None):
    """raster_xy (..., 2) float raster coordinates -> (origin, dir).

    lens_uv (..., 2) in [0,1): thin-lens samples; the origin moves on the
    lens disk (radius cam.aperture) and the direction is re-aimed at the
    pinhole ray's focal-plane point. Aperture 0 keeps the pinhole rays."""
    r2w, c2w = raster_to_world_matrix(cam, width, height)
    xy1 = torch.cat(
        [
            raster_xy,
            torch.zeros_like(raster_xy[..., :1]),
            torch.ones_like(raster_xy[..., :1]),
        ],
        dim=-1,
    )
    p = (xy1 @ r2w.T)[..., :3]
    origin = c2w[:3, 3]
    d = normalize(p - origin)
    origin = torch.broadcast_to(origin, d.shape)

    if lens_uv is not None:
        ap = cam.aperture
        r = torch.sqrt(lens_uv[..., 0]) * ap
        phi = 2.0 * math.pi * lens_uv[..., 1]
        lx = r * torch.cos(phi)
        ly = r * torch.sin(phi)
        offset = lx[..., None] * c2w[:3, 0] + ly[..., None] * c2w[:3, 1]
        focus = origin + d * (
            cam.focal_distance
            / torch.clamp(-(d @ c2w[:3, 2]), min=1e-6)
        )[..., None]
        o_dof = origin + offset
        d_dof = normalize(focus - o_dof)
        use = ap > 0.0
        origin = torch.where(use, o_dof, origin)
        d = torch.where(use, d_dof, d)
    return origin, d
