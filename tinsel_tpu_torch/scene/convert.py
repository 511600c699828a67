"""Carry scene state across from the JAX package's arrays.

``scene_flat_from_numpy`` builds the port's ``SceneFlat`` from the arrays of
a ``tinsel_tpu`` ``SceneFlat`` given as numpy, so that both packages render
the identical scene; ``camera_from_numpy`` does the same for the camera.
Nothing here imports JAX: the caller turns its arrays into numpy.

``arrays`` keys are the JAX attribute paths:

* ``prims.<field>`` for every ``PrimsFlat`` field,
* ``materials.<field>`` for every ``MaterialsFlat`` field,
* ``pool.node_rows`` (Ni, 72), ``pool.block_rows`` (B, 192),
  ``pool.tri_cdf`` (Tp,), ``pool.tri_planes`` and ``pool.nrm_planes``
  (9, Tp), the JAX tuples of nine planes stacked,
* ``sky_horizon``, ``sky_zenith``, ``prim_type``, ``prim_light_samples``,
  ``prim_local_area``, ``prim_bump``;
* optional: ``light_pmf`` (P,) and, for a scene with an HDR probe,
  ``probe.data`` (H, W, 3), ``probe.pdf_x``, ``probe.cdf_x`` (H, W),
  ``probe.pdf_y``, ``probe.cdf_y`` (H,).

``static`` holds ``prim_static``, a list of dicts with the ``PrimStatic``
fields (``mesh`` a dict with the ``MeshHandle`` fields, or None),
``light_indices`` and ``has_bump``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..accel.traverse import MeshHandle, MeshPool
from ..device import resolve_device
from ..render.camera import CameraParams
from .model import MaterialsFlat, PrimStatic, PrimsFlat, ProbeFlat, SceneFlat


def _tensor(a, device, dtype=None):
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)


def scene_flat_from_numpy(arrays: dict, static: dict, device=None) -> SceneFlat:
    device = resolve_device(device)

    def group(cls, prefix):
        return cls(**{
            f.name: _tensor(arrays[f"{prefix}.{f.name}"], device)
            for f in dataclasses.fields(cls)
        })

    handle_fields = {f.name for f in dataclasses.fields(MeshHandle)}
    prim_static = []
    for ps in static["prim_static"]:
        mesh = ps.get("mesh")
        if mesh is not None:
            mesh = MeshHandle(**{k: mesh[k] for k in handle_fields})
        prim_static.append(
            PrimStatic(
                type=int(ps["type"]),
                mesh=mesh,
                material_index=int(ps["material_index"]),
                light_samples=int(ps["light_samples"]),
                motion=bool(ps["motion"]),
            )
        )

    probe = None
    if "probe.data" in arrays:
        probe = group(ProbeFlat, "probe")
    light_pmf = arrays.get("light_pmf")
    return SceneFlat(
        prims=group(PrimsFlat, "prims"),
        materials=group(MaterialsFlat, "materials"),
        pool=MeshPool(
            node_rows=_tensor(arrays["pool.node_rows"], device, torch.float32),
            block_rows=_tensor(arrays["pool.block_rows"], device, torch.float32),
            tri_cdf=_tensor(arrays["pool.tri_cdf"], device),
            tri_planes=tuple(
                _tensor(p, device) for p in np.asarray(arrays["pool.tri_planes"])
            ),
            nrm_planes=tuple(
                _tensor(p, device) for p in np.asarray(arrays["pool.nrm_planes"])
            ),
        ),
        sky_horizon=_tensor(arrays["sky_horizon"], device),
        sky_zenith=_tensor(arrays["sky_zenith"], device),
        prim_type=_tensor(arrays["prim_type"], device, torch.int32),
        prim_light_samples=_tensor(arrays["prim_light_samples"], device, torch.int32),
        prim_local_area=_tensor(arrays["prim_local_area"], device),
        prim_bump=_tensor(arrays["prim_bump"], device, torch.float32),
        light_pmf=None if light_pmf is None else _tensor(light_pmf, device, torch.float32),
        probe=probe,
        prim_static=tuple(prim_static),
        light_indices=tuple(int(i) for i in static["light_indices"]),
        has_bump=bool(static["has_bump"]),
    )


def camera_from_numpy(arrays: dict, device=None) -> CameraParams:
    """``arrays``: one entry per ``CameraParams`` field (position, rotation,
    fov, shutter_start, shutter_end, aperture, focal_distance)."""
    device = resolve_device(device)
    return CameraParams(**{
        f.name: _tensor(arrays[f.name], device, torch.float32)
        for f in dataclasses.fields(CameraParams)
    })
