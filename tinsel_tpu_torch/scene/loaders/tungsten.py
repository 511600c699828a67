"""Tungsten-JSON (Benedikt Bitterli scene corpus) loader: the port's copy
of ``tinsel_tpu/scene/loaders/tungsten.py``.

bsdfs -> Material heuristics by type
(plastic/dielectric/mirror/lambert/rough_*/thinsheet/null), primitives
(quad -> scaled quad mesh, mesh files, infinite_sphere -> constant sky),
camera position/look_at with fov scaled by the aspect ratio, integrator
max_bounces and renderer spp. Euler rotations compose as
Ry(yaw) * Rx(pitch) * Rz(roll) in degrees, computed on CPU f32 tensors.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from ...core import math as tm
from ..model import (
    HostTransform,
    Material,
    Mesh,
    MESH,
    Primitive,
    Scene,
    SPHERE,
)
from .mesh_io import import_mesh
from .tin import _look_at_quat


def _vec3(v, default=(0.0, 0.0, 0.0)):
    if v is None:
        return np.asarray(default, np.float32)
    if isinstance(v, (int, float)):
        return np.full(3, float(v), np.float32)
    return np.asarray(list(v)[:3], np.float32)


def _euler_quat(rotation) -> np.ndarray:
    r = _vec3(rotation)
    qy = tm.quat_from_axis_angle((0.0, 1.0, 0.0), float(np.deg2rad(r[1])))
    qx = tm.quat_from_axis_angle((1.0, 0.0, 0.0), float(np.deg2rad(r[0])))
    qz = tm.quat_from_axis_angle((0.0, 0.0, 1.0), float(np.deg2rad(r[2])))
    return tm.quat_mul(tm.quat_mul(qy, qx), qz).numpy().astype(np.float32)


def _read_material(node: dict) -> tuple[str, Material]:
    m = Material()
    name = node.get("name", "")
    mtype = node.get("type", "")
    albedo = node.get("albedo")
    if isinstance(albedo, (int, float, list)):
        m.color = _vec3(albedo, (0.8, 0.8, 0.8))
    if "ior" in node:
        m.eta = float(node["ior"])
    if "roughness" in node and isinstance(node["roughness"], (int, float)):
        m.roughness = float(node["roughness"])
    if node.get("enable_refraction"):
        m.transmission = 1.0

    if name == "RoughSteel":
        m.color = np.full(3, 0.05, np.float32)
        m.specular = 1.0
    if mtype == "plastic":
        m.metallic = 0.0
        m.roughness = 0.0
        m.specular = 1.0
    elif mtype == "thinsheet":
        m.transmission = 1.0
    elif mtype == "dielectric":
        m.roughness = 0.0
    elif mtype == "null":
        m.color = np.zeros(3, np.float32)
        m.specular = 0.0
    elif mtype == "mirror":
        m.specular = 1.0
        m.metallic = 1.0
        m.roughness = 0.0
    elif mtype in ("rough_dielectric", "rough_plastic"):
        m.metallic = 0.0
    elif mtype == "rough_conductor":
        m.metallic = 1.0
    elif mtype == "lambert":
        m.specular = 0.0
        m.roughness = 1.0
    return name, m


def _quad_mesh_scaled(scale: np.ndarray) -> Mesh:
    half = 0.5
    pos = np.array(
        [
            [-half, 0, half],
            [half, 0, half],
            [half, 0, -half],
            [-half, 0, -half],
        ],
        np.float32,
    ) * scale[None, :]
    return Mesh(
        positions=pos.astype(np.float32),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
    )


def load_tungsten(path: str, scene: Scene | None = None) -> Scene:
    scene = scene or Scene()
    base_dir = os.path.dirname(path)
    with open(path) as f:
        doc = json.load(f)

    materials: dict[str, Material] = {}
    for node in doc.get("bsdfs", []):
        name, m = _read_material(node)
        materials[name] = m

    mesh_cache: dict[str, Mesh] = {}
    for node in doc.get("primitives", []):
        ptype = node.get("type", "")
        tr_node = node.get("transform", {}) or {}
        tr = HostTransform(
            p=_vec3(tr_node.get("position")),
            q=_euler_quat(tr_node.get("rotation")),
            s=1.0,
        )
        scale = _vec3(tr_node.get("scale"), (1.0, 1.0, 1.0))

        bsdf_ref = node.get("bsdf", "")
        if isinstance(bsdf_ref, str) and bsdf_ref in materials:
            mat = copy.deepcopy(materials[bsdf_ref])
        elif isinstance(bsdf_ref, dict):
            _, mat = _read_material(bsdf_ref)
        else:
            mat = Material()

        emission = node.get("emission")
        light_samples = 0
        if emission is not None:
            mat.emission = _vec3(emission)
            if float(np.sum(mat.emission**2)) > 0.0:
                light_samples = 1

        if ptype == "infinite_sphere":
            scene.sky.horizon = _vec3(emission, (0, 0, 0))
            scene.sky.zenith = scene.sky.horizon.copy()
            continue

        if ptype == "sphere":
            # scale (uniform or per-axis; tinsel supports uniform only,
            # like the reference's Primitive scale) sets the radius
            sc_val = tr_node.get("scale", 1.0)
            radius = float(sc_val) if not isinstance(sc_val, (list, tuple)) \
                else float(np.mean(sc_val))
            scene.add_primitive(
                Primitive(
                    type=SPHERE, radius=radius, start_transform=tr,
                    material=mat, light_samples=light_samples,
                )
            )
        elif ptype == "quad":
            mesh = _quad_mesh_scaled(scale)
            mesh.build()
            prim = Primitive(
                type=MESH, mesh=mesh, start_transform=tr, material=mat,
                light_samples=light_samples,
            )
            scene.add_primitive(prim)
        elif ptype == "mesh":
            file = node.get("file", "")
            if file in mesh_cache:
                mesh = mesh_cache[file]
            else:
                try:
                    mesh = import_mesh(os.path.join(base_dir, file))
                except (OSError, ValueError) as e:
                    print(f"Failed to import mesh {file}: {e}")
                    continue
                if node.get("recompute_normals"):
                    mesh.calculate_normals()
                mesh_cache[file] = mesh
            scene.add_primitive(
                Primitive(
                    type=MESH, mesh=mesh, start_transform=tr, material=mat,
                    light_samples=light_samples,
                )
            )

    cam_node = doc.get("camera", {})
    if cam_node:
        res = cam_node.get("resolution", [512, 512])
        if isinstance(res, (int, float)):
            res = [int(res), int(res)]
        scene.options.width, scene.options.height = int(res[0]), int(res[1])
        tr = cam_node.get("transform", {})
        pos = _vec3(tr.get("position"))
        target = _vec3(tr.get("look_at"), (0, 0, 1))
        scene.camera.position = pos
        scene.camera.rotation = _look_at_quat(pos, target)
        fov_deg = float(cam_node.get("fov", 45.0))
        scene.camera.fov = float(
            np.deg2rad(fov_deg) * scene.options.height / scene.options.width
        )

    integ = doc.get("integrator", {})
    if "max_bounces" in integ:
        scene.options.max_depth = int(integ["max_bounces"])
    rend = doc.get("renderer", {})
    if "spp" in rend:
        scene.options.max_samples = int(rend["spp"])

    return scene
