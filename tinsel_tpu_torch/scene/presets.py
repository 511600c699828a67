"""Procedural scenes (port of ``tinsel_tpu/scene/presets.py``): the
Cornell box, the big-mesh scenes (``envmesh_scene``, ``instances_scene``,
``many_mesh_scene``) and the small dry-run scene."""

from __future__ import annotations

import numpy as np
import torch

from ..core.color import hsv_to_rgb
from ..utils.perlin import fractal3d
from .model import (
    Camera,
    HostTransform,
    Material,
    Mesh,
    MESH,
    Options,
    PLANE,
    Primitive,
    Scene,
    Sky,
    SPHERE,
)
from .procedural import capsule, sphere, tetrahedron


def quad_mesh(half: float = 0.25) -> Mesh:
    return Mesh(
        positions=np.array(
            [[-half, 0, half], [half, 0, half], [half, 0, -half], [-half, 0, -half]],
            np.float32,
        ),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
    )


def sphere_mesh(radius: float = 1.0, n_theta: int = 16, n_phi: int = 32) -> Mesh:
    """UV-sphere triangle mesh (the per-vertex loop of the JAX preset)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts = [
        [radius * np.sin(t) * np.cos(p), radius * np.cos(t), radius * np.sin(t) * np.sin(p)]
        for t in th for p in ph
    ]
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            idx.append([a, c, b])
            idx.append([b, c, d])
    return Mesh(positions=np.asarray(verts, np.float32), indices=np.asarray(idx, np.int32))


def cornell_scene(width: int = 256, height: int = 256, max_depth: int = 4) -> Scene:
    """The classic Cornell box: five planes, a quad area light, a glossy
    and a metal sphere."""
    scene = Scene()
    scene.camera = Camera(
        position=np.array([0.0, 1.0, 4.0], np.float32),
        fov=float(np.deg2rad(35.0)),
    )
    scene.options = Options(
        width=width, height=height, max_depth=max_depth,
        filter_type="gaussian", filter_width=1.0, filter_falloff=1.0,
        exposure=1.0,
    )

    def wall(eq, color):
        return Primitive(
            type=PLANE,
            plane=np.array(eq, np.float32),
            material=Material(
                color=np.array(color, np.float32), roughness=1.0, specular=0.2
            ),
        )

    scene.add_primitive(wall([0, 1, 0, 0], [0.725, 0.71, 0.68]))
    scene.add_primitive(wall([1, 0, 0, 1], [0.63, 0.065, 0.05]))
    scene.add_primitive(wall([-1, 0, 0, 1], [0.14, 0.45, 0.091]))
    scene.add_primitive(wall([0, -1, 0, 2], [0.725, 0.71, 0.68]))
    scene.add_primitive(wall([0, 0, 1, 1], [0.725, 0.71, 0.68]))

    scene.add_primitive(
        Primitive(
            type=MESH,
            mesh=quad_mesh(0.25),
            start_transform=HostTransform(p=np.array([0, 1.9999, 0], np.float32)),
            material=Material(
                color=np.zeros(3, np.float32),
                emission=np.array([18.4, 15.6, 8.0], np.float32),
                specular=0.0,
                metallic=0.0,
            ),
            light_samples=1,
        )
    )
    scene.add_primitive(
        Primitive(
            type=SPHERE,
            radius=0.5,
            start_transform=HostTransform(p=np.array([0.35, 0.5, 0], np.float32)),
            material=Material(
                color=np.full(3, 0.7, np.float32), roughness=0.1, specular=0.8
            ),
        )
    )
    scene.add_primitive(
        Primitive(
            type=SPHERE,
            radius=0.5,
            start_transform=HostTransform(
                p=np.array([-0.5, 0.25, 0], np.float32), s=0.5
            ),
            material=Material(
                color=np.full(3, 0.7, np.float32),
                roughness=0.1,
                specular=0.8,
                metallic=1.0,
            ),
        )
    )
    return scene


def envmesh_scene(width: int = 256, height: int = 256, max_depth: int = 4,
                  detail: int = 256, probe: bool = False) -> Scene:
    """A Perlin-displaced sphere of 2 * detail^2 triangles over a ground
    plane under the gradient sky: the heavy-traversal scene, analog of the
    reference's environment-lit ~500k-triangle bust."""
    if probe:
        raise NotImplementedError("envmesh_scene(probe=True): HDR probes are ported in slice 4")
    scene = Scene()
    scene.camera = Camera(
        position=np.array([0.0, 1.0, 3.2], np.float32),
        fov=float(np.deg2rad(40.0)),
    )
    scene.options = Options(
        width=width, height=height, max_depth=max_depth,
        filter_type="gaussian", filter_width=1.0, filter_falloff=1.0,
    )
    scene.sky = Sky(
        horizon=np.array([0.9, 0.85, 0.75], np.float32),
        zenith=np.array([0.25, 0.4, 0.75], np.float32),
    )
    mesh = sphere(radius=0.8, n_theta=detail, n_phi=detail)
    # radial Perlin displacement: an irregular BVH, like a scanned bust
    p = mesh.positions
    disp = np.asarray(
        fractal3d(p[:, 0] * 3.0, p[:, 1] * 3.0, p[:, 2] * 3.0, octaves=4)
    ).astype(np.float32)
    r = np.linalg.norm(p, axis=-1, keepdims=True)
    mesh.positions = (p / np.maximum(r, 1e-9)) * (
        0.8 + 0.18 * disp[:, None]
    ).astype(np.float32)
    mesh.build()
    scene.add_primitive(Primitive(
        type=MESH, mesh=mesh,
        start_transform=HostTransform(p=np.array([0.0, 1.0, 0.0], np.float32)),
        material=Material(
            color=np.array([0.65, 0.6, 0.55], np.float32), roughness=0.35, specular=0.6,
        ),
    ))
    scene.add_primitive(Primitive(
        type=PLANE, plane=np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        material=Material(color=np.array([0.5, 0.5, 0.5], np.float32), roughness=0.8),
    ))
    return scene


def instances_scene(width: int = 256, height: int = 256, max_depth: int = 3,
                    grid: int = 4) -> Scene:
    """A grid x grid field of primitives sharing one capsule mesh (one
    pool segment), each with its own transform and palette material."""
    scene = Scene()
    scene.camera = Camera(
        position=np.array([0.0, 2.5, 6.0], np.float32),
        fov=float(np.deg2rad(42.0)),
    )
    scene.options = Options(width=width, height=height, max_depth=max_depth)
    scene.sky = Sky(
        horizon=np.array([0.8, 0.8, 0.85], np.float32),
        zenith=np.array([0.3, 0.4, 0.65], np.float32),
    )
    shared = capsule(radius=0.3, half_height=0.25, slices=12, segments=24)
    shared.build()
    f32 = dict(dtype=torch.float32)
    for iy in range(grid):
        for ix in range(grid):
            t = (iy * grid + ix) / max(grid * grid - 1, 1)
            rgb = hsv_to_rgb(
                torch.tensor(t * 0.8, **f32), torch.tensor(0.6, **f32), torch.tensor(0.8, **f32)
            ).numpy().astype(np.float32)
            scene.add_primitive(Primitive(
                type=MESH, mesh=shared,  # the same object: instanced
                start_transform=HostTransform(p=np.array(
                    [(ix - (grid - 1) / 2) * 1.2, 0.55, (iy - (grid - 1) / 2) * 1.2],
                    np.float32,
                )),
                material=Material(color=rgb, roughness=0.3 + 0.5 * t, specular=0.6),
            ))
    scene.add_primitive(Primitive(
        type=PLANE, plane=np.array([0.0, 1.0, 0.0, 0.0], np.float32),
        material=Material(color=np.array([0.55, 0.55, 0.55], np.float32), roughness=0.8),
    ))
    return scene


def dryrun_scene(width: int = 16, height: int = 16) -> Scene:
    """Tiny scene with every primitive type and a light."""
    return cornell_scene(width=width, height=height, max_depth=2)


def many_mesh_scene(n_meshes: int = 48, width: int = 128, height: int = 128,
                    max_depth: int = 2, seed: int = 0) -> Scene:
    """``n_meshes`` distinct meshes (spheres, capsules, tetrahedra; no
    instancing, each its own sub-BVH segment), each with its own material,
    on a floor under a quad light."""
    rng = np.random.default_rng(seed)
    scene = Scene()
    scene.options = Options(width=width, height=height, max_depth=max_depth)
    scene.camera = Camera(
        position=np.array([0.0, 3.0, 9.0], np.float32),
        rotation=np.array([-0.12, 0, 0, 0.993], np.float32),
        fov=float(np.deg2rad(40)),
    )
    scene.sky = Sky(
        horizon=np.array([0.1, 0.12, 0.15], np.float32),
        zenith=np.array([0.03, 0.04, 0.08], np.float32),
    )
    scene.add_primitive(Primitive(type=PLANE, plane=np.array([0, 1, 0, 0], np.float32)))
    scene.add_primitive(Primitive(
        type=MESH, mesh=quad_mesh(1.5),
        material=Material(
            emission=np.array([12.0, 11.0, 9.0], np.float32), color=np.zeros(3, np.float32),
        ),
        start_transform=HostTransform(p=np.array([0, 6.0, 0], np.float32)),
        light_samples=1,
    ))
    side = int(np.ceil(np.sqrt(n_meshes)))
    for k in range(n_meshes):
        kind = k % 3
        if kind == 0:
            m = sphere(1.0, 8 + (k % 5) * 2, 16 + (k % 7) * 2)
        elif kind == 1:
            m = capsule(0.5, 0.5, 8 + (k % 4) * 2, 12 + (k % 5) * 2)
        else:
            m = tetrahedron(0.0, 1.0 + 0.1 * (k % 4))
        gx = (k % side) - (side - 1) / 2.0
        gz = (k // side) - (side - 1) / 2.0
        scene.add_primitive(Primitive(
            type=MESH, mesh=m,
            material=Material(
                color=rng.uniform(0.2, 0.9, 3).astype(np.float32),
                roughness=float(rng.uniform(0.1, 0.9)),
                metallic=float(k % 2),
            ),
            start_transform=HostTransform(
                p=np.array([1.6 * gx, 0.55, 1.6 * gz], np.float32), s=0.5,
            ),
        ))
    return scene
