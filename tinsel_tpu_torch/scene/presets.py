"""Procedural scenes (port of ``tinsel_tpu/scene/presets.py``:
``cornell_scene`` and ``quad_mesh``)."""

from __future__ import annotations

import numpy as np

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
    SPHERE,
)


def quad_mesh(half: float = 0.25) -> Mesh:
    return Mesh(
        positions=np.array(
            [[-half, 0, half], [half, 0, half], [half, 0, -half], [-half, 0, -half]],
            np.float32,
        ),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32),
    )


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
