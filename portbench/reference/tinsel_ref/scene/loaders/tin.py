""".tin scene-description loader: the port's copy of
``tinsel_tpu/scene/loaders/tin.py``, the full grammar.

Supported blocks: `include <file>` (recursive),
`options{}` (width/height/maxSamples/maxDepth/clamp/limit/exposure/filter,
plus the rrDepth Russian-roulette extension),
`camera{}` (position / rotation quat / target look-at / fov degrees /
shutterstart / shutterend), `sky{}` (horizon/zenith/probe), named
`material{}` blocks with every Disney parameter plus
transmissionColor+atDistance -> absorption = -log(c)/d,
`primitive{}` blocks (sphere/plane/mesh, motion-blur start,end transforms
via comma syntax, material/mesh refs, lightSamples), and inline `mesh name{}`
blocks with verts/tris. Mesh files are cached per path (instancing shares
one Mesh object).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from ...core import math as tm
from ..model import (
    Camera,
    HostTransform,
    Material,
    Mesh,
    MESH,
    PLANE,
    Primitive,
    Scene,
    SPHERE,
)
from .mesh_io import import_mesh


_FLOAT_RE = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _floats(s: str):
    return [float(x) for x in _FLOAT_RE.findall(s)]


def _look_at_quat(position: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Camera rotation looking from ``position`` at ``target`` (+y up),
    computed on CPU f32 tensors."""
    w2c = tm.look_at_matrix(torch.as_tensor(position), torch.as_tensor(target))
    c2w = tm.mat44_affine_inverse(w2c)
    q = tm.quat_from_matrix3(c2w[:3, :3])
    return q.numpy().astype(np.float32)


class _TinParser:
    def __init__(self, scene: Scene, mesh_cache: Dict[str, Mesh],
                 materials: Dict[str, Material]):
        self.scene = scene
        self.mesh_cache = mesh_cache
        self.materials = materials

    # -- block readers --------------------------------------------------------

    def parse_file(self, path: str):
        with open(path, "r") as f:
            lines = f.read().splitlines()
        self._parse_lines(lines, os.path.dirname(path))

    def _parse_lines(self, lines, base_dir):
        i = 0
        n = len(lines)

        def block(start):
            """Collect lines until the closing '}' (exclusive); returns
            (block_lines, next_index)."""
            j = start
            out = []
            # skip to opening brace if on its own line
            while j < n and "{" not in lines[j] and "}" not in lines[j]:
                j += 1
            if j < n and "{" in lines[j]:
                rest = lines[j].split("{", 1)[1]
                if rest.strip():
                    out.append(rest)
                j += 1
            while j < n and "}" not in lines[j]:
                out.append(lines[j])
                j += 1
            return out, j + 1

        while i < n:
            line = lines[i].strip()
            if not line or line.startswith("#"):
                i += 1
                continue
            tok = line.split()
            head = tok[0]

            if head == "include" and len(tok) >= 2:
                self.parse_file(os.path.join(base_dir, tok[1]))
                i += 1
            elif head == "options":
                body, i = block(i)
                self._options(body)
            elif head == "camera":
                body, i = block(i)
                self._camera(body)
            elif head == "sky":
                body, i = block(i)
                self._sky(body, base_dir)
            elif head == "material" and len(tok) >= 2:
                body, i = block(i)
                self._material(tok[1], body)
            elif head == "primitive":
                body, i = block(i)
                self._primitive(body, base_dir)
            elif head == "mesh" and len(tok) >= 2:
                body, i = block(i)
                self._inline_mesh(tok[1], body)
            else:
                i += 1

    def _options(self, body):
        o = self.scene.options
        for line in body:
            t = line.split()
            if not t:
                continue
            k = t[0]
            if k == "width":
                o.width = int(t[1])
            elif k == "height":
                o.height = int(t[1])
            elif k == "maxSamples":
                o.max_samples = int(t[1])
            elif k == "maxDepth":
                o.max_depth = int(t[1])
            elif k == "rrDepth":  # extension: reference has no RR
                o.rr_depth = int(t[1])
            elif k == "clamp":
                o.clamp = float(t[1])
            elif k == "limit":
                o.limit = float(t[1])
            elif k == "exposure":
                o.exposure = float(t[1])
            elif k == "filter" and len(t) >= 2:
                o.filter_type = t[1]
                if len(t) >= 3:
                    o.filter_width = float(t[2])
                if len(t) >= 4:
                    o.filter_falloff = float(t[3])

    def _camera(self, body):
        cam = self.scene.camera
        target = None
        for line in body:
            t = line.split()
            if not t:
                continue
            k = t[0]
            v = _floats(line)
            if k == "position":
                cam.position = np.asarray(v[:3], np.float32)
            elif k == "rotation":
                cam.rotation = np.asarray(v[:4], np.float32)
            elif k == "target":
                target = np.asarray(v[:3], np.float32)
            elif k == "fov":
                cam.fov = float(np.deg2rad(v[0]))
            elif k == "aperture":  # extension: thin-lens DOF
                cam.aperture = float(v[0])
            elif k == "focaldistance":
                cam.focal_distance = float(v[0])
            elif k == "shutterstart":
                cam.shutter_start = v[0]
            elif k == "shutterend":
                cam.shutter_end = v[0]
        if target is not None:
            cam.rotation = _look_at_quat(cam.position, target)

    def _sky(self, body, base_dir):
        sky = self.scene.sky
        for line in body:
            t = line.split()
            if not t:
                continue
            if t[0] == "horizon":
                sky.horizon = np.asarray(_floats(line)[:3], np.float32)
            elif t[0] == "zenith":
                sky.zenith = np.asarray(_floats(line)[:3], np.float32)
            elif t[0] == "probe" and len(t) >= 2:
                from ..probe_io import load_probe

                sky.probe = load_probe(os.path.join(base_dir, t[1]))

    def _material(self, name, body):
        m = Material()
        trans_color = None
        at_distance = 0.0
        scalar = {
            "metallic": "metallic", "subsurface": "subsurface",
            "specular": "specular", "roughness": "roughness",
            "specularTint": "specular_tint", "anisotropic": "anisotropic",
            "sheen": "sheen", "sheenTint": "sheen_tint",
            "clearcoat": "clearcoat", "clearcoatGloss": "clearcoat_gloss",
            "transmission": "transmission", "eta": "eta",
            "bump": "bump", "bumpTile": "bump_tile",
        }
        for line in body:
            t = line.split()
            if not t:
                continue
            k = t[0]
            v = _floats(line)
            if k == "name":
                name = t[1]
            elif k == "emission":
                m.emission = np.asarray(v[:3], np.float32)
            elif k == "color":
                m.color = np.asarray(v[:3], np.float32)
            elif k == "absorption":
                m.absorption = np.asarray(v[:3], np.float32)
            elif k == "transmissionColor":
                trans_color = np.asarray(v[:3], np.float32)
            elif k == "atDistance":
                at_distance = v[0]
            elif k in scalar and v:
                setattr(m, scalar[k], float(v[0]))
        if at_distance > 0.0 and trans_color is not None:
            m.absorption = (
                -np.log(np.maximum(trans_color, 1e-6)) / at_distance
            ).astype(np.float32)
        self.materials[name] = m

    def _primitive(self, body, base_dir):
        p = Primitive()
        start = HostTransform()
        end: Optional[HostTransform] = None
        valid = True

        def ensure_end():
            nonlocal end
            if end is None:
                end = HostTransform(start.p.copy(), start.q.copy(), start.s)
            return end

        for line in body:
            t = line.split()
            if not t:
                continue
            k = t[0]
            v = _floats(line)
            if k == "type" and len(t) >= 2:
                p.type = {"sphere": SPHERE, "plane": PLANE, "mesh": MESH}[t[1]]
            elif k == "position":
                start.p = np.asarray(v[:3], np.float32)
                if len(v) >= 6:
                    ensure_end().p = np.asarray(v[3:6], np.float32)
                elif end is not None:
                    end.p = start.p.copy()
            elif k == "rotation":
                start.q = np.asarray(v[:4], np.float32)
                if len(v) >= 8:
                    ensure_end().q = np.asarray(v[4:8], np.float32)
                elif end is not None:
                    end.q = start.q.copy()
            elif k == "scale":
                start.s = float(v[0])
                if len(v) >= 2:
                    ensure_end().s = float(v[1])
                elif end is not None:
                    end.s = start.s
            elif k == "radius":
                p.radius = float(v[0])
            elif k == "plane":
                p.plane = np.asarray(v[:4], np.float32)
            elif k == "lightSamples":
                p.light_samples = int(v[0])
            elif k == "material" and len(t) >= 2:
                if t[1] in self.materials:
                    p.material = self.materials[t[1]]
                else:
                    print(f"Could not find material {t[1]}")
            elif k == "mesh" and len(t) >= 2:
                ref = t[1]
                if ref in self.mesh_cache:
                    p.mesh = self.mesh_cache[ref]
                else:
                    path = os.path.join(base_dir, ref)
                    try:
                        mesh = import_mesh(path)
                        self.mesh_cache[ref] = mesh
                        p.mesh = mesh
                    except (OSError, ValueError) as e:
                        print(f"Failed to import mesh {path}: {e}")
                        valid = False

        # fix up end transform for fields set after the comma pairs
        if end is not None:
            p.end_transform = end
        p.start_transform = start
        if p.type == MESH and p.mesh is None:
            valid = False
        if valid:
            self.scene.add_primitive(p)

    def _inline_mesh(self, name, body):
        positions = []
        tris = []
        i = 0
        while i < len(body):
            t = body[i].split()
            i += 1
            if not t:
                continue
            if t[0] == "verts":
                count = int(t[1])
                for _ in range(count):
                    positions.append(_floats(body[i])[:3])
                    i += 1
            elif t[0] == "tris":
                count = int(t[1])
                for _ in range(count):
                    tris.append([int(x) for x in re.findall(r"-?\d+", body[i])][:3])
                    i += 1
        mesh = Mesh(
            positions=np.asarray(positions, np.float32),
            indices=np.asarray(tris, np.int32),
            name=name,
        )
        mesh.build()
        self.mesh_cache[name] = mesh


def load_tin(path: str, scene: Optional[Scene] = None) -> Scene:
    """Load a .tin file into a Scene (camera/options merged in-place)."""
    scene = scene or Scene()
    parser = _TinParser(scene, mesh_cache={}, materials={})
    parser.parse_file(path)
    return scene
