"""Host scene model (NumPy dataclasses) and its flattening to device tensors.

The port's own copy of ``tinsel_tpu/scene/model.py`` (``Scene.flatten`` at
``:434-675``) for spheres, planes and triangle meshes of any size. Every
mesh is built into the 16-ary traversal layout (``accel/build.py``): node
rows, 16-triangle leaf blocks and the triangles in block-padded order,
exactly as the JAX package lays them out (the native C++ builder for
meshes of 4,096 triangles or more, the NumPy one below that). Meshes
that fit one block keep the brute sweep at trace time. An HDR probe
(``HostProbe``) becomes a ``ProbeFlat`` of tensors with its f64-built CDF,
and ``SceneFlat.light_pmf`` holds the power-proportional light pmf of
``light_sampling="power"``.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import field
from typing import List, Optional

import numpy as np
import torch

from ..accel.build import (
    BVH,
    NODE_ROW_WIDTH,
    NODE_SKIP_COL,
    NODE_WORD_COL,
    BLOCK_SIZE,
    build_bvh,
    build_wide_bvh,
    triangle_bounds,
    wide_stack_bound,
)
from ..accel.traverse import MAX_STACK_SLOTS, MeshHandle, MeshPool
from ..device import resolve_device

# primitive type tags
SPHERE = 0
PLANE = 1
MESH = 2


def _light_pmf(prims, local_area):
    """Power-proportional light-selection pmf (luminance x world area),
    normalized over emissive primitives; zero elsewhere (port of
    ``tinsel_tpu/scene/model.py:46``, in f64 as there)."""
    pmf = np.zeros(max(len(prims), 1), np.float64)
    for i, p in enumerate(prims):
        if p.light_samples > 0:
            e = np.asarray(p.material.emission, np.float64)
            lum = 0.3 * e[0] + 0.6 * e[1] + 0.1 * e[2]
            s = float(p.start_transform.s)
            pmf[i] = max(lum, 1e-12) * max(local_area[i] * s * s, 1e-12)
    t = pmf.sum()
    if t > 0:
        pmf /= t
    return pmf.astype(np.float32)


# ---------------------------------------------------------------------- host


@dataclasses.dataclass
class Material:
    """Disney BSDF material; defaults mirror the reference's."""

    color: np.ndarray = field(default_factory=lambda: np.array([0.82, 0.67, 0.16], np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    absorption: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    eta: float = 0.0  # 0 => infer from specular
    metallic: float = 0.0
    subsurface: float = 0.0
    specular: float = 0.5
    roughness: float = 0.5
    specular_tint: float = 0.0
    anisotropic: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 1.0
    transmission: float = 0.0
    bump: float = 0.0
    bump_tile: float = 10.0

    def index_of_refraction(self) -> float:
        if self.eta == 0.0:
            return 2.0 / (1.0 - np.sqrt(0.08 * self.specular)) - 1.0
        return self.eta


@dataclasses.dataclass
class HostTransform:
    p: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    q: np.ndarray = field(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    s: float = 1.0

    def copy(self) -> "HostTransform":
        return HostTransform(self.p.copy(), self.q.copy(), float(self.s))


@dataclasses.dataclass
class Mesh:
    """Host triangle mesh with vertex normals, BVH and area CDF."""

    positions: np.ndarray  # (V, 3) f32
    indices: np.ndarray  # (T, 3) i32
    normals: Optional[np.ndarray] = None  # (V, 3) f32
    bvh: Optional[BVH] = None
    cdf: Optional[np.ndarray] = None  # (T,) normalized area CDF
    area: float = 0.0
    name: str = ""

    def calculate_normals(self):
        """Area-weighted vertex normals."""
        pos = self.positions
        idx = self.indices
        fn = np.cross(
            pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]]
        )
        normals = np.zeros_like(pos)
        np.add.at(normals, idx[:, 0], fn)
        np.add.at(normals, idx[:, 1], fn)
        np.add.at(normals, idx[:, 2], fn)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        self.normals = (normals / np.maximum(norm, 1e-20)).astype(np.float32)

    def rebuild_cdf(self):
        pos = self.positions
        idx = self.indices
        areas = 0.5 * np.linalg.norm(
            np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]]),
            axis=-1,
        )
        total = float(areas.sum())
        self.area = total
        self.cdf = (np.cumsum(areas) / max(total, 1e-30)).astype(np.float32)

    def rebuild_bvh(self):
        lo, hi = triangle_bounds(self.positions, self.indices)
        self.bvh = build_bvh(lo, hi)

    def build(self):
        if self.normals is None or len(self.normals) != len(self.positions):
            self.calculate_normals()
        self.rebuild_cdf()
        self.rebuild_bvh()

    def normalize(self, size: float = 1.0):
        """Translate to the origin and scale the longest edge to ``size``."""
        lo = self.positions.min(axis=0)
        hi = self.positions.max(axis=0)
        self.positions = (self.positions - lo).astype(np.float32)
        max_edge = float((hi - lo).max())
        if max_edge > 0:
            self.positions *= np.float32(size / max_edge)

    def transform(self, matrix: np.ndarray):
        """Apply a 4x4 affine to positions (and rotate normals)."""
        p = self.positions @ matrix[:3, :3].T + matrix[:3, 3]
        self.positions = p.astype(np.float32)
        if self.normals is not None:
            n = self.normals @ np.linalg.inv(matrix[:3, :3])
            norm = np.linalg.norm(n, axis=-1, keepdims=True)
            self.normals = (n / np.maximum(norm, 1e-20)).astype(np.float32)

    def add_mesh(self, other: "Mesh"):
        offset = len(self.positions)
        self.positions = np.concatenate([self.positions, other.positions]).astype(np.float32)
        if self.normals is not None and other.normals is not None:
            self.normals = np.concatenate([self.normals, other.normals]).astype(np.float32)
        else:
            self.normals = None
        self.indices = np.concatenate([self.indices, other.indices + offset]).astype(np.int32)


@dataclasses.dataclass
class Primitive:
    type: int = SPHERE
    start_transform: HostTransform = field(default_factory=HostTransform)
    end_transform: Optional[HostTransform] = None  # None => same as start
    radius: float = 1.0
    plane: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0, 0], np.float32))
    mesh: Optional[Mesh] = None
    material: Material = field(default_factory=Material)
    light_samples: int = 0

    def resolved_end(self) -> HostTransform:
        return self.end_transform if self.end_transform is not None else self.start_transform


@dataclasses.dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = field(default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    fov: float = float(np.deg2rad(45.0))
    shutter_start: float = 0.0
    shutter_end: float = 1.0
    aperture: float = 0.0  # thin-lens radius; 0 = pinhole
    focal_distance: float = 1.0


@dataclasses.dataclass
class Sky:
    horizon: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0], np.float32))
    zenith: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0], np.float32))
    probe: Optional["HostProbe"] = None


@dataclasses.dataclass
class HostProbe:
    """Lat-long HDR environment map with a luminance-weighted 2D CDF,
    built in f64 and stored as f32 (port of
    ``tinsel_tpu/scene/model.py:216``)."""

    data: np.ndarray  # (H, W, 3) f32 linear radiance
    pdf_x: np.ndarray = None  # (H, W)
    cdf_x: np.ndarray = None  # (H, W)
    pdf_y: np.ndarray = None  # (H,)
    cdf_y: np.ndarray = None  # (H,)

    def build_cdf(self):
        lum = (
            0.3 * self.data[..., 0]
            + 0.6 * self.data[..., 1]
            + 0.1 * self.data[..., 2]
        ).astype(np.float64)
        row_sum = lum.sum(axis=1, keepdims=True)  # (H, 1)
        row_sum_safe = np.maximum(row_sum, 1e-30)
        self.pdf_x = (lum / row_sum_safe).astype(np.float32)
        self.cdf_x = (np.cumsum(lum, axis=1) / row_sum_safe).astype(np.float32)
        total = np.maximum(lum.sum(), 1e-30)
        self.pdf_y = (row_sum[:, 0] / total).astype(np.float32)
        self.cdf_y = (np.cumsum(row_sum[:, 0]) / total).astype(np.float32)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class Options:
    """Render options: the JAX package's fields and defaults, less its
    execution knobs (``backend``: the port has one bounce loop, which
    stops once every path is dead; ``prng``: the JAX key type)."""

    width: int = 512
    height: int = 256
    max_depth: int = 4
    max_samples: int = 512
    exposure: float = 1.0
    limit: float = 1.5
    clamp: float = float("inf")
    filter_type: str = "gaussian"  # "box" | "gaussian"
    filter_width: float = 0.75
    filter_falloff: float = 1.0
    mode: str = "pathtrace"
    sampler: str = "random"
    rr_depth: int = 0
    light_sampling: str = "all"


# --------------------------------------------------------------------- device


class _GatherRows(torch.autograd.Function):
    """``table[i]`` for each of several (M, ...) tables: ``index_select``
    forward (exact); backward ``onehot(i)^T @ grad`` for all tables in one
    (M, N) x (N, F) matmul, F the tables' summed row widths. Exact in f32
    up to the order of the sum: every one-hot entry is 0 or 1."""

    @staticmethod
    def forward(ctx, i, *tables):
        ctx.set_materialize_grads(False)
        flat = i.reshape(-1)
        ctx.save_for_backward(flat)
        ctx.shapes = [t.shape for t in tables]
        return tuple(
            t.index_select(0, flat).reshape(*i.shape, *t.shape[1:]) for t in tables
        )

    @staticmethod
    def backward(ctx, *grads):
        (flat,) = ctx.saved_tensors
        live = [k for k, g in enumerate(grads)
                if g is not None and ctx.needs_input_grad[k + 1]]
        out = [None] * len(grads)
        if live:
            n, m = flat.shape[0], ctx.shapes[0][0]
            g = torch.cat([grads[k].reshape(n, -1) for k in live], dim=1)
            onehot = flat[None, :] == torch.arange(m, device=flat.device)[:, None]
            sums = onehot.to(g.dtype) @ g  # (M, F)
            widths = [math.prod(ctx.shapes[k][1:]) for k in live]
            for k, s in zip(live, torch.split(sums, widths, dim=1)):
                out[k] = s.reshape(ctx.shapes[k])
        return (None, *out)


@dataclasses.dataclass(frozen=True)
class MaterialsFlat:
    emission: torch.Tensor  # (M, 3)
    color: torch.Tensor  # (M, 3)
    absorption: torch.Tensor  # (M, 3)
    eta: torch.Tensor  # (M,) resolved index of refraction (>0)
    metallic: torch.Tensor
    subsurface: torch.Tensor
    specular: torch.Tensor
    roughness: torch.Tensor
    specular_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    transmission: torch.Tensor

    def select(self, i):
        """Per-lane material record for index tensor i: an exact gather
        whose backward sums each lane's gradient into its row by a one-hot
        matmul, as the JAX package's ``select_oh`` does (advanced indexing
        would take the accumulating ``index_put``, which serializes on the
        few material rows every lane lands on)."""
        names = [f.name for f in dataclasses.fields(self)]
        rows = _GatherRows.apply(i.long(), *(getattr(self, k) for k in names))
        return MaterialsFlat(**dict(zip(names, rows)))

    @classmethod
    def from_host(cls, mats: list, device) -> "MaterialsFlat":
        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(
            emission=t(np.stack([m.emission for m in mats])),
            color=t(np.stack([m.color for m in mats])),
            absorption=t(np.stack([m.absorption for m in mats])),
            eta=t([m.index_of_refraction() for m in mats]),
            metallic=t([m.metallic for m in mats]),
            subsurface=t([m.subsurface for m in mats]),
            specular=t([m.specular for m in mats]),
            roughness=t([m.roughness for m in mats]),
            specular_tint=t([m.specular_tint for m in mats]),
            clearcoat=t([m.clearcoat for m in mats]),
            clearcoat_gloss=t([m.clearcoat_gloss for m in mats]),
            transmission=t([m.transmission for m in mats]),
        )


@dataclasses.dataclass(frozen=True)
class PrimsFlat:
    """Per-primitive continuous parameters."""

    start_p: torch.Tensor  # (P, 3)
    start_q: torch.Tensor  # (P, 4)
    start_s: torch.Tensor  # (P,)
    end_p: torch.Tensor
    end_q: torch.Tensor
    end_s: torch.Tensor
    radius: torch.Tensor  # (P,)
    plane: torch.Tensor  # (P, 4)


@dataclasses.dataclass(frozen=True)
class ProbeFlat:
    data: torch.Tensor  # (H, W, 3)
    pdf_x: torch.Tensor  # (H, W)
    cdf_x: torch.Tensor  # (H, W)
    pdf_y: torch.Tensor  # (H,)
    cdf_y: torch.Tensor  # (H,)


@dataclasses.dataclass(frozen=True)
class PrimStatic:
    """Host-side facts about one primitive that shape the computation."""

    type: int
    mesh: Optional[MeshHandle]
    material_index: int
    light_samples: int
    motion: bool = True  # start != end transform


@dataclasses.dataclass(frozen=True)
class SceneFlat:
    prims: PrimsFlat
    materials: MaterialsFlat
    pool: MeshPool
    sky_horizon: torch.Tensor  # (3,)
    sky_zenith: torch.Tensor  # (3,)
    prim_type: torch.Tensor  # (P,) i32
    prim_light_samples: torch.Tensor  # (P,) i32
    prim_local_area: torch.Tensor  # (P,) f32 (sphere: 4 pi r^2; mesh: area)
    prim_bump: torch.Tensor  # (P, 2) f32 [strength, tile]
    light_pmf: Optional[torch.Tensor] = None  # (P,) f32, power-proportional
    probe: Optional[ProbeFlat] = None
    prim_static: tuple = ()
    light_indices: tuple = ()
    has_bump: bool = False  # some material has bump > 0


@dataclasses.dataclass
class Scene:
    primitives: List[Primitive] = field(default_factory=list)
    sky: Sky = field(default_factory=Sky)
    camera: Camera = field(default_factory=Camera)
    options: Options = field(default_factory=Options)

    def add_primitive(self, p: Primitive):
        self.primitives.append(p)

    def flatten(self, device=None) -> SceneFlat:
        """Device tensors of the scene on ``device`` (``None``: cuda)."""
        device = resolve_device(device)
        if not self.primitives:
            # sky-only scene: one invisible primitive keeps every table
            # non-empty; rays can never hit it
            self = dataclasses.replace(
                self,
                primitives=[
                    Primitive(
                        type=SPHERE, radius=0.0,
                        material=Material(
                            color=np.zeros(3, np.float32),
                            emission=np.zeros(3, np.float32),
                        ),
                    )
                ],
            )

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

        # deduplicate meshes by object identity (instancing)
        mesh_list: List[Mesh] = []
        mesh_ids = {}
        for prim in self.primitives:
            if prim.type == MESH and prim.mesh is not None:
                if id(prim.mesh) not in mesh_ids:
                    mesh_ids[id(prim.mesh)] = len(mesh_list)
                    mesh_list.append(prim.mesh)

        handles: List[MeshHandle] = []
        node_rows_list = []
        tri_arrays = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2", "cdf")}
        node_off = tri_off = 0
        for m in mesh_list:
            if m.bvh is None or m.cdf is None or m.normals is None:
                m.build()
            wide = build_wide_bvh(m.bvh)
            node_rows_list.append(wide.node_rows)
            tri_idx = m.indices[wide.perm_padded]  # (Tp, 3) vertex ids
            v = m.positions[tri_idx]  # (Tp, 3, 3)
            n = m.normals[tri_idx]
            for k in range(3):
                tri_arrays[f"v{k}"].append(v[:, k])
                tri_arrays[f"n{k}"].append(n[:, k])
            # area CDF over the padded order: padding slots add zero mass
            areas = 0.5 * np.linalg.norm(
                np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1
            )
            areas = np.where(wide.real_mask, areas, 0.0)
            tri_arrays["cdf"].append(
                (np.cumsum(areas) / max(float(areas.sum()), 1e-30)).astype(
                    np.float32
                )
            )
            n_padded = len(wide.perm_padded)
            ss = wide_stack_bound(wide)
            if ss > MAX_STACK_SLOTS:
                raise ValueError(
                    f"mesh BVH needs {ss} traversal stack slots (> "
                    f"{MAX_STACK_SLOTS}): pathologically deep tree - rebuild "
                    "with a larger leaf size or simplify the mesh"
                )
            handles.append(
                MeshHandle(
                    node_offset=node_off,
                    num_nodes=wide.num_nodes,
                    tri_offset=tri_off,
                    num_tris=n_padded,
                    real_tris=int(len(m.indices)),
                    area=float(m.area),
                    root_lower=tuple(float(x) for x in wide.root_lower),
                    root_upper=tuple(float(x) for x in wide.root_upper),
                    stack_slots=ss,
                )
            )
            node_off += wide.num_nodes
            tri_off += n_padded

        if node_rows_list:
            node_rows = np.concatenate(node_rows_list, axis=0)
        else:  # empty pool: one terminal row whose NaN boxes never hit
            node_rows = np.full((1, NODE_ROW_WIDTH), np.nan, np.float32)
            node_rows[0, NODE_WORD_COL:] = 0.0
            node_rows[0, NODE_SKIP_COL] = np.int32(-1).view(np.float32)

        def planes9(k0, k1, k2):
            cols = []
            for k in (k0, k1, k2):
                a = (
                    np.concatenate(tri_arrays[k])
                    if tri_arrays[k]
                    else np.zeros((1, 3), np.float32)
                )
                cols.extend(t(np.ascontiguousarray(a[:, i])) for i in range(3))
            return tuple(cols)

        def block_rows():
            """(B, 192): per block 16 x v0x, 16 x v0y, ..., 16 x v2z, then
            48 columns of padding."""
            if not tri_arrays["v0"]:
                return np.zeros((1, BLOCK_SIZE * 12), np.float32)
            comps = [
                np.concatenate(tri_arrays[key])[:, i]
                for key in ("v0", "v1", "v2")
                for i in range(3)
            ]
            n_blocks = comps[0].shape[0] // BLOCK_SIZE
            out = np.zeros((n_blocks, BLOCK_SIZE * 12), np.float32)
            for g, comp in enumerate(comps):
                out[:, BLOCK_SIZE * g:BLOCK_SIZE * (g + 1)] = comp.reshape(
                    n_blocks, BLOCK_SIZE
                )
            return out

        pool = MeshPool(
            node_rows=t(node_rows),
            block_rows=t(block_rows()),
            tri_cdf=t(
                np.concatenate(tri_arrays["cdf"]) if tri_arrays["cdf"]
                else np.zeros((1,), np.float32)
            ),
            tri_planes=planes9("v0", "v1", "v2"),
            nrm_planes=planes9("n0", "n1", "n2"),
        )

        prims = self.primitives
        mf = MaterialsFlat.from_host([p.material for p in prims], device)
        ends = [p.resolved_end() for p in prims]
        pf = PrimsFlat(
            start_p=t(np.stack([p.start_transform.p for p in prims])),
            start_q=t(np.stack([p.start_transform.q for p in prims])),
            start_s=t([p.start_transform.s for p in prims]),
            end_p=t(np.stack([e.p for e in ends])),
            end_q=t(np.stack([e.q for e in ends])),
            end_s=t([e.s for e in ends]),
            radius=t([p.radius for p in prims]),
            plane=t(np.stack([p.plane for p in prims])),
        )

        prim_static = []
        for i, p in enumerate(prims):
            handle = None
            if p.type == MESH and p.mesh is not None:
                handle = handles[mesh_ids[id(p.mesh)]]
            e = p.resolved_end()
            st = p.start_transform
            # q and -q are the same rotation
            sq, eq = np.asarray(st.q), np.asarray(e.q)
            moving = not (
                np.array_equal(np.asarray(st.p), np.asarray(e.p))
                and (np.array_equal(sq, eq) or np.array_equal(sq, -eq))
                and float(st.s) == float(e.s)
            )
            prim_static.append(
                PrimStatic(
                    type=p.type,
                    mesh=handle,
                    material_index=i,
                    light_samples=int(p.light_samples),
                    motion=moving,
                )
            )

        probe_flat = None
        if self.sky.probe is not None:
            hp = self.sky.probe
            if hp.cdf_x is None:
                hp.build_cdf()
            probe_flat = ProbeFlat(**{
                k: t(getattr(hp, k)) for k in ("data", "pdf_x", "cdf_x", "pdf_y", "cdf_y")
            })

        local_area = []
        for p in prims:
            if p.type == SPHERE:
                local_area.append(4.0 * np.pi * p.radius * p.radius)
            elif p.type == MESH and p.mesh is not None:
                local_area.append(float(p.mesh.area))
            else:
                local_area.append(0.0)

        return SceneFlat(
            prims=pf,
            materials=mf,
            pool=pool,
            sky_horizon=t(self.sky.horizon),
            sky_zenith=t(self.sky.zenith),
            prim_type=t([p.type for p in prims], torch.int32),
            prim_light_samples=t([p.light_samples for p in prims], torch.int32),
            prim_local_area=t(local_area),
            prim_bump=t([[p.material.bump, p.material.bump_tile] for p in prims]),
            light_pmf=t(_light_pmf(prims, local_area)),
            probe=probe_flat,
            prim_static=tuple(prim_static),
            light_indices=tuple(
                i for i, p in enumerate(prims) if p.light_samples > 0
            ),
            has_bump=any(p.material.bump > 0.0 for p in prims),
        )
