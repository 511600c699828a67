"""Scenes and shading inputs for the NEE tests (tests/test_torch_nee_launch.py
on the CPU, tests/test_torch_nee_cuda.py on the card). JAX-free.

Each scene is flattened on the device asked for; ``bounce_inputs`` shoots
rays from the camera into the scene and builds what the integrator hands
``sample_lights`` at a bounce (render/integrator.py: the hit's material
record, p, n, the ray's eta and the one past the surface, wo = -d), with a
share of the lanes inside a dielectric (eta_i 1.5). ``leaf_scene`` and
``nee_grads`` take ``sample_lights``' gradients.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from tinsel_tpu_torch.core.math import normalize
from tinsel_tpu_torch.ops.nee import _MATERIAL
from tinsel_tpu_torch.render import lights
from tinsel_tpu_torch.render.trace import trace_closest
from tinsel_tpu_torch.scene import model, presets

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")


def sphere_light(p, radius=0.12, end_p=None, end_s=1.0, samples=1, emission=(4.0, 6.0, 9.0)):
    end = None if end_p is None else model.HostTransform(p=np.asarray(end_p, np.float32),
                                                         s=end_s)
    return model.Primitive(
        type=model.SPHERE, radius=radius,
        start_transform=model.HostTransform(p=np.asarray(p, np.float32)),
        end_transform=end,
        material=model.Material(color=np.zeros(3, np.float32),
                                emission=np.asarray(emission, np.float32)),
        light_samples=samples,
    )


def mesh_light(n=10, seed=3):
    """An emissive, jittered n x n grid under the ceiling: 2 n^2 triangles
    of unequal areas, one light sample."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-0.4, 0.4, n + 1, dtype=np.float32)
    x, z = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([x, np.zeros_like(x), z], -1).reshape(-1, 3)
    pos[:, [0, 2]] += rng.uniform(-0.3, 0.3, (pos.shape[0], 2)).astype(np.float32) * 0.8 / n
    idx = []
    for i in range(n):
        for k in range(n):
            a, b, c, d = i * (n + 1) + k, (i + 1) * (n + 1) + k, (i + 1) * (n + 1) + k + 1, \
                i * (n + 1) + k + 1
            idx += [[a, c, b], [a, d, c]]  # normals down, into the box
    mesh = model.Mesh(pos.astype(np.float32), np.asarray(idx, np.int32))
    return model.Primitive(
        type=model.MESH, mesh=mesh,
        start_transform=model.HostTransform(p=np.array([0.1, 1.95, 0.05], np.float32)),
        material=model.Material(color=np.zeros(3, np.float32),
                                emission=np.array([6.0, 5.0, 4.0], np.float32)),
        light_samples=1,
    )


CORNELL_TIN_EYE = (0.0, 1.0, -3.3)  # scenes/cornell.tin looks along +z


def cornell_tin():
    from tinsel_tpu_torch.scene.loaders.tin import load_tin
    return load_tin(os.path.join(SCENES, "cornell.tin"))


def cornell_lights():
    """The preset Cornell box (quad light, prim 5) with a static sphere
    light (prim 8), a moving, growing sphere light of two samples (prim 9)
    and a jittered mesh light of 200 triangles (prim 10)."""
    sc = presets.cornell_scene(8, 8, 2)
    sc.add_primitive(sphere_light([-0.6, 1.6, -0.3], radius=0.1))
    sc.add_primitive(sphere_light([0.5, 1.5, 0.4], end_p=[0.4, 1.55, 0.4], end_s=1.3,
                                  samples=2))
    sc.add_primitive(mesh_light())
    return sc


def envmesh_probe(samples=10, detail=24):
    """The envmesh under the test probe, its mesh a marble (subsurface,
    eta 1.5 through transmission 0.3, clearcoat), with a sphere light of
    ``samples`` samples: ajaxenv's NEE on a small mesh."""
    sc = presets.envmesh_scene(8, 8, 2, detail=detail, probe=True)
    sc.primitives[0].material = model.Material(
        color=np.array([0.8, 0.75, 0.7], np.float32), roughness=0.2, specular=0.5,
        subsurface=0.8, transmission=0.3, eta=1.5, clearcoat=0.5, clearcoat_gloss=0.7)
    sc.add_primitive(sphere_light([1.2, 2.4, 1.0], radius=0.3, samples=samples,
                                  emission=(30.0, 28.0, 24.0)))
    return sc


def bounce_inputs(flat, r: int, seed: int, device, eye=(0.0, 1.0, 3.3)):
    """(mat, eta_i, eta_o, p, n, wo, times) at the first hits of r rays
    from around ``eye`` (the camera of the presets) into the box
    [-1, 1] x [0, 2] x [-1, 1]."""
    rng = np.random.default_rng(seed)
    o = np.asarray(eye, np.float32) + rng.uniform(-0.2, 0.2, (r, 3)).astype(np.float32)
    tgt = np.stack([rng.uniform(-1, 1, r), rng.uniform(0, 2, r), rng.uniform(-1, 1, r)], -1)
    o = torch.from_numpy(o).to(device)
    d = normalize(torch.from_numpy(tgt.astype(np.float32)).to(device) - o)
    times = torch.from_numpy(rng.random(r, dtype=np.float32)).to(device)
    with torch.no_grad():
        hit = trace_closest(flat, o, d, times)
        found = hit.prim >= 0
        m = flat.materials.select(torch.clamp(hit.prim, min=0).long())
        inside = torch.from_numpy(rng.random(r) < 0.25).to(device)
        eta_i = torch.where(inside, 1.5, 1.0)
        eta_o = torch.where(eta_i == 1.0, m.eta, 1.0)
        p = o + d * torch.where(found, hit.t, 0.0)[..., None]
    return m, eta_i, eta_o, p, hit.normal, -d, times


def leaf_scene(flat, vertex_grads):
    """``flat`` with the tables NEE differentiates through as leaves: the
    light transforms and radii, the emission, and the mesh pool's planes
    where ``vertex_grads``."""
    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    prims = dataclasses.replace(flat.prims, start_p=leaf(flat.prims.start_p),
                                end_p=leaf(flat.prims.end_p), start_s=leaf(flat.prims.start_s),
                                radius=leaf(flat.prims.radius))
    materials = dataclasses.replace(flat.materials, emission=leaf(flat.materials.emission))
    pool = flat.pool
    if vertex_grads:
        pool = dataclasses.replace(pool, tri_planes=tuple(leaf(x) for x in pool.tri_planes),
                                   nrm_planes=tuple(leaf(x) for x in pool.nrm_planes))
    return dataclasses.replace(flat, prims=prims, materials=materials, pool=pool)


def nee_grads(flat, args, mode, source):
    """``sample_lights``' value and the gradients of a fixed projection of
    it with respect to p, the material record's fields and the leaves of
    ``leaf_scene``."""
    m, eta_i, eta_o, p, n, wo, times = args
    p = p.detach().clone().requires_grad_(True)
    fields = {k: getattr(m, k).detach().clone().requires_grad_(True) for k in _MATERIAL}
    mat = dataclasses.replace(m, **fields)
    out = lights.sample_lights(flat, mat, eta_i, eta_o, p, n, wo, times, source,
                               light_sampling=mode)
    w = torch.linspace(0.5, 1.5, out.numel(), device=out.device).reshape(out.shape)
    leaves = [p, *fields.values(), flat.prims.start_p, flat.prims.end_p, flat.prims.start_s,
              flat.prims.radius, flat.materials.emission]
    if flat.pool.tri_planes[0].requires_grad:
        leaves += [*flat.pool.tri_planes, *flat.pool.nrm_planes]
    grads = torch.autograd.grad((out * w).sum(), leaves, allow_unused=True)
    return out.detach(), [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
