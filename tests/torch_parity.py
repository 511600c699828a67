"""Helpers shared by the tests that hold tinsel_tpu_torch against tinsel_tpu:
a JAX-backed UniformSource and numpy views of the JAX package's state."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch


class JaxUniforms:
    """UniformSource that reproduces the JAX package's draws: fold ``key``
    along ``path``, then ``jax.random.uniform(k, shape)``."""

    def __init__(self, key):
        self.key = key

    def uniform(self, path, shape):
        k = self.key
        for p in path:
            k = jax.random.fold_in(k, p)
        return torch.from_numpy(np.array(jax.random.uniform(k, tuple(shape))))


def scene_to_numpy(flat):
    """(arrays, static) of a tinsel_tpu SceneFlat, the input of
    tinsel_tpu_torch.scene.convert.scene_flat_from_numpy."""
    arrays = {}
    for group in ("prims", "materials"):
        obj = getattr(flat, group)
        for f in dataclasses.fields(obj):
            arrays[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    arrays["pool.node_rows"] = np.asarray(flat.pool.node_rows)
    arrays["pool.block_rows"] = np.asarray(flat.pool.block_rows)
    arrays["pool.tri_cdf"] = np.asarray(flat.pool.tri_cdf)
    arrays["pool.tri_planes"] = np.stack([np.asarray(p) for p in flat.pool.tri_planes])
    arrays["pool.nrm_planes"] = np.stack([np.asarray(p) for p in flat.pool.nrm_planes])
    for name in ("sky_horizon", "sky_zenith", "prim_type", "prim_light_samples",
                 "prim_local_area", "prim_bump"):
        arrays[name] = np.asarray(getattr(flat, name))
    prim_static = []
    for ps in flat.prim_static:
        mesh = None if ps.mesh is None else dataclasses.asdict(ps.mesh)
        prim_static.append(dict(
            type=ps.type, mesh=mesh, material_index=ps.material_index,
            light_samples=ps.light_samples, motion=ps.motion,
        ))
    return arrays, dict(prim_static=prim_static, light_indices=flat.light_indices,
                        has_bump=flat.has_bump)


def camera_to_numpy(cam):
    return {f.name: np.asarray(getattr(cam, f.name)) for f in dataclasses.fields(cam)}


def materials_rows(flat, idx):
    """The JAX MaterialsFlat gathered at numpy indices, as a dict."""
    return {
        f.name: np.asarray(getattr(flat.materials, f.name))[idx]
        for f in dataclasses.fields(flat.materials)
    }
