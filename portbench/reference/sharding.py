"""A frozen copy of the port's ``parallel/sharding.py`` render path (no
training step), the reference's entry points for a cell of several cards
when the control puts the reference in the port's place. Rank (i, j) of a
(rays, spp) mesh renders image rows band i of the step's passes range j,
each sample splatted at its own pixels into a full buffer, and one
``all_reduce`` sums the buffers. ``band``: only the rows of this rank's
band that lie in ``band`` (the rows the check compares; a rank with none
adds zeros). The ranks join their process group through the port's
``init_distributed``: the group carries the sums, and computes nothing."""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .tinsel_ref.render.renderer import render_pass


def make_mesh(spp_parallel: int = 1) -> DeviceMesh:
    n = dist.get_world_size()
    if n % spp_parallel:
        raise ValueError(f"{n} ranks do not split into spp groups of {spp_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // spp_parallel, spp_parallel),
                            mesh_dim_names=("rays", "spp"))


def sharded_render_fn(mesh: DeviceMesh, spp_per_step: int, band=None, **opts):
    n_rays, n_spp = mesh.shape
    height = opts["height"]
    if height % n_rays or spp_per_step % n_spp:
        raise ValueError(f"{height} rows, {spp_per_step} passes over a mesh {tuple(mesh.shape)}")
    i, j = mesh.get_coordinate()
    rows = (i * height // n_rays, (i + 1) * height // n_rays)
    if band is not None:
        rows = (max(rows[0], band[0]), min(rows[1], band[1]))
    per = spp_per_step // n_spp
    passes = range(j * per, (j + 1) * per)

    @torch.no_grad()
    def fn(scene, cam, sources):
        acc = torch.zeros((height, opts["width"], 4), dtype=torch.float32,
                          device=cam.position.device)
        if rows[0] < rows[1]:
            for k in passes:
                acc = acc + render_pass(scene, cam, sources[k], rows=rows, **opts)
        dist.all_reduce(acc)
        return acc

    return fn
