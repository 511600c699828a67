"""Multi-GPU execution on ``torch.distributed`` (port of
``tinsel_tpu/parallel/sharding.py``): image rows and sample passes spread
over the ranks of a (rays, spp) mesh, the scene replicated on every rank,
framebuffers and gradients summed over the ranks.

One process per rank. Rank (i, j) of a mesh of shape (n_rays, n_spp)
renders rows [i H / n_rays, (i + 1) H / n_rays) of its passes
[j P / n_spp, (j + 1) P / n_spp) of the P passes of a step. Where the JAX
package lets GSPMD split one program, each rank here traces only its own
lanes, drawing every uniform at the whole pass's shape and keeping its
lanes (``render_pass(rows=...)``), so a rank's samples are the unsharded
pass's samples. The Gaussian splat reaches past a band's rows, so each
rank splats its samples at their own pixels into a full (H, W, 4) buffer
and one ``all_reduce`` sums the buffers over the mesh: every rank ends
with the whole image (the JAX function gives each device its rows).

Transports: NCCL needs one GPU per rank, and is the default wherever CUDA
is. Ranks that share a GPU (or run on the CPU) ask for gloo, which sums
CUDA tensors by staging them through the host. Nothing switches backend
on its own: NCCL with fewer GPUs than ranks raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..diff.gradients import _flat, _unflat, linear_image, loss_and_grads
from ..render.renderer import render_pass


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None):
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator``: ``host:port`` of rank 0 (or a full ``tcp://`` or
    ``file://`` address) with ``num_processes`` and ``process_id``; with no
    arguments, torchrun's variables (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), as the JAX function reads
    its environment's bootstrap. ``backend``: "nccl" or "gloo"; None means
    NCCL where CUDA is available, else gloo. NCCL puts rank r on GPU
    ``LOCAL_RANK`` (default r) and raises if there are fewer GPUs than
    ranks on this host."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    world = int(os.environ["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(os.environ["RANK"] if process_id is None else process_id)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        gpus = torch.cuda.device_count()
        if local >= gpus:
            raise ValueError(
                f"NCCL needs one GPU per rank: local rank {local} of {world} ranks, "
                f"{gpus} GPU(s); ranks that share a GPU ask for backend='gloo'")
        torch.cuda.set_device(local)
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def make_mesh(n_devices: int | None = None, spp_parallel: int = 1) -> DeviceMesh:
    """The (rays, spp) mesh of shape (n / spp_parallel, spp_parallel) over
    the process group's ranks; ``n_devices``, when given, must be the
    group's size. Its device type follows the backend (NCCL: cuda, gloo:
    cpu); a rank's tensors live where its caller puts them."""
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} ranks in a process group of {n}")
    if n % spp_parallel:
        raise ValueError(f"{n} ranks do not split into spp groups of {spp_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // spp_parallel, spp_parallel),
                            mesh_dim_names=("rays", "spp"))


def _my_share(mesh: DeviceMesh, spp_per_step: int, height: int):
    """(rows, passes) of this rank: its band of image rows and its range of
    the step's passes."""
    n_rays, n_spp = mesh.shape
    if height % n_rays:
        raise ValueError(f"{height} rows do not split over {n_rays} ranks")
    if spp_per_step % n_spp:
        raise ValueError(f"{spp_per_step} passes do not split over {n_spp} ranks")
    i, j = mesh.get_coordinate()
    band, per = height // n_rays, spp_per_step // n_spp
    return (i * band, (i + 1) * band), range(j * per, (j + 1) * per)


def _partial_sum(scene, cam, sources, rows, passes, opts):
    """This rank's share of the step: its rows of its passes, summed."""
    acc = None
    for j in passes:
        a = render_pass(scene, cam, sources[j], rows=rows, **opts)
        acc = a if acc is None else acc + a
    return acc


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` (sum) whose backward is the identity. Every rank
    computes the same loss from the summed image, and that loss counts
    once: the loss's gradient with respect to this rank's share is its
    gradient with respect to the sum. (``torch.distributed.nn``'s
    all_reduce sums the ranks' incoming gradients in its backward, which
    would scale every gradient by the number of ranks.)"""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


def sharded_render_fn(mesh: DeviceMesh, spp_per_step: int, **opts):
    """Returns ``fn(scene, cam, sources)``: the (H, W, 4) accumulation of
    ``spp_per_step`` passes, pass j drawing from ``sources[j]``, with rows
    spread over the mesh's ``rays`` dim and passes over its ``spp`` dim.
    Every rank gets the whole image. ``opts``: ``render_pass``'s keywords
    (width, height, max_depth, ...)."""
    rows, passes = _my_share(mesh, spp_per_step, opts["height"])

    @torch.no_grad()
    def fn(scene, cam, sources):
        if len(sources) != spp_per_step:
            raise ValueError(f"{len(sources)} sources for {spp_per_step} passes")
        acc = _partial_sum(scene, cam, sources, rows, passes, opts)
        dist.all_reduce(acc)
        return acc

    return fn


def sharded_train_step(mesh: DeviceMesh, spp_per_step: int, lr: float = 0.0, **opts):
    """The differentiable step over the mesh: the forward render spread as
    ``sharded_render_fn``'s, the mean squared error of its linear image
    against ``target`` (H, W, 3), and the backward on every rank over its
    own samples; the material and camera gradients are then summed over
    the ranks.

    Returns ``fn(scene, cam, sources, target) -> (loss, grad_materials,
    grad_camera)``, equal on every rank. ``lr`` is the JAX signature's; the
    step applies no update, as there."""
    rows, passes = _my_share(mesh, spp_per_step, opts["height"])

    def fn(scene, cam, sources, target):
        if len(sources) != spp_per_step:
            raise ValueError(f"{len(sources)} sources for {spp_per_step} passes")

        def loss_fn(s, c):
            accum = _SumOverRanks.apply(_partial_sum(s, c, sources, rows, passes, opts))
            return torch.mean((linear_image(accum) - target) ** 2)

        loss, (gm, gc) = loss_and_grads(loss_fn, scene, cam)
        grads = _flat(gm, gc)
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        parts = flat.split([g.numel() for g in grads])
        gm, gc = _unflat([p.reshape(g.shape) for p, g in zip(parts, grads)], gm, gc)
        return loss, gm, gc

    return fn
