#!/usr/bin/env python
"""Multi-GPU rendering and one differentiable training step over a
(rays, spp) mesh of ranks (port of the JAX package's
``examples/multichip_render.py``).

Each rank renders Cornell 64x64 depth 4 in 4 chunks of ``spp_parallel``
passes through ``sharded_render_fn`` (image rows over the ``rays`` dim,
passes over ``spp``, the buffers summed over the ranks), rank 0 writes the
PNG, then every rank takes one ``sharded_train_step`` at depth 2 against
that image and rank 0 prints the loss and the gradient's size.

    PYTHONPATH=. python -m tinsel_tpu_torch.examples.multichip_render [out.png]
    PYTHONPATH=. python -m tinsel_tpu_torch.examples.multichip_render --device cpu --world 4
    PYTHONPATH=. python -m tinsel_tpu_torch.examples.multichip_render --world 2 --backend gloo

Run without torchrun's variables, it starts ``--world`` rank processes
itself (default: one per GPU, or 2 on the CPU) and waits for them; under
``torchrun`` each process is one rank. ``--device cpu`` gives gloo ranks
on the CPU. On the card the default is NCCL with one rank per GPU; more
ranks than GPUs must ask for ``--backend gloo``, whose ranks share a GPU
and sum their buffers through the host. The first line rank 0 prints says
how it ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import subprocess
import sys
import time

import torch


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default="multichip_cornell.png")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--world", type=int, default=None,
                   help="ranks to start (default: one per GPU; 2 on the CPU)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--size", type=int, default=64, help="image width and height")
    p.add_argument("--timeout", type=float, default=900.0,
                   help="seconds the ranks may run before they are killed")
    return p


def _backend(args) -> str:
    return args.backend or ("gloo" if args.device == "cpu" else "nccl")


def run_rank(args):
    """One rank: join the group from torchrun's variables, render, step."""
    import torch.distributed as dist

    from ..core.color import resolve
    from ..core.sampling import PathUniforms, Prefixed
    from ..diff.gradients import linear_image
    from ..device import resolve_device
    from ..io.png import write_png
    from ..parallel.sharding import init_distributed, make_mesh, sharded_render_fn, sharded_train_step
    from ..render.camera import CameraParams
    from ..scene.presets import cornell_scene

    backend = _backend(args)
    init_distributed(backend=backend)
    try:
        rank, world = dist.get_rank(), dist.get_world_size()
        if args.device == "cuda":
            gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
            dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', rank)) % max(gpus, 1)}")
        else:
            dev = resolve_device("cpu")
            torch.set_num_threads(1)
        spp_parallel = 2 if world % 2 == 0 else 1
        mesh = make_mesh(spp_parallel=spp_parallel)
        if rank == 0:
            if args.device == "cpu":
                how = "gloo on the CPU"
            elif backend == "nccl":
                how = "NCCL, one rank per GPU"
            else:
                how = (f"gloo: {world} rank(s) share {torch.cuda.device_count()} GPU(s), "
                       "buffers summed through the host")
            print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} over {world} rank(s), "
                  f"{how} ({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'})",
                  flush=True)

        size = args.size
        scene = cornell_scene(width=size, height=size, max_depth=4)
        flat = scene.flatten(dev)
        cam = CameraParams.from_host(scene.camera, dev)
        source = PathUniforms(0, dev)

        # forward: a few sharded multi-pass chunks
        render = sharded_render_fn(mesh, spp_parallel, width=size, height=size, max_depth=4)
        accum = torch.zeros((size, size, 4), dtype=torch.float32, device=dev)
        n_chunks = 4
        for c in range(n_chunks):
            accum = accum + render(flat, cam, [Prefixed(source, c, j) for j in range(spp_parallel)])
        if rank == 0:
            img = resolve(accum).cpu().numpy()
            write_png(args.out, img)
            print(f"rendered {n_chunks * spp_parallel} spp -> {args.out} (mean {img.mean():.3f})",
                  flush=True)

        # backward: one sharded training step (material and camera gradients)
        step = sharded_train_step(mesh, spp_parallel, width=size, height=size, max_depth=2)
        target = linear_image(accum)
        loss, gmat, _ = step(flat, cam, [Prefixed(source, 999, j) for j in range(spp_parallel)],
                             target)
        gnorm = sum(float(getattr(gmat, f.name).abs().sum()) for f in dataclasses.fields(gmat))
        if rank == 0:
            print(f"train step: loss {float(loss):.6f}, |grad_materials|_1 {gnorm:.4f}", flush=True)
    finally:
        dist.destroy_process_group()


def launch(args, argv) -> int:
    """Start ``args.world`` ranks of this script with torchrun's variables
    and wait for them; any rank that fails or runs past ``args.timeout``
    fails the run (every rank is killed). Returns the exit code."""
    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.device == "cuda" and gpus == 0:
        print("multichip_render: no CUDA device; pass --device cpu", file=sys.stderr)
        return 2
    world = args.world or (gpus if args.device == "cuda" else 2)
    if _backend(args) == "nccl" and world > gpus:
        print(f"multichip_render: NCCL needs one GPU per rank ({world} ranks, {gpus} GPU(s)); "
              "pass --backend gloo to share a GPU", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if args.device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen([sys.executable, "-m", __spec__.name, *argv], env=env))
    deadline = time.monotonic() + args.timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                print(f"multichip_render: rank {failed[0][0]} exited {failed[0][1]}",
                      file=sys.stderr)
                return 1
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                print(f"multichip_render: the ranks ran past {args.timeout} s", file=sys.stderr)
                return 1
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if "RANK" in os.environ:
        run_rank(args)
        return 0
    return launch(args, argv)


if __name__ == "__main__":
    sys.exit(main())
