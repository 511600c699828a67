"""One rank of the tests' multi-process runs of tinsel_tpu_torch/parallel,
and the helpers that start the ranks and hand them the draws.

    python tests/torch_dist_worker.py JOB.json RANK

The job names the process group (a ``file://`` rendezvous, the world size,
the backend, the device) and a list of tasks: "render" (a
``sharded_render_fn`` step), "train" (a ``sharded_train_step``) and
"pipeline" (``path_trace_pipelined`` at each ``n_micro`` given). Each rank
writes what it got to ``rank<r>.npz`` in the job's directory.

This module imports neither JAX nor tinsel_tpu: the ranks run only the
port. The tests that hold the ranks against the JAX package record the
JAX draws in the parent (``Recorder``) and hand them over in the job's
arrays, which a rank reads back with ``TableUniforms``; without a table a
rank draws from ``PathUniforms(seed)`` on its device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def draw_key(path, shape) -> str:
    return f"draw:{','.join(map(str, path))}|{','.join(map(str, shape))}"


class Recorder:
    """A source of uniforms that passes ``base``'s draws through and keeps
    them by (path, shape) in ``draws`` (the sharded paths make no integer
    draws)."""

    def __init__(self, base):
        self.base = base
        self.draws = {}

    def uniform(self, path, shape):
        x = self.base.uniform(path, shape)
        self.draws[draw_key(path, shape)] = x.numpy()
        return x


class TableUniforms:
    """The draws a ``Recorder`` kept, by (path, shape); a draw it did not
    keep raises ``KeyError``."""

    def __init__(self, arrays: dict, device):
        self.arrays = arrays
        self.device = torch.device(device)

    def uniform(self, path, shape):
        return torch.from_numpy(self.arrays[draw_key(path, shape)]).to(self.device)


def run_ranks(job: dict, world: int, workdir: Path, arrays: dict | None = None,
              timeout_s: float = 240.0) -> list:
    """Start ``world`` ranks of ``job`` in ``workdir`` and wait for all of
    them under one deadline; a rank that fails, or a run that outlives the
    deadline, raises (every rank left is killed). Each rank's output goes
    to ``rank<r>.log``. Returns each rank's results."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    job = dict(job, world=world, init=f"file://{workdir / 'rendezvous'}", out=str(workdir))
    if arrays is not None:
        np.savez(workdir / "arrays.npz", **arrays)
        job["arrays"] = str(workdir / "arrays.npz")
    (workdir / "job.json").write_text(json.dumps(job))
    paths = [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(paths))
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(workdir / "job.json"), str(r)],
                              stdout=log, stderr=subprocess.STDOUT, env=env)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                log = (workdir / f"rank{r}.log").read_text()[-3000:]
                raise RuntimeError(f"rank {r} of {world} exited {codes[r]}:\n{log}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {world} ranks ran past {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


def _scene(task, device):
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.scene import presets

    size, depth = task["size"], task["depth"]
    if task.get("scene", "cornell") == "envmesh":
        scene = presets.envmesh_scene(size, size, depth, probe=True)
    else:
        scene = presets.cornell_scene(size, size, depth)
    return scene.flatten(device), CameraParams.from_host(scene.camera, device)


def _run_task(task, source, arrays, device) -> dict:
    import dataclasses

    from tinsel_tpu_torch.core.sampling import Prefixed
    from tinsel_tpu_torch.parallel import pipeline, sharding

    name = task["name"]
    flat, cam = _scene(task, device)
    opts = dict(width=task["size"], height=task["size"], max_depth=task["depth"])
    if task["kind"] == "pipeline":
        mesh = pipeline.make_stage_mesh(task["depth"])
        o, d, t = (torch.from_numpy(arrays[k]).to(device) for k in ("rays.o", "rays.d", "rays.t"))
        return {f"{name}.n_micro{n}": pipeline.path_trace_pipelined(
                    flat, o, d, t, task["depth"], source, mesh, n_micro=n).cpu().numpy()
                for n in task["n_micro"]}
    mesh = sharding.make_mesh(spp_parallel=task["spp_parallel"])
    out = {f"{name}.mesh_shape": np.array(mesh.shape),
           f"{name}.dim_names": np.array(mesh.mesh_dim_names),
           f"{name}.coordinate": np.array(mesh.get_coordinate())}
    sources = [Prefixed(source, j) for j in range(task["passes"])]
    if task["kind"] == "render":
        fn = sharding.sharded_render_fn(mesh, task["passes"], **opts)
        out[f"{name}.image"] = fn(flat, cam, sources).cpu().numpy()
        return out
    step = sharding.sharded_train_step(mesh, task["passes"], **opts)
    target = torch.from_numpy(arrays["target"]).to(device)
    loss, gm, gc = step(flat, cam, sources, target)
    out[f"{name}.loss"] = loss.cpu().numpy()
    for prefix, obj in (("materials", gm), ("camera", gc)):
        for f in dataclasses.fields(obj):
            out[f"{name}.grad.{prefix}.{f.name}"] = getattr(obj, f.name).cpu().numpy()
    return out


def main(job_path: str, rank: int):
    import torch.distributed as dist

    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.device import resolve_device
    from tinsel_tpu_torch.parallel.sharding import init_distributed

    torch.set_num_threads(1)
    job = json.loads(Path(job_path).read_text())
    init_distributed(job["init"], job["world"], rank, backend=job["backend"])
    device = resolve_device(job["device"])
    arrays = dict(np.load(job["arrays"])) if "arrays" in job else {}
    source = (TableUniforms(arrays, device) if job.get("draws") == "table"
              else PathUniforms(job.get("seed", 0), device))
    results = {}
    try:
        for task in job["tasks"]:
            results.update(_run_task(task, source, arrays, device))
    finally:
        dist.destroy_process_group()
    np.savez(Path(job["out"]) / f"rank{rank}.npz", **results)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
