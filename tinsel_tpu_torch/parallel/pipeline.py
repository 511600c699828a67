"""Pipeline parallelism: bounce stages over the ranks of a 1-D mesh (port
of ``tinsel_tpu/parallel/pipeline.py``).

Rank d of a ``stage`` mesh of ``max_depth`` ranks owns bounce d. Stage 0
cuts the ray batch into ``n_micro`` microbatches and starts them one after
another; each stage runs its bounce (``render/integrator.py::_make_bounce``,
the body ``path_trace`` loops over) on a microbatch's path state, received
from stage d - 1 with ``torch.distributed`` point-to-point ops, and sends
the result on to stage d + 1; the last stage keeps the finished radiance,
and a broadcast gives it to every rank (the JAX package's ``psum`` over
``stage``). The stages work on microbatches in order, so the sends and
receives pair up without a schedule: stage d starts microbatch m once
stage d - 1 has finished it, the GPipe fill and drain of the JAX scan.

At one microbatch the result is ``path_trace`` on the same draws; at
``n_micro`` > 1, microbatch m draws under ``Prefixed(source, m)`` (the JAX
``fold_in(key, m)``), so it equals ``path_trace`` of that microbatch under
that source. Forward only, as every caller of the JAX function.

Transport: NCCL sends CUDA tensors between GPUs. Gloo's send and receive
read and write host memory only, so with gloo a CUDA state is staged
through pinned host buffers (the ranks of one shared GPU).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.sampling import Prefixed
from ..render.integrator import _initial_state, _make_bounce
from ..scene.model import SceneFlat

# the path state's fields and widths, packed into one (R, 19) f32 message;
# rtype (small ints) and alive (0 / 1) are exact in f32
_FIELDS = (("o", 3), ("d", 3), ("eta", 1), ("absorb", 3), ("rtype", 1), ("bpdf", 1),
           ("thr", 3), ("rad", 3), ("alive", 1))
_WIDTH = sum(w for _, w in _FIELDS)


def make_stage_mesh(n_stages: int) -> DeviceMesh:
    """The 1-D ``stage`` mesh over the process group's ranks, whose size
    must be ``n_stages``."""
    n = dist.get_world_size()
    if n != n_stages:
        raise ValueError(f"a {n_stages}-stage mesh in a process group of {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_stages,), mesh_dim_names=("stage",))


def _pack(st) -> torch.Tensor:
    cols = [st[k].to(torch.float32).reshape(st[k].shape[0], w) for k, w in _FIELDS]
    return torch.cat(cols, dim=1)


def _unpack(buf):
    st, c = {}, 0
    for k, w in _FIELDS:
        col = buf[:, c:c + w]
        st[k] = col if w > 1 else col[:, 0]
        c += w
    st["rtype"] = st["rtype"].to(torch.int32)
    st["alive"] = st["alive"] > 0.5
    return st


class _Link:
    """Sends and receives path state between stages: CUDA tensors through
    pinned host buffers under gloo, directly otherwise. ``send`` returns at
    once; the next send, and ``close``, wait for the one before."""

    def __init__(self, shape, device):
        self.device = device
        self.staged = dist.get_backend() == "gloo" and device.type == "cuda"
        kw = dict(dtype=torch.float32)
        if self.staged:
            self.out = torch.empty(shape, pin_memory=True, **kw)
            self.inp = torch.empty(shape, pin_memory=True, **kw)
        else:
            self.inp = torch.empty(shape, device=device, **kw)
        self.pending = None

    def send(self, buf, dst: int):
        self.close()
        if self.staged:
            self.out.copy_(buf)  # synchronous: the host buffer holds the state
            buf = self.out
        self.pending = dist.isend(buf, dst)

    def recv(self, src: int):
        dist.recv(self.inp, src)
        return self.inp.to(self.device) if self.staged else self.inp.clone()

    def close(self):
        if self.pending is not None:
            self.pending.wait()
            self.pending = None


@torch.no_grad()
def path_trace_pipelined(scene: SceneFlat, origins, dirs, times, max_depth: int, source,
                         mesh: DeviceMesh, n_micro: int = 1):
    """Pipelined path trace: returns the (R, 3) radiance on every rank.

    Every rank passes the same batch (origins, dirs (R, 3), times (R,)) and
    ``source``; the mesh has one stage per bounce (``max_depth`` ranks),
    and R % n_micro == 0."""
    n_stages = mesh.shape[0]
    if n_stages != max_depth:
        raise ValueError(f"{n_stages} stages for depth {max_depth}: one stage a bounce")
    r = origins.shape[0]
    if r % n_micro:
        raise ValueError(f"{r} rays do not split into {n_micro} microbatches")
    micro = r // n_micro
    stage = mesh.get_coordinate()[0]
    ranks = mesh.mesh.flatten().tolist()
    link = _Link((micro, _WIDTH), origins.device)
    out = torch.zeros((r, 3), dtype=torch.float32, device=origins.device)
    for m in range(n_micro):
        lanes = slice(m * micro, (m + 1) * micro)
        if stage == 0:
            st = _initial_state(origins[lanes], dirs[lanes])
        else:
            st = _unpack(link.recv(ranks[stage - 1]))
        src = Prefixed(source, m) if n_micro > 1 else source
        st = _make_bounce(scene, times[lanes], src, micro)(st, stage)
        if stage == n_stages - 1:
            out[lanes] = st["rad"]
        else:
            link.send(_pack(st), ranks[stage + 1])
    link.close()
    dist.broadcast(out, ranks[-1])
    return out
