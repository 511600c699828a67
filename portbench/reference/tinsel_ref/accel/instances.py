"""The batch of big-mesh instances that a trace call walks together (at
most ``render/trace.py::INSTANCE_TOPK_MIN`` of them): the instances'
primitives, offsets and root boxes (``batch``), and each (instance, ray)
lane's local ray and root-box entry (``world_inputs``), with the formulas
the port's kernels hold bit for bit (``accel/sweep.py``)."""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.intersect import INF
from .sweep import box_entry, layout, lerp_transform, local_ray


@dataclasses.dataclass(frozen=True)
class Batch:
    """A scene's big-mesh primitives, in batch order, on one device."""

    prims: tuple  # the instances' primitive ids
    prim_ids: torch.Tensor  # the same (I,) int64
    motion: bool  # every instance takes its transform at the ray's time
    slots: int  # the batch's stack bound
    lower: torch.Tensor  # (I, 3) f32 root boxes in each mesh's frame
    upper: torch.Tensor
    noff: torch.Tensor  # (I,) int32 node and triangle offsets into the pool
    toff: torch.Tensor


def batch(scene, dev, hoist: bool = True) -> Batch:
    """The batch of ``scene``'s big meshes (``accel/sweep.py::layout(...)
    .big``). ``motion``: every instance is interpolated at the ray's time
    when the hoist is off or some instance of the batch moves, else each
    takes its start transform."""
    prims = tuple(layout(scene.prim_static, hoist).big)
    handles = [scene.prim_static[i].mesh for i in prims]

    def col(xs, dtype):
        return torch.tensor(xs, dtype=dtype, device=dev)

    return Batch(prims=prims, prim_ids=col(prims, torch.long),
                 motion=bool(prims) and (not hoist or any(scene.prim_static[i].motion
                                                          for i in prims)),
                 slots=max((h.stack_slots for h in handles), default=1),
                 lower=col([h.root_lower for h in handles], torch.float32).reshape(-1, 3),
                 upper=col([h.root_upper for h in handles], torch.float32).reshape(-1, 3),
                 noff=col([h.node_offset for h in handles], torch.int32),
                 toff=col([h.tri_offset for h in handles], torch.int32))


def world_inputs(scene, tab: Batch, origins, dirs, times, tmax):
    """Each (instance, ray) lane's inputs from world rays: each instance's
    transform at the ray's time where ``tab.motion``, else its start
    transform; the ray in its frame; its root-box entry, +inf where the box
    is missed or entered at or beyond tmax (R,). Returns the (I, R, 3)
    local origins and directions and the (I, R) entries."""
    pr = scene.prims

    def rows(x):  # (I, 1) columns of primitive rows
        x = x.detach()[tab.prim_ids]
        return tuple(x[:, k:k + 1] for k in range(x.shape[1])) if x.dim() == 2 else x[:, None]

    p, q, s = rows(pr.start_p), rows(pr.start_q), rows(pr.start_s)
    if tab.motion:
        p, q, s = lerp_transform(p, q, s, rows(pr.end_p), rows(pr.end_q), rows(pr.end_s),
                                 times[None, :])
    o_l, d_l = local_ray(p, q, s, tuple(c[None, :] for c in origins.unbind(-1)),
                         tuple(c[None, :] for c in dirs.unbind(-1)))
    lo, hi = tab.lower.unbind(-1), tab.upper.unbind(-1)
    may, tn = box_entry(tuple(c[:, None] for c in lo), tuple(c[:, None] for c in hi), o_l, d_l,
                        tmax[None, :])
    return torch.stack(o_l, -1), torch.stack(d_l, -1), torch.where(may, tn, INF)
