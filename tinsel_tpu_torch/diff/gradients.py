"""Differentiable rendering: loss and gradients with respect to the
material table and the camera (port of ``tinsel_tpu/diff/gradients.py``).

The render pass is differentiable end to end under torch autograd: the
BVH walks and the other discrete searches run without gradient and the
winning hit is re-intersected with torch ops (``render/trace.py``);
material parameters flow through the BSDF, its pdfs and the MIS weights.
Autograd keeps its saved tensors for the backward; the JAX package's
remat and unroll knobs (``integrator.py:59-81``) tune XLA's scheduling
and have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.sampling import Prefixed
from ..render.renderer import render_pass


def linear_image(accum):
    """Resolve an RGBA accumulation buffer to a linear radiance image."""
    w = torch.clamp(accum[..., 3:4], min=1e-6)
    return accum[..., :3] / w


def render_loss(scene, cam, source, target, **opts):
    """Mean squared error of one pass's linear image against ``target``.
    ``source``: the UniformSource of the pass; ``opts``: ``render_pass``'s
    keywords (width, height, max_depth, ...)."""
    img = linear_image(render_pass(scene, cam, source, **opts))
    return torch.mean((img - target) ** 2)


def _leaves(obj):
    """A copy of the dataclass ``obj`` whose fields are fresh leaves that
    require grad."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).detach().clone().requires_grad_(True)
        for f in dataclasses.fields(obj)
    })


def _flat(*objs):
    return [getattr(o, f.name) for o in objs for f in dataclasses.fields(o)]


def _unflat(values, *templates):
    """The inverse of ``_flat``: copies of ``templates`` holding ``values``."""
    out, i = [], 0
    for t in templates:
        names = [f.name for f in dataclasses.fields(t)]
        out.append(dataclasses.replace(t, **dict(zip(names, values[i:i + len(names)]))))
        i += len(names)
    return out


def loss_and_grads(loss_fn, scene, cam):
    """(loss, (grad_materials, grad_camera)) of ``loss_fn(scene, cam)``,
    a scalar, with respect to ``scene.materials`` and ``cam``: the gradients
    as a ``MaterialsFlat`` and a ``CameraParams`` (zero where a field does
    not reach the loss)."""
    mats, cam_l = _leaves(scene.materials), _leaves(cam)
    with torch.enable_grad():
        loss = loss_fn(dataclasses.replace(scene, materials=mats), cam_l)
        leaves = _flat(mats, cam_l)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    g_mats, g_cam = _unflat(grads, mats, cam_l)
    return loss.detach(), (g_mats, g_cam)


def render_loss_and_grads(scene, cam, source, target, **opts):
    """Returns (loss, (grad_materials, grad_camera)): the loss of
    ``render_loss`` and its gradients (``loss_and_grads``)."""
    return loss_and_grads(
        lambda s, c: render_loss(s, c, source, target, **opts), scene, cam)


def render_loss_and_grads_scan(scene, cam, source, target, n_chunks: int, **opts):
    """Gradient accumulation: ``n_chunks`` independent
    ``render_loss_and_grads`` evaluations, chunk c drawing under
    ``Prefixed(source, c)`` (the JAX ``fold_in(key, c)``). Returns the
    mean loss and the mean gradients."""
    total_l, total_g = 0.0, None
    for c in range(n_chunks):
        loss, (gm, gc) = render_loss_and_grads(scene, cam, Prefixed(source, c), target, **opts)
        total_l = total_l + loss
        flat = _flat(gm, gc)
        total_g = flat if total_g is None else [a + b for a, b in zip(total_g, flat)]
    n = float(n_chunks)
    g_mats, g_cam = _unflat([g / n for g in total_g], gm, gc)
    return total_l / n, (g_mats, g_cam)
