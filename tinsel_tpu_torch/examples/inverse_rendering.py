#!/usr/bin/env python
"""Inverse rendering: recover material colors by gradient descent (port of
the JAX package's ``examples/inverse_rendering.py``).

Renders a target Cornell box, perturbs the material colors, then fits them
with Adam so that re-rendered images match the target. Each step's loss is
the product of two independent renders' residuals, E[(x1 - t)(x2 - t)] =
(E[x] - t)^2, so its gradient is unbiased (the MSE of one noisy render
would also penalise the estimator's variance and drive colors dark).

    PYTHONPATH=. python -m tinsel_tpu_torch.examples.inverse_rendering --steps 60
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..core.sampling import PathUniforms, Prefixed
from ..device import resolve_device
from ..diff.gradients import linear_image
from ..render.camera import CameraParams
from ..render.renderer import render_pass
from ..scene.presets import cornell_scene


def main(steps: int = 60, size: int = 64, spp_target: int = 8, seed: int = 0,
         device=None, source=None, max_depth: int = 3):
    """Returns (err0, err1): the mean color error of the visible (non-
    emissive) materials before and after ``steps`` Adam steps. The target
    averages ``spp_target`` one-sample passes (the JAX example averages 8).
    ``source``: a UniformSource (default: ``PathUniforms(seed)``);
    ``max_depth``: bounces (the JAX example renders at 3)."""
    dev = resolve_device(device)
    scene = cornell_scene(width=size, height=size, max_depth=max_depth)
    flat = scene.flatten(dev)
    cam = CameraParams.from_host(scene.camera, dev)
    if source is None:
        source = PathUniforms(seed, dev)
    opts = dict(width=size, height=size, max_depth=max_depth)

    def one_pass(color, src):
        mats = dataclasses.replace(flat.materials, color=color)
        return linear_image(render_pass(dataclasses.replace(flat, materials=mats), cam, src,
                                        **opts))

    true_color = flat.materials.color
    with torch.no_grad():
        target = torch.stack(
            [one_pass(true_color, Prefixed(source, i)) for i in range(spp_target)]
        ).mean(dim=0)

    # corrupt the colors, then recover them
    noise = np.random.default_rng(seed + 99).uniform(-0.3, 0.3, tuple(true_color.shape))
    color = torch.clamp(
        true_color + torch.as_tensor(noise, dtype=torch.float32, device=dev), 0.02, 0.98
    ).requires_grad_(True)

    # emitters' color is invisible (pure emission): left out of the error
    seen = flat.materials.emission.max(dim=-1).values <= 0.0

    def err_of(c):
        e = (c.detach() - true_color).abs().max(dim=-1).values
        return float(torch.where(seen, e, 0.0).sum() / torch.clamp(seen.sum(), min=1))

    opt = torch.optim.Adam([color], lr=2e-2)
    # optax.exponential_decay(2e-2, 20, 0.5), not staircase
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda step: 0.5 ** (step / 20))
    err0 = err_of(color)
    for i in range(steps):
        k = Prefixed(source, 1000 + i)
        img1 = one_pass(color, Prefixed(k, 0))
        img2 = one_pass(color, Prefixed(k, 1))
        loss = torch.mean((img1 - target) * (img2 - target))
        opt.zero_grad()
        loss.backward()
        opt.step()
        sched.step()
        with torch.no_grad():
            color.clamp_(0.0, 1.0)
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:3d}  loss {float(loss.detach()):+.6f}  mean albedo err {err_of(color):.4f}")
    err1 = err_of(color)
    print(f"mean albedo error (visible materials): {err0:.4f} -> {err1:.4f}")
    return err0, err1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(steps=args.steps, size=args.size, seed=args.seed, device=args.device)
