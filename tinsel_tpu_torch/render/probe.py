"""Sky radiance for escaped rays (port of the gradient-sky branch of
``tinsel_tpu/render/probe.py:95-101``). HDR probes are ported in slice 4:
``Scene.flatten`` refuses them, so a ``SceneFlat`` here never has one."""

from __future__ import annotations

import torch


def sky_eval(scene, d):
    """Horizon -> zenith gradient on sqrt(|dir.y|)."""
    t = torch.sqrt(torch.abs(d[..., 1]))[..., None]
    return scene.sky_horizon + (scene.sky_zenith - scene.sky_horizon) * t
