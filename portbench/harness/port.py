"""The program under test, ``tinsel_tpu_torch``: the only module of the
benchmark that imports it. It hands the loops the port's entry points and
the counters its kernel wrappers keep."""

from __future__ import annotations

from tinsel_tpu_torch.app.viewer import FlyCamera
from tinsel_tpu_torch.core.color import resolve
from tinsel_tpu_torch.device import resolve_device
from tinsel_tpu_torch.io.png import encode_png
from tinsel_tpu_torch.ops import bvh as ops_bvh
from tinsel_tpu_torch.ops import instances as ops_instances
from tinsel_tpu_torch.ops import nlm as ops_nlm
from tinsel_tpu_torch.ops import sweep as ops_sweep
from tinsel_tpu_torch.ops.nlm import nlm_guided_denoise
from tinsel_tpu_torch.render import integrator, lights
from tinsel_tpu_torch.render.aov import render_aovs
from tinsel_tpu_torch.render.camera import CameraParams
from tinsel_tpu_torch.render.renderer import make_accumulate_fn
from tinsel_tpu_torch.scene.loaders.tin import load_tin

__all__ = [
    "FlyCamera", "resolve", "resolve_device",
    "encode_png", "nlm_guided_denoise", "integrator", "lights", "render_aovs",
    "CameraParams", "make_accumulate_fn", "load_tin", "ops_sweep", "ops_bvh", "launch_counts",
]

# the launch counters of the port's kernel wrappers (one per kernel)
COUNTERS = (ops_sweep, ops_bvh, ops_instances, ops_nlm)


def launch_counts() -> dict:
    return {k: v for mod in COUNTERS for k, v in mod.launch_counts.items()}
