"""The reference as a side: the same entry points by the same names as
``harness/port.py`` gives the port's, from the frozen copy ``tinsel_ref``.
The checks take it to compute what the port's timed path should have
produced; the control puts it in the port's place."""

from __future__ import annotations

from .fly import FlyCamera
from .sharding import make_mesh, sharded_render_fn
from .tinsel_ref.core.color import resolve
from .tinsel_ref.io.png import encode_png
from .tinsel_ref.render.aov import render_aovs
from .tinsel_ref.render.camera import CameraParams
from .tinsel_ref.render.nlm import nlm_guided
from .tinsel_ref.render.renderer import make_accumulate_fn, make_render_pass
from .tinsel_ref.scene.loaders.tin import load_tin

__all__ = ["FlyCamera", "resolve", "encode_png",
           "render_aovs", "CameraParams", "make_accumulate_fn", "make_render_pass", "load_tin",
           "nlm_guided_denoise", "make_mesh", "sharded_render_fn",
           "PACKAGE"]

PACKAGE = "reference.tinsel_ref"  # where a configuration's switches are set


def nlm_guided_denoise(img, normal, albedo, depth, **kw):
    """The guided non-local means, plain."""
    return nlm_guided(img, normal, albedo, depth, **kw)
