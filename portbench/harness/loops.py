"""The loops that drive a side (the port, or the reference put in its
place) as its users drive it. A traffic file names its loop (``loop``)
and gives its parameters; each loop keeps, from a reservoir drawn from the
run's seed, the answers that the check compares.

* ``accumulate``: progressive rendering, a closed loop of
  ``make_accumulate_fn`` steps, one pass of ``spp_per_pass`` samples a
  pixel each (``"auto"``: the renderer's own rule, at most 2**20 paths a
  pass), pass k drawing under ``Prefixed(source, k)``.
* ``viewer``: the calls of ``app/viewer.py::run_viewer`` for one
  ``pathtrace`` frame with guided denoising, in its order and without the
  HTTP server; every ``move_every``-th frame the fly camera steps forward
  and accumulation restarts, as the viewer restarts it.
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np
import torch

from .standins import scene_file
from .uniforms import PathUniforms, Prefixed

WARM_PASS = 1 << 40  # the pass index of warm-up draws: never a window's


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``:
    which items it keeps depends on the seed and the count alone."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n, self.items = int(k), random.Random(seed), 0, []

    def offer(self, item):
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = item


def auto_spp(spp, options) -> int:
    if spp == "auto":
        return max(1, (1 << 20) // max(options.width * options.height, 1))
    return int(spp)


def load(side, config: dict, dev, overrides=None):
    """(host scene, flat scene, camera) of a configuration on ``side``."""
    scene = side.load_tin(scene_file(config))
    if overrides:
        scene.options = dataclasses.replace(scene.options, **overrides)
    return scene, scene.flatten(dev), side.CameraParams.from_host(scene.camera, dev)


class Loop:
    """Set-up (load, flatten, warm-up) in the constructor; ``iterate``
    runs one unit of the traffic and returns when its result is on hand
    (synced)."""

    unit = "iteration"

    def __init__(self, side, cell, seed: int, dev, overrides=None, quiet=None):
        self.side, self.dev, self.seed = side, dev, int(seed)
        self.traffic = cell.traffic
        self.scene, self.flat, self.cam = load(side, cell.config, dev, overrides)
        self.options = self.scene.options
        kw = {} if quiet is None else dict(quiet=quiet)
        self.source = PathUniforms(seed, dev, **kw)
        self.kept = Reservoir(cell.limits.get("sample", 2), seed ^ 0x5EED)
        self.done = 0

    def sync(self):
        sync(self.dev)


class Accumulate(Loop):
    """``band``: only the samples of image rows [y0, y1) (a side with
    ``make_render_pass``: the control, whose every other row is never
    compared)."""

    unit = "pass"

    def __init__(self, side, cell, seed, dev, overrides=None, quiet=None, band=None):
        super().__init__(side, cell, seed, dev, overrides, quiet)
        o = self.options
        self.spp = auto_spp(self.traffic["spp_per_pass"], o)
        self.paths = o.width * o.height * self.spp
        self.step = side.make_accumulate_fn(o, self.spp)
        if band is not None:
            pass_fn = side.make_render_pass(o, self.spp)

            @torch.no_grad()
            def step(accum, scene, cam, source, k):
                return accum + pass_fn(scene, cam, Prefixed(source, k), rows=band)
            self.step = step
        self.accum = torch.zeros((o.height, o.width, 4), dtype=torch.float32, device=dev)
        # warm-up: one pass of the window's own shape
        self.step(self.accum, self.flat, self.cam, self.source, WARM_PASS)
        sync(dev)

    def iterate(self):
        before = self.accum
        self.accum = self.step(before, self.flat, self.cam, self.source, self.done)
        sync(self.dev)
        self.kept.offer(dict(index=self.done, before=before, after=self.accum))
        self.done += 1


def fly_camera(side, scene):
    """The viewer's fly camera at the scene's camera, its speed scaled to
    the camera's distance from the origin as ``run_viewer`` scales it."""
    return side.FlyCamera(scene.camera.position, scene.camera.rotation,
                          speed=max(0.25, 0.05 * float(np.linalg.norm(scene.camera.position))))


def moved(cam, fly, dev):
    return dataclasses.replace(cam, position=torch.as_tensor(fly.position, device=dev),
                               rotation=torch.as_tensor(fly.quat(), device=dev))


class Viewer(Loop):
    unit = "frame"

    def __init__(self, side, cell, seed, dev, overrides=None, quiet=None):
        super().__init__(side, cell, seed, dev, overrides, quiet)
        o = self.options
        self.chunk = max(1, min(16, (1 << 20) // max(o.width * o.height, 1)))
        self.paths = o.width * o.height * self.chunk
        self.step = side.make_accumulate_fn(o, self.chunk)
        self.fly = fly_camera(side, self.scene)
        self.falloff = float(self.traffic["nlm_falloff"])
        self.moves, self.c, self.aovs = 0, 0, None
        self.accum = torch.zeros((o.height, o.width, 4), dtype=torch.float32, device=dev)
        self.post = None  # per-frame host spans after the step, when timed
        # warm-up: one frame of the window's own shape, with its AOVs
        self.frame(WARM_PASS, keep=False)
        self.accum.zero_()
        self.aovs = None

    def iterate(self):
        f = self.done
        if f > 0 and f % int(self.traffic["move_every"]) == 0:
            self.fly.move(self.traffic["move"])
            self.cam = moved(self.cam, self.fly, self.dev)
            self.moves += 1
            self.aovs = None
            self.accum = torch.zeros_like(self.accum)
            self.c = 0
        self.frame(self.c)
        self.c += 1
        self.done += 1

    def frame(self, c: int, keep: bool = True):
        side, o, timed = self.side, self.options, self.post is not None
        self.accum = self.step(self.accum, self.flat, self.cam, self.source, c)
        if timed:
            spans = [_now(self.dev)]
        img = side.resolve(self.accum, exposure=o.exposure, limit=o.limit)
        if self.aovs is None:
            self.aovs = side.render_aovs(self.flat, self.cam, o.width, o.height)
        if timed:
            spans.append(_now(self.dev))
        img = side.nlm_guided_denoise(img, self.aovs["normal"], self.aovs["albedo"],
                                      self.aovs["depth"], falloff=self.falloff)
        if timed:
            spans.append(_now(self.dev))
        host = img.cpu().numpy()
        if timed:
            spans.append(_now(self.dev))
        side.encode_png(host)
        if timed:
            spans.append(_now(self.dev))
            self.post.append([b - a for a, b in zip(spans[:-1], spans[1:])])
        if keep:
            self.kept.offer(dict(index=self.done, moves=self.moves, passes=c + 1, image=img))


def _now(dev) -> float:
    sync(dev)
    return time.perf_counter()


LOOPS = {"accumulate": Accumulate, "viewer": Viewer}
