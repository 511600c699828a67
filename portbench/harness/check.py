"""The comparison that decides ``correct``. Once the window has closed and
the port's state is freed, the reference (``reference/side.py``) works out
again, from the scene file and the same draws, what the sampled answers
of the timed path should be, and each number compared is held to its
limit in ``limits/<cell>.json``:

* ``accumulate``: each sampled pass's increment (the accumulation buffer
  after the pass less the one before it), over a band of ``rows`` rows
  drawn from the seed (the whole image where ``rows`` covers it; the
  filter's reach at a band's inner edges left out);
* ``viewer``: each sampled frame's image as handed to ``encode_png``,
  its camera moved and its passes accumulated again from the restart.
"""

from __future__ import annotations

import math
import random

import torch

from .loops import auto_spp, fly_camera, load, moved
from .uniforms import PathUniforms, Prefixed

ATOL, RTOL = 1e-4, 1e-3  # a value "off": |program - reference| > ATOL + RTOL |reference|


def image_numbers(p, r) -> dict:
    """``px_off``: the share of values off; ``rel_l1``: the summed absolute
    gap over the reference's summed magnitude. A non-finite value of the
    program reads as off, and makes ``rel_l1`` infinite."""
    p, r = p.double(), r.double()
    d = (p - r).abs()
    off = ~(d <= ATOL + RTOL * r.abs())
    finite = bool(torch.isfinite(p).all())
    rel = float(d.sum() / r.abs().sum().clamp_min(1e-300)) if finite else math.inf
    return dict(px_off=float(off.double().mean()), rel_l1=rel)


def _worst(acc: dict, nums: dict):
    for k, v in nums.items():
        acc[k] = max(acc.get(k, -math.inf), v)


def check_accumulate(ref, kept, cell, seed, dev, overrides=None) -> dict:
    scene, flat, cam = load(ref, cell.config, dev, overrides)
    o = scene.options
    pass_fn = ref.make_render_pass(o, auto_spp(cell.traffic["spp_per_pass"], o))
    source = PathUniforms(seed, dev)
    reach = int(math.floor(o.filter_width)) + 1
    out = {}
    items = sorted(kept, key=lambda it: it["index"])
    for item, band in zip(items, bands(cell, seed, o.height, len(items))):
        c0, c1 = 0, o.height
        if band is not None:
            c0 = band[0] + reach if band[0] > 0 else 0
            c1 = band[1] - reach if band[1] < o.height else o.height
        with torch.no_grad():
            inc_r = pass_fn(flat, cam, Prefixed(source, item["index"]), rows=band)
        inc_p = item["after"].double() - item["before"].double()
        _worst(out, image_numbers(inc_p[c0:c1], inc_r[c0:c1]))
    return out


def bands(cell, seed: int, height: int, n: int) -> list:
    """The row bands the check compares, one for each of ``n`` sampled
    passes in pass order, drawn from the seed: ``rows`` rows of
    ``limits/<cell>.json``, or None (the whole image) where they cover it."""
    rows = int(cell.limits["rows"])
    if rows >= height:
        return [None] * n
    rng = random.Random(seed ^ 0xB0A7)
    out = []
    for _ in range(n):
        y0 = rng.randrange(0, height - rows + 1)
        out.append((y0, y0 + rows))
    return out


def check_viewer(ref, kept, cell, seed, dev, overrides=None) -> dict:
    scene, flat, cam0 = load(ref, cell.config, dev, overrides)
    o, tr = scene.options, cell.traffic
    chunk = max(1, min(16, (1 << 20) // max(o.width * o.height, 1)))
    step = ref.make_accumulate_fn(o, chunk)
    source = PathUniforms(seed, dev)
    out = {}
    for item in sorted(kept, key=lambda it: it["index"]):
        fly, cam = fly_camera(ref, scene), cam0
        for _ in range(item["moves"]):
            fly.move(tr["move"])
            cam = moved(cam, fly, dev)
        with torch.no_grad():
            accum = torch.zeros((o.height, o.width, 4), dtype=torch.float32, device=dev)
            for c in range(item["passes"]):
                accum = step(accum, flat, cam, source, c)
            img = ref.resolve(accum, exposure=o.exposure, limit=o.limit)
            aovs = ref.render_aovs(flat, cam, o.width, o.height)
            img = ref.nlm_guided_denoise(img, aovs["normal"], aovs["albedo"], aovs["depth"],
                                         falloff=float(tr["nlm_falloff"]))
        _worst(out, image_numbers(item["image"], img))
    return out


def judged(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit: {name: {"value", "limit"}}."""
    return {k: dict(value=numbers[k], limit=float(limits[k])) for k in limits}


def correct(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
