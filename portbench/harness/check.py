"""The comparison that decides ``correct``. Once the window has closed and
the port's state is freed, the reference (``reference/side.py``) works out
again, from the scene file and the same draws, what the sampled answers
of the timed path should be, and each number compared is held to its
limit in ``limits/<cell>.json``:

* ``accumulate``, ``sharded``: each sampled pass's (step's) increment
  (the accumulation buffer after it less the one before it), against the
  reference's unsharded passes of the same draws summed, over a band of
  ``rows`` rows drawn from the seed (the whole image where ``rows`` covers
  it; the filter's reach at a band's inner edges left out). With
  ``"straddle": true`` the band's compared rows lie on both sides of a
  boundary between the mesh's row bands, with the rows within the filter's
  reach of it, where two ranks' splats meet in the all-reduce;
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
    r = reach(o)
    out = {}
    items = sorted(kept, key=lambda it: it["index"])
    for item, band in zip(items, bands(cell, seed, o.height, len(items), r)):
        c0, c1 = 0, o.height
        if band is not None:
            c0 = band[0] + r if band[0] > 0 else 0
            c1 = band[1] - r if band[1] < o.height else o.height
        inc_r = None
        with torch.no_grad():
            for draw in item.get("draws", [(item["index"],)]):
                inc = pass_fn(flat, cam, Prefixed(source, *draw), rows=band)
                inc_r = inc if inc_r is None else inc_r + inc
        inc_p = item["after"].double() - item["before"].double()
        _worst(out, image_numbers(inc_p[c0:c1], inc_r[c0:c1]))
    return out


def reach(options) -> int:
    """Rows beyond its own that a sample's splat reaches."""
    return int(math.floor(options.filter_width)) + 1


def bands(cell, seed: int, height: int, n: int, reach: int | None = None) -> list:
    """The row bands the check compares, one for each of ``n`` sampled
    passes in pass order, drawn from the seed: ``rows`` rows of
    ``limits/<cell>.json``, or None (the whole image) where they cover it.
    With ``straddle``, each band's compared rows (its rows less ``reach`` at
    each end) hold the ``reach`` rows on each side of a boundary between the
    mesh's row bands, drawn from the seed too."""
    rows = int(cell.limits["rows"])
    if rows >= height:
        return [None] * n
    rng = random.Random(seed ^ 0xB0A7)
    n_rays = int(cell.traffic["mesh"][0]) if cell.limits.get("straddle") else 1
    edges = [height * i // n_rays for i in range(1, n_rays)]  # the row bands' first rows
    if edges and reach is None:
        raise ValueError("a straddling band needs the filter's reach")
    out = []
    for _ in range(n):
        lo, hi = 0, height - rows
        if edges:
            b = edges[rng.randrange(len(edges))]
            lo, hi = max(lo, b + 2 * reach - rows), min(hi, b - 2 * reach)
            if lo > hi:
                raise ValueError(f"{rows} rows cannot straddle row {b} with a reach of {reach}")
        y0 = rng.randrange(lo, hi + 1)
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
