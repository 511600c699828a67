"""Faults planted under the timed path, for the tests that see ``correct``
come out false (``tests/test_portbench_checks.py``): a side whose entry
points are broken in one way.

* ``unchanged``: a step returns its state unchanged (a pass adds nothing);
* ``half``: half of the batch left out, the mean taken over the rest (a
  pass of half the samples, weighted twice);
* ``altered``: an answer altered where it is produced (a pass's increment
  or a frame's denoised image, scaled by 1.01).

The exchange between chips is not a fault these one-chip cells can have.
"""

from __future__ import annotations

import types

FAULTS = ("unchanged", "half", "altered")


def broken(side, fault: str):
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    out = types.SimpleNamespace(**{k: getattr(side, k) for k in dir(side)
                                   if not k.startswith("__")})

    def make_accumulate_fn(options, spp=1):
        step = side.make_accumulate_fn(options, max(1, spp // 2) if fault == "half" else spp)

        def broken_step(accum, scene, cam, source, pass_idx):
            if fault == "unchanged":
                return accum
            new = step(accum, scene, cam, source, pass_idx)
            return accum + (new - accum) * (2.0 if fault == "half" else 1.01)
        return broken_step

    def nlm_guided_denoise(*args, **kw):
        img = side.nlm_guided_denoise(*args, **kw)
        return img * 1.01 if fault == "altered" else img

    out.make_accumulate_fn = make_accumulate_fn
    out.nlm_guided_denoise = nlm_guided_denoise
    return out
