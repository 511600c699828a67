"""Faults planted under the timed path, for the tests that see ``correct``
come out false (``tests/test_portbench_checks.py``,
``tests/test_portbench_sharded.py``): a side whose entry points are broken
in one way.

* ``unchanged``: a step returns its state unchanged (a pass adds nothing);
* ``half``: half of the batch left out, the mean taken over the rest (a
  pass of half the samples, weighted twice);
* ``altered``: an answer altered where it is produced (a pass's increment
  or a frame's denoised image, scaled by 1.01);
* ``lost_share`` (cells of several cards): the exchange between cards
  loses one rank's share (the last rank's partial sum zeroed before the
  all-reduce).
"""

from __future__ import annotations

import contextlib
import types

FAULTS = ("unchanged", "half", "altered")  # what a cell of one card can have
SHARDED_FAULTS = FAULTS + ("lost_share",)
SCALE = {"half": 2.0, "altered": 1.01}  # what a broken step's increment is multiplied by


def broken(side, fault: str):
    if fault not in SHARDED_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    out = types.SimpleNamespace(**{k: getattr(side, k) for k in dir(side)
                                   if not k.startswith("__")})

    def make_accumulate_fn(options, spp=1):
        step = side.make_accumulate_fn(options, max(1, spp // 2) if fault == "half" else spp)

        def broken_step(accum, scene, cam, source, pass_idx):
            if fault == "unchanged":
                return accum
            new = step(accum, scene, cam, source, pass_idx)
            return accum + (new - accum) * SCALE.get(fault, 1.0)
        return broken_step

    def nlm_guided_denoise(*args, **kw):
        img = side.nlm_guided_denoise(*args, **kw)
        return img * 1.01 if fault == "altered" else img

    def sharded_render_fn(mesh, spp_per_step, **opts):
        if fault == "half":
            opts = dict(opts, samples_per_pass=max(1, opts["samples_per_pass"] // 2))
        fn = side.sharded_render_fn(mesh, spp_per_step, **opts)

        def broken_fn(scene, cam, sources):
            with _lost_share() if fault == "lost_share" else contextlib.nullcontext():
                inc = fn(scene, cam, sources)
            if fault == "unchanged":
                return inc.zero_()
            return inc * SCALE.get(fault, 1.0)
        return broken_fn

    out.make_accumulate_fn = make_accumulate_fn
    out.nlm_guided_denoise = nlm_guided_denoise
    if hasattr(side, "sharded_render_fn"):
        out.sharded_render_fn = sharded_render_fn
    return out


@contextlib.contextmanager
def _lost_share():
    """``torch.distributed.all_reduce`` zeroes the last rank's tensor first."""
    import torch.distributed as dist

    orig = dist.all_reduce

    def all_reduce(tensor, *a, **k):
        if dist.get_rank() == dist.get_world_size() - 1:
            tensor.zero_()
        return orig(tensor, *a, **k)

    dist.all_reduce = all_reduce
    try:
        yield
    finally:
        dist.all_reduce = orig
