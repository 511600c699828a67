"""(c) Statistical parity of the port against the committed reference
renders (tests/goldens/ref_*.pfm, rendered once by the C++ reference's CPU
path tracer), with tests/test_reference_parity.py's cases, region metric
and tolerances: the global mean ratio, and each of a 4x4 grid of region
means against the brighter of the region's and the image's mean.

The port's sampler draws other numbers than the JAX package's, so these
hold the two renderers to the same reference, not to each other. The file
imports neither JAX nor tinsel_tpu: it renders on the card where there is
one (``python -m pytest --noconftest -m slow tests/test_torch_reference_parity.py``
there), else on the CPU. Scenes whose assets lie outside the repository
skip, as in test_reference_parity.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.io.hdr import load_pfm
from tinsel_tpu_torch.render.renderer import render
from tinsel_tpu_torch.scene.loaders.tin import load_tin

pytestmark = pytest.mark.slow  # heavy end-to-end tier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_DATA = os.path.join(os.path.dirname(ROOT), "reference", "data")

CASES = [
    # (scene, golden, spp, w, h, ratio_tol, region_tol): as
    # tests/test_reference_parity.py:34-97
    ("scenes/simple.tin", "tests/goldens/ref_simple_128x64_s256.pfm", 256, 128, 64, 0.02, 0.03),
    ("tests/data/cornell_parity.tin", "tests/goldens/ref_cornell_64x64_s128.pfm",
     128, 64, 64, 0.025, 0.08),
    ("scenes/gloss.tin", "tests/goldens/ref_gloss_96x64_s128.pfm", 128, 96, 64, 0.02, 0.05),
    ("tests/data/meshlight_parity.tin", "tests/goldens/ref_meshlight_96x64_s128.pfm",
     128, 96, 64, 0.02, 0.04),
    ("tests/data/env_parity.tin", "tests/goldens/ref_env_96x64_s512.pfm", 512, 96, 64, 0.02, 0.03),
    ("tests/data/glass_parity.tin", "tests/goldens/ref_glass_64x64_s512.pfm",
     512, 64, 64, 0.025, 0.05),
    ("scenes/veach.tin", "tests/goldens/ref_veach_96x96_s256.pfm", 256, 96, 96, 0.02, 0.03),
    ("tests/data/cornell_parity.tin", "tests/goldens/ref_cornell_128x128_s256.pfm",
     256, 128, 128, 0.01, 0.03),
]
IDS = ["simple", "cornell", "gloss", "meshlight", "env", "glass", "veach", "cornell_midres"]
NEEDS_REFERENCE_DATA = {"meshlight", "env"}


@pytest.mark.parametrize("scene_path,golden,spp,w,h,ratio_tol,region_tol", CASES, ids=IDS)
def test_reference_parity(request, scene_path, golden, spp, w, h, ratio_tol, region_tol):
    if request.node.callspec.id in NEEDS_REFERENCE_DATA and not os.path.isdir(REFERENCE_DATA):
        pytest.skip("reads assets of the reference tree, which is not beside the repository")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    ref = load_pfm(os.path.join(ROOT, golden))[::-1]  # bottom-up scanlines
    sc = load_tin(os.path.join(ROOT, scene_path))
    opts = dataclasses.replace(sc.options, width=w, height=h)
    acc = render(sc, spp=spp, options=opts, device=device).cpu().numpy()
    img = acc[..., :3] / np.maximum(acc[..., 3:4], 1e-7)

    ratio = float(img.mean() / ref.mean())
    assert abs(ratio - 1.0) < ratio_tol, f"global mean ratio {ratio:.4f}"
    rh, rw = h // 4, w // 4
    for by in range(4):
        for bx in range(4):
            r_m = ref[by * rh:(by + 1) * rh, bx * rw:(bx + 1) * rw].mean()
            o_m = img[by * rh:(by + 1) * rh, bx * rw:(bx + 1) * rw].mean()
            err = abs(o_m - r_m) / max(float(ref.mean()), float(r_m), 1e-9)
            assert err < region_tol, (
                f"region ({by},{bx}): ours {o_m:.4f} vs ref {r_m:.4f} (err {err:.4f})")
