"""The port's sharded render (tinsel_tpu_torch/parallel/sharding.py) on the
card: a world-1 NCCL rank and two gloo ranks sharing the GPU, each held
against the unsharded sum of the same passes on the card (rtol 2e-5, atol
2e-6, tests/test_sharding.py:78). The ranks run in their own processes
(tests/torch_dist_worker.py) and draw from ``PathUniforms`` on the card.
Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_sharding_cuda.py
"""

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.core.sampling import PathUniforms, Prefixed
from tinsel_tpu_torch.device import resolve_device
from tinsel_tpu_torch.render.camera import CameraParams
from tinsel_tpu_torch.render.renderer import render_pass
from tinsel_tpu_torch.scene import presets

from torch_dist_worker import run_ranks

SIZE = 64
DEPTH = 4
PASSES = 2
SEED = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the sharded ranks run on the card)")
    return resolve_device("cuda:0")


def unsharded(scene_name, dev):
    sc = (presets.envmesh_scene(SIZE, SIZE, DEPTH, probe=True) if scene_name == "envmesh"
          else presets.cornell_scene(SIZE, SIZE, DEPTH))
    flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
    src = PathUniforms(SEED, dev)
    opts = dict(width=SIZE, height=SIZE, max_depth=DEPTH)
    with torch.no_grad():
        return sum(render_pass(flat, cam, Prefixed(src, j), **opts)
                   for j in range(PASSES)).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("world,backend,spp_parallel,scene", [
    (1, "nccl", 1, "cornell"),
    (2, "gloo", 1, "cornell"),
    (2, "gloo", 2, "cornell"),
    (2, "gloo", 1, "envmesh"),
])
def test_sharded_render_on_the_card_matches_unsharded(cuda, tmp_path, world, backend,
                                                      spp_parallel, scene):
    job = dict(backend=backend, device="cuda:0", seed=SEED, tasks=[
        dict(kind="render", name="render", scene=scene, size=SIZE, depth=DEPTH, passes=PASSES,
             spp_parallel=spp_parallel)])
    ranks = run_ranks(job, world, tmp_path)
    want = unsharded(scene, cuda)
    assert want[..., :3].mean() > 1e-3
    for r in ranks:
        assert tuple(r["render.mesh_shape"]) == (world // spp_parallel, spp_parallel)
        np.testing.assert_allclose(r["render.image"], want, rtol=2e-5, atol=2e-6)
