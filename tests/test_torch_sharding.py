"""The port's multi-GPU data parallelism (tinsel_tpu_torch/parallel/sharding.py)
on the CPU: gloo ranks in their own processes (tests/torch_dist_worker.py,
which imports neither JAX nor tinsel_tpu), held against the port's
unsharded render and step and against the JAX package at equal draws.

The ranks read the JAX draws of the passes, recorded here by running the
port's unsharded pass on them (``Recorder``). Meshes: world 2 as (rays 2,
spp 1), world 4 as (rays 2, spp 2). Limits: the sharded image against the
unsharded sum rtol 2e-5, atol 2e-6, the loss rtol 1e-4 and the gradients
rtol 2e-3, atol 2e-5 (tests/test_sharding.py:78, :98-104); against the JAX
``render_pass`` sum ``assert_pass_matches``.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.render.renderer import render_pass as jrender_pass
from tinsel_tpu.scene.presets import dryrun_scene as jdryrun
from tinsel_tpu_torch.core.sampling import Lanes, NumpyUniforms, Prefixed
from tinsel_tpu_torch.diff.gradients import linear_image, loss_and_grads
from tinsel_tpu_torch.parallel import sharding
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.render.renderer import render_pass
from tinsel_tpu_torch.scene.presets import cornell_scene as tcornell
from tinsel_tpu_torch.scene.presets import dryrun_scene as tdryrun

from torch_dist_worker import Recorder, run_ranks
from torch_parity import JaxUniforms, assert_pass_matches

torch.set_num_threads(2)
W = H = 16
DEPTH = 2
PASSES = 2
OPTS = dict(width=W, height=H, max_depth=DEPTH)
KEY = 7
TARGET = np.full((H, W, 3), 0.2, np.float32)
MESHES = {2: 1, 4: 2}  # world -> spp_parallel
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def reference():
    """The unsharded step at equal draws: the JAX passes under
    fold_in(key, j), the port's passes and loss with gradients reading the
    same draws, and the draws themselves."""
    key = jax.random.key(KEY)
    js = jdryrun(W, H)
    jflat, jcam = js.flatten(), JCam.from_host(js.camera)
    jpass = jax.jit(lambda s, c, k: jrender_pass(s, c, k, **OPTS))
    jaccum = sum(np.array(jpass(jflat, jcam, jax.random.fold_in(key, j))) for j in range(PASSES))
    # tests/test_sharding.py:89-93's loss_fn at (flat.materials, cam)
    img = jaccum[..., :3] / jnp.maximum(jaccum[..., 3:4], 1e-6)
    jloss = float(jnp.mean((img - TARGET) ** 2))

    ts = tdryrun(W, H)
    tflat, tcam = ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu")
    rec = Recorder(JaxUniforms(key))
    sources = [Prefixed(rec, j) for j in range(PASSES)]
    taccum = sum(render_pass(tflat, tcam, s, **OPTS) for s in sources)
    target = torch.from_numpy(TARGET)

    def loss_fn(s, c):
        accum = sum(render_pass(s, c, src, **OPTS) for src in sources)
        return torch.mean((linear_image(accum) - target) ** 2)

    loss, (gm, gc) = loss_and_grads(loss_fn, tflat, tcam)
    grads = {f"materials.{f.name}": getattr(gm, f.name).numpy() for f in dataclasses.fields(gm)}
    grads.update({f"camera.{f.name}": getattr(gc, f.name).numpy() for f in dataclasses.fields(gc)})
    return dict(jax_accum=jaccum, jax_loss=jloss, accum=taccum.numpy(), loss=float(loss),
                grads=grads, draws=rec.draws)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Each world's ranks: a sharded render and a sharded train step on the
    recorded draws. {world: [rank results]}"""
    out = {}
    for world, spp in MESHES.items():
        job = dict(backend="gloo", device="cpu", draws="table", tasks=[
            dict(kind="render", name="render", size=W, depth=DEPTH, passes=PASSES,
                 spp_parallel=spp),
            dict(kind="train", name="train", size=W, depth=DEPTH, passes=PASSES,
                 spp_parallel=spp),
        ])
        arrays = dict(reference["draws"], target=TARGET)
        out[world] = run_ranks(job, world, tmp_path_factory.mktemp(f"world{world}"), arrays)
    return out


@pytest.mark.parametrize("world", sorted(MESHES))
def test_make_mesh_shape_and_dim_names(ranks, world):
    spp = MESHES[world]
    coords = set()
    for r in ranks[world]:
        assert tuple(r["render.mesh_shape"]) == (world // spp, spp)
        assert tuple(r["render.dim_names"]) == ("rays", "spp")
        coords.add(tuple(r["render.coordinate"]))
    assert coords == {(i, j) for i in range(world // spp) for j in range(spp)}


@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_render_matches_the_unsharded_sum(ranks, reference, world):
    for r in ranks[world]:
        np.testing.assert_allclose(r["render.image"], reference["accum"], rtol=2e-5, atol=2e-6)
    assert reference["accum"][..., :3].mean() > 1e-3


@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_render_matches_jax(ranks, reference, world):
    images = [r["render.image"] for r in ranks[world]]
    assert all(np.array_equal(images[0], im) for im in images)  # replicated
    assert_pass_matches(reference["jax_accum"], images[0])


@pytest.mark.parametrize("world", sorted(MESHES))
def test_sharded_train_step_matches_unsharded(ranks, reference, world):
    """Loss and every gradient leaf equal on every rank and equal to the
    unsharded step's: a gradient scaled by the world size (an all_reduce
    whose backward sums) fails here at world 2 and 4."""
    first = ranks[world][0]
    for r in ranks[world]:
        np.testing.assert_allclose(float(r["train.loss"]), reference["loss"], rtol=1e-4)
        for name, g in reference["grads"].items():
            np.testing.assert_array_equal(r[f"train.grad.{name}"], first[f"train.grad.{name}"])
            np.testing.assert_allclose(r[f"train.grad.{name}"], g, rtol=2e-3, atol=2e-5,
                                       err_msg=name)
    assert np.abs(reference["grads"]["materials.color"]).max() > 1e-3


def test_unsharded_loss_matches_jax(reference):
    """The port's unsharded loss against tests/test_sharding.py's loss_fn at
    equal draws; the images differ only where assert_pass_matches allows."""
    assert abs(reference["loss"] - reference["jax_loss"]) <= 1e-3 * reference["jax_loss"]


def test_nccl_with_too_few_gpus_raises():
    """One GPU per rank or no NCCL: with fewer GPUs than ranks (none here)
    the call raises before it joins a group."""
    with pytest.raises(ValueError, match="one GPU per rank"):
        sharding.init_distributed("127.0.0.1:1", 2, 1, backend="nccl")
    assert not dist.is_initialized()


@pytest.fixture
def world_of_one(tmp_path):
    sharding.init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_renders_the_unsharded_sum(world_of_one):
    mesh = sharding.make_mesh()
    assert tuple(mesh.shape) == (1, 1) and tuple(mesh.get_coordinate()) == (0, 0)
    ts = tcornell(W, H, 3)
    flat, cam = ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu")
    opts = dict(width=W, height=H, max_depth=3)
    sources = [Prefixed(NumpyUniforms(5, "cpu"), j) for j in range(3)]
    got = sharding.sharded_render_fn(mesh, 3, **opts)(flat, cam, sources)
    want = sum(render_pass(flat, cam, s, **opts) for s in sources)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-6)


def test_make_mesh_rejects_a_bad_split(world_of_one):
    with pytest.raises(ValueError, match="process group of 1"):
        sharding.make_mesh(2)
    with pytest.raises(ValueError, match="spp groups of 2"):
        sharding.make_mesh(spp_parallel=2)
    mesh = sharding.make_mesh()
    with pytest.raises(ValueError, match="sources for 2 passes"):
        sharding.sharded_render_fn(mesh, 2, **OPTS)(None, None, [None])


@pytest.mark.parametrize("mode", ["pathtrace", "normals"])
@pytest.mark.parametrize("spp,filter_type,bands", [
    (1, "gaussian", ((0, 5), (5, 11), (11, 16))),
    (2, "box", ((0, 8), (8, 16))),
])
def test_row_bands_sum_to_the_whole_pass(mode, spp, filter_type, bands):
    """render_pass(rows=...) over bands that cover the image sums to the
    whole pass: each band's samples are the pass's (its lanes of the
    whole-shape draws) and its splat reaches the rows beyond it."""
    ts = tcornell(W, H, 3)
    flat, cam = ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu")
    opts = dict(width=W, height=H, max_depth=3, samples_per_pass=spp, filter_type=filter_type,
                filter_width=1.5, mode=mode)
    src = NumpyUniforms(11, "cpu")
    whole = render_pass(flat, cam, src, **opts)
    parts = sum(render_pass(flat, cam, src, rows=b, **opts) for b in bands)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=2e-5, atol=2e-6)
    with pytest.raises(ValueError, match="not a band"):
        render_pass(flat, cam, src, rows=(4, 4), **opts)


def test_lanes_draw_the_whole_batch_and_keep_their_rows():
    base = NumpyUniforms(3, "cpu")
    idx = torch.tensor([5, 0, 7])
    lanes = Lanes(Prefixed(base, 2), idx, 8)
    np.testing.assert_array_equal(lanes.uniform((1, 4), (3, 2)).numpy(),
                                  base.uniform((2, 1, 4), (8, 2))[idx].numpy())
    np.testing.assert_array_equal(lanes.randint((9,), (3,), 0, 5).numpy(),
                                  base.randint((2, 9), (8,), 0, 5)[idx].numpy())
    with pytest.raises(ValueError, match="not one of 3 lanes"):
        lanes.uniform((0,), (8,))


def test_multichip_example_runs_on_gloo_ranks_on_the_cpu(tmp_path):
    """examples/multichip_render.py --device cpu starts its own ranks; each
    renders and takes one sharded training step, rank 0 writes the PNG."""
    out = tmp_path / "multichip.png"
    proc = subprocess.run(
        [sys.executable, "-m", "tinsel_tpu_torch.examples.multichip_render", str(out),
         "--device", "cpu", "--world", "2", "--size", "16", "--timeout", "200"],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh {'rays': 1, 'spp': 2} over 2 rank(s), gloo on the CPU" in proc.stdout
    assert "train step: loss" in proc.stdout and out.read_bytes().startswith(b"\x89PNG")
