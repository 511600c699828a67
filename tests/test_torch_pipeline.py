"""The port's bounce-stage pipeline (tinsel_tpu_torch/parallel/pipeline.py)
on the CPU: four gloo stage ranks in their own processes
(tests/torch_dist_worker.py) on Cornell 16x16 depth 4, held against the
port's ``path_trace`` on the same draws (atol 1e-5) and against the JAX
package's ``path_trace`` at equal draws (atol 1e-5, rtol 1e-3: XLA and
PyTorch round a few transcendental functions differently in the last bit,
which moves a few lanes by up to about 2e-4 of their value after four
bounces; ``torch_parity.assert_pass_matches`` allows the same for a pass).

At one microbatch the pipeline is ``path_trace`` of the whole batch; at
four, microbatch m draws under fold_in(key, m), so it is ``path_trace`` of
each microbatch under that key, which is what the JAX
``path_trace_pipelined`` computes (``tinsel_tpu/parallel/pipeline.py:96``),
here without compiling its ``shard_map``.
"""

import jax
import numpy as np
import pytest
import torch

from tinsel_tpu.render.integrator import path_trace as jpath_trace
from tinsel_tpu.scene.presets import cornell_scene as jcornell
from tinsel_tpu_torch.core.sampling import NumpyUniforms, Prefixed
from tinsel_tpu_torch.parallel import pipeline, sharding
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.render.camera import generate_rays
from tinsel_tpu_torch.render.integrator import path_trace
from tinsel_tpu_torch.scene.presets import cornell_scene as tcornell

from torch_dist_worker import Recorder, run_ranks
from torch_parity import JaxUniforms

torch.set_num_threads(2)
W = 16
DEPTH = 4
N_MICRO = 4
KEY = 7


def _rays():
    """The pixel centres' camera rays (tests/test_sharding.py:125-128)."""
    ts = tcornell(W, W, DEPTH)
    cam = TCam.from_host(ts.camera, device="cpu")
    xs = torch.arange(W, dtype=torch.float32) + 0.5
    gx, gy = torch.meshgrid(xs, xs, indexing="xy")
    o, d = generate_rays(cam, W, W, torch.stack([gx, gy], -1).reshape(-1, 2))
    return ts.flatten(device="cpu"), o, d, torch.zeros(W * W)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX path_trace of the batch and of each microbatch under
    fold_in(key, m); the port's path_trace on the same draws; the four
    stage ranks at n_micro 1 and 4 on those draws."""
    flat, o, d, t = _rays()
    key = jax.random.key(KEY)
    jflat = jcornell(W, W, DEPTH).flatten()
    jtrace = jax.jit(lambda s, o, d, t, k: jpath_trace(s, o, d, t, DEPTH, k))
    micro = W * W // N_MICRO
    cuts = [slice(m * micro, (m + 1) * micro) for m in range(N_MICRO)]
    jax1 = np.array(jtrace(jflat, o.numpy(), d.numpy(), t.numpy(), key))
    jax4 = np.concatenate([
        np.array(jtrace(jflat, o[c].numpy(), d[c].numpy(), t[c].numpy(), jax.random.fold_in(key, m)))
        for m, c in enumerate(cuts)])
    rec = Recorder(JaxUniforms(key))
    port1 = path_trace(flat, o, d, t, DEPTH, rec).numpy()
    port4 = torch.cat([path_trace(flat, o[c], d[c], t[c], DEPTH, Prefixed(rec, m))
                       for m, c in enumerate(cuts)]).numpy()
    job = dict(backend="gloo", device="cpu", draws="table", tasks=[
        dict(kind="pipeline", name="pipe", size=W, depth=DEPTH, n_micro=[1, N_MICRO])])
    arrays = dict(rec.draws, **{"rays.o": o.numpy(), "rays.d": d.numpy(), "rays.t": t.numpy()})
    ranks = run_ranks(job, DEPTH, tmp_path_factory.mktemp("stages"), arrays)
    return dict(jax1=jax1, jax4=jax4, port1=port1, port4=port4, ranks=ranks)


def test_one_microbatch_matches_jax_path_trace(run):
    out = run["ranks"][0]["pipe.n_micro1"]
    assert out.shape == (W * W, 3) and run["jax1"].mean() > 1e-3
    np.testing.assert_allclose(out, run["jax1"], atol=1e-5, rtol=1e-3)


def test_four_microbatches_match_jax_per_microbatch(run):
    out = run["ranks"][0]["pipe.n_micro4"]
    np.testing.assert_allclose(out, run["jax4"], atol=1e-5, rtol=1e-3)
    # other draws than one microbatch: the two runs are different samples
    assert not np.allclose(run["jax4"], run["jax1"], atol=1e-3)


@pytest.mark.parametrize("n_micro", [1, N_MICRO])
def test_every_stage_returns_the_ports_path_trace(run, n_micro):
    want = run["port1"] if n_micro == 1 else run["port4"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r[f"pipe.n_micro{n_micro}"], want, atol=1e-5)


@pytest.fixture
def world_of_one(tmp_path):
    sharding.init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_one_stage_is_a_one_bounce_path_trace(world_of_one):
    flat, o, d, t = _rays()
    src = NumpyUniforms(2, "cpu")
    mesh = pipeline.make_stage_mesh(1)
    assert mesh.mesh_dim_names == ("stage",)
    np.testing.assert_allclose(
        pipeline.path_trace_pipelined(flat, o, d, t, 1, src, mesh).numpy(),
        path_trace(flat, o, d, t, 1, src).numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="2-stage mesh in a process group of 1"):
        pipeline.make_stage_mesh(2)
    with pytest.raises(ValueError, match="one stage a bounce"):
        pipeline.path_trace_pipelined(flat, o, d, t, 2, src, mesh)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.path_trace_pipelined(flat, o, d, t, 1, src, mesh, n_micro=3)
