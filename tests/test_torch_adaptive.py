"""Adaptive sampling in the port against tinsel_tpu at equal draws: the
tile priority, a uniform (warm-up) round and an adaptive round."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinsel_tpu.render import adaptive as jadaptive
from tinsel_tpu.render.camera import CameraParams as JCam
from tinsel_tpu.scene import presets as jpresets
from tinsel_tpu_torch.core.sampling import NumpyUniforms
from tinsel_tpu_torch.render import adaptive as tadaptive
from tinsel_tpu_torch.render.camera import CameraParams as TCam
from tinsel_tpu_torch.scene import presets as tpresets

from torch_parity import JaxUniforms

torch.set_num_threads(2)
W = H = 48  # 9 tiles


def test_tile_priority_and_tiles_equal_jax():
    rng = np.random.default_rng(0)
    acc = rng.random((H, W, 4)).astype(np.float32) * 4
    acc[..., 3] = rng.integers(0, 9, (H, W))
    m2 = rng.random((H, W, 3)).astype(np.float32) * 8
    a = np.asarray(jadaptive._tile_priority(jnp.asarray(acc), jnp.asarray(m2)))
    b = tadaptive._tile_priority(torch.from_numpy(acc), torch.from_numpy(m2)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6)
    t = torch.from_numpy(acc)
    np.testing.assert_array_equal(tadaptive._to_tiles(t).numpy(),
                                  np.asarray(jadaptive._to_tiles(jnp.asarray(acc))))
    assert torch.equal(tadaptive._from_tiles(tadaptive._to_tiles(t), H, W), t)
    with pytest.raises(ValueError):
        tadaptive._check_dims(40, 48)


def test_rounds_match_jax():
    """One warm-up round over every tile from a random first tile (randint
    under (9,)), then two adaptive rounds of 3 tiles: the same tiles chosen
    (ties to the lower index, as lax.top_k) and the buffers as the render
    passes are held: 99.5% of pixels within atol 1e-4 / rtol 1e-3 (here
    at most 8 of 2,304 outside 1e-4 relative), sample counts equal, means
    within 1e-4 relative (a path may take another branch after a last-bit
    difference of a transcendental function)."""
    js, ts = jpresets.cornell_scene(W, H, 3), tpresets.cornell_scene(W, H, 3)
    jflat, jcam = js.flatten(), JCam.from_host(js.camera)
    tflat, tcam = ts.flatten(device="cpu"), TCam.from_host(ts.camera, device="cpu")
    kw = dict(spp=2, width=W, height=H, max_depth=3)
    key = jax.random.key(3)
    ja = (jnp.zeros((H, W, 4)), jnp.zeros((H, W, 3)))
    ta = (torch.zeros((H, W, 4)), torch.zeros((H, W, 3)))
    for r, (k, uniform) in enumerate(((9, True), (3, False), (3, False))):
        kr = jax.random.fold_in(key, r)
        if not uniform:
            want = np.asarray(jax.lax.top_k(jadaptive._tile_priority(*ja), k)[1])
            got = torch.sort(tadaptive._tile_priority(*ta), descending=True,
                             stable=True).indices[:k].numpy()
            np.testing.assert_array_equal(got, want)
        ja = jadaptive.adaptive_round(*ja, jflat, jcam, kr, k_tiles=k, uniform=uniform, **kw)
        ta = tadaptive.adaptive_round(*ta, tflat, tcam, JaxUniforms(kr), k_tiles=k,
                                      uniform=uniform, **kw)
        for x, y in zip(ta, ja):
            x, y = x.numpy(), np.asarray(y)
            close = np.isclose(x, y, atol=1e-4, rtol=1e-3).all(axis=-1)
            assert close.mean() >= 0.995, close.mean()
            assert abs(x.mean() - y.mean()) <= 1e-4 * abs(y.mean())
        np.testing.assert_array_equal(ta[0][..., 3].numpy(), np.asarray(ja[0][..., 3]))
    counts = ta[0][..., 3].numpy()
    assert counts.min() == 2 and counts.max() == 6  # warm-up 2 spp, then chosen tiles


def test_adaptive_render_spends_its_budget():
    """adaptive_render on the CPU: warm-up plus rounds of the top quarter
    of the tiles while the budget lasts; every pixel sampled, the mean
    count within the budget."""
    sc = tpresets.cornell_scene(W, H, 2)
    rounds = []
    acc = tadaptive.adaptive_render(sc, 8, options=sc.options, spp_round=2, device="cpu",
                                    source=NumpyUniforms(2, "cpu"),
                                    report=lambda r, spent: rounds.append(spent))
    counts = acc[..., 3]
    assert float(counts.min()) >= 2 and float(counts.mean()) <= 8
    assert len(rounds) >= 10 and np.isfinite(acc.numpy()).all()
