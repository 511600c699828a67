"""The port's checkpoint files and chunk guard (``parallel/checkpoint.py``,
``parallel/failure.py``) against tinsel_tpu's.

Checkpoints written by either package load in the other, equal. The
guard's cases mirror tests/test_failure.py on the port: NaN and Inf chunks
roll back and retry under a reseeded source, a ``torch.AcceleratorError``
is retried, an exhausted budget salvages the last verified buffer as a
checkpoint that loads, and a real render runs through the guard
untouched. One case more: a plain ``RuntimeError`` (what a kernel's build
or a refused launch raises) is not retried.
"""

import numpy as np
import pytest
import torch

from tinsel_tpu.parallel import checkpoint as jckpt
from tinsel_tpu_torch.parallel import checkpoint as tckpt
from tinsel_tpu_torch.parallel.failure import ChunkGuard, RenderFailure, chunk_health


@pytest.mark.parametrize("writer", ["port", "jax", "port_tensor"])
def test_checkpoints_cross_load(tmp_path, writer):
    accum = np.random.default_rng(2).random((8, 6, 4)).astype(np.float32)
    p = str(tmp_path / "ck.npz")
    meta = {"scene": "x.tin", "n": 3}
    if writer == "jax":
        jckpt.save_checkpoint(p, accum, spp_done=17, seed=3, meta=meta)
    else:
        a = torch.from_numpy(accum) if writer == "port_tensor" else accum
        tckpt.save_checkpoint(p, a, spp_done=17, seed=3, meta=meta)
    for load in (tckpt.load_checkpoint, jckpt.load_checkpoint):
        a, spp, seed, m = load(p)
        np.testing.assert_array_equal(a, accum)
        assert a.dtype == np.float32
        assert spp == 17 and seed == 3 and m == meta


class _Recorder:
    """A UniformSource that records the paths it is asked for."""

    def __init__(self):
        self.paths = []

    def uniform(self, path, shape):
        self.paths.append(tuple(path))
        return torch.zeros(tuple(shape))

    def randint(self, path, shape, low, high):
        self.paths.append(tuple(path))
        return torch.full(tuple(shape), low)


def _mk_step(fail_plan):
    """Step whose attempt-N behaviour is scripted: 'nan', 'inf', 'device',
    'runtime', 'ok'; each call draws once at (pass_idx,) of its source."""
    calls = []

    def step(accum, scene, cam, source, pass_idx):
        action = fail_plan[len(calls)] if len(calls) < len(fail_plan) else "ok"
        source.uniform((pass_idx,), (1,))
        calls.append(action)
        if action == "device":
            raise torch.AcceleratorError("injected transient device error")
        if action == "runtime":
            raise RuntimeError("nlm_filter kernel launch failed: injected")
        inc = torch.ones_like(accum)
        if action == "nan":
            inc = inc * float("nan")
        elif action == "inf":
            inc[0, 0, 0] = float("inf")
        return accum + inc

    step.calls = calls
    return step


def test_chunk_health():
    good = torch.ones((4, 4, 4))
    assert chunk_health(good)
    bad = good.clone()
    bad[1, 2, 3] = float("nan")
    assert not chunk_health(bad)
    bad = good.clone()
    bad[0, 0, 0] = float("inf")
    assert not chunk_health(bad)


def test_nan_chunk_rolls_back_and_reseeds():
    guard = ChunkGuard(retries=2, backoff_s=0.0)
    step = _mk_step(["nan", "ok"])
    src = _Recorder()
    out = guard.run(step, torch.zeros((4, 4, 4)), None, None, src, 7)
    # retried once, recovered: the buffer holds exactly one good chunk
    np.testing.assert_allclose(out.numpy(), 1.0)
    assert step.calls == ["nan", "ok"]
    # the retry drew under the retry salt: another sample set
    assert src.paths == [(7,), (ChunkGuard._RETRY_SALT + 1, 7)]
    assert [e["kind"] for e in guard.events] == ["corrupt-chunk"]


def test_inf_detected_too():
    guard = ChunkGuard(retries=1, backoff_s=0.0)
    step = _mk_step(["inf", "ok"])
    out = guard.run(step, torch.zeros((2, 2, 4)), None, None, _Recorder(), 0)
    assert chunk_health(out)
    assert guard.events[0]["kind"] == "corrupt-chunk"


def test_transient_device_error_retried():
    guard = ChunkGuard(retries=2, backoff_s=0.0)
    step = _mk_step(["device", "ok"])
    out = guard.run(step, torch.zeros((2, 2, 4)), None, None, _Recorder(), 3)
    np.testing.assert_allclose(out.numpy(), 1.0)
    assert guard.events[0]["kind"] == "device-error"
    assert step.calls == ["device", "ok"]


def test_plain_runtime_error_is_not_retried(tmp_path):
    """A build error or a refused launch raises RuntimeError: it must
    surface at once, with no retry, no event and no salvage."""
    ckpt = tmp_path / "never.ckpt"
    guard = ChunkGuard(retries=3, backoff_s=0.0, salvage_path=str(ckpt))
    step = _mk_step(["runtime", "ok"])
    with pytest.raises(RuntimeError, match="kernel launch failed") as info:
        guard.run(step, torch.zeros((2, 2, 4)), None, None, _Recorder(), 1)
    assert not isinstance(info.value, RenderFailure)
    assert step.calls == ["runtime"]
    assert not guard.events and not ckpt.exists()


def test_exhausted_budget_salvages_checkpoint(tmp_path):
    ckpt = str(tmp_path / "salvage.ckpt")
    guard = ChunkGuard(retries=1, backoff_s=0.0, salvage_path=ckpt, seed=42)
    step = _mk_step(["nan", "nan"])
    accum = torch.full((3, 3, 4), 5.0)  # the verified state before the chunk
    with pytest.raises(RenderFailure):
        guard.run(step, accum, None, None, _Recorder(), 9, spp_done=16)
    for load in (tckpt.load_checkpoint, jckpt.load_checkpoint):
        a, spp, seed, meta = load(ckpt)
        np.testing.assert_allclose(a, 5.0)  # the last good state, not the NaN one
        assert spp == 16 and seed == 42 and meta["salvaged"] is True


def test_guarded_loop_end_to_end():
    """A small real render through the guard: the checks pass untouched,
    and the result equals the unguarded loop's."""
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn
    from tinsel_tpu_torch.scene.presets import cornell_scene

    scene = cornell_scene(width=8, height=8, max_depth=2)
    flat = scene.flatten("cpu")
    cam = CameraParams.from_host(scene.camera, "cpu")
    step = make_accumulate_fn(scene.options, 2)
    guard = ChunkGuard(retries=1)
    src = PathUniforms(0, "cpu")
    accum = torch.zeros((8, 8, 4))
    plain = torch.zeros((8, 8, 4))
    for c in range(2):
        accum = guard.run(step, accum, flat, cam, src, c, spp_done=2 * c)
        plain = step(plain, flat, cam, src, c)
    assert chunk_health(accum)
    assert not guard.events
    assert float(accum[..., 3].min()) > 0.0
    assert torch.equal(accum, plain)
