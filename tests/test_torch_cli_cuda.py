"""The command line on the card: ``-denoise`` launches kernel K1 and
``-denoise-guided`` kernel K2 (never their plain versions), each output
equal to its plain version on the run's inputs, ``-mode complexity``
launches K7 with steps equal to the plain count, a render
resumed from a checkpoint equals the uninterrupted render bit for bit,
and the chunk guard rolls a NaN chunk back on the card. Every test needs
an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cli_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.app import cli
from tinsel_tpu_torch.io.png import read_png
from tinsel_tpu_torch.ops import nlm as ops_nlm
from tinsel_tpu_torch.parallel.checkpoint import load_checkpoint
from tinsel_tpu_torch.parallel.failure import ChunkGuard, chunk_health
from tinsel_tpu_torch.render import nlm as plain_nlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "cornell.tin")
SMALL = ["-width", "64", "-height", "64", "-maxdepth", "2"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _run(argv):
    args = cli.build_parser().parse_args(argv)
    return cli.render_one(cli.load_scene(args.scene), args, args.output)


@pytest.mark.cuda
@pytest.mark.parametrize("flag,kernel,dispatcher,plain_fn", [
    ("-denoise", "nlm_filter", "nlm_denoise", plain_nlm.nlm_filter),
    ("-denoise-guided", "nlm_guided", "nlm_guided_denoise", plain_nlm.nlm_guided),
])
def test_cli_denoise_launches_its_kernel(cuda, tmp_path, monkeypatch, flag, kernel,
                                         dispatcher, plain_fn):
    """The kernel's output in the CLI's run equals the plain filter on the
    run's own inputs within 1e-5 (f32 rounding of fused multiply-adds)."""
    calls = []
    real = getattr(ops_nlm, dispatcher)

    def recorded(*a, **k):
        out = real(*a, **k)
        calls.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a), k, out))
        return out

    monkeypatch.setattr(ops_nlm, dispatcher, recorded)
    out = str(tmp_path / "d.png")
    ops_nlm.reset_launch_counts()
    guard = _run([CORNELL, *SMALL, "-spp", "4", flag, "-o", out])
    other = "nlm_guided" if kernel == "nlm_filter" else "nlm_filter"
    assert ops_nlm.launch_counts[kernel] == 1
    assert ops_nlm.launch_counts[other] == 0
    assert not guard.events
    (a, k, got), = calls
    assert got.is_cuda
    torch.testing.assert_close(got, plain_fn(*a, **k), atol=1e-5, rtol=0)
    img = read_png(out)
    assert img.shape == (64, 64, 3) and img.max() > 10


@pytest.mark.cuda
def test_cli_complexity_steps_equal_plain_count(cuda, tmp_path, monkeypatch):
    """``-mode complexity`` on veach_mis.json's knob (3,200 triangles)
    launches K7; its per-lane steps equal the plain count on the run's own
    rays."""
    from tinsel_tpu_torch.accel.traverse import traversal_cost
    from tinsel_tpu_torch.ops import bvh as ops_bvh

    calls = []
    real = ops_bvh.traversal_steps

    def recorded(*a):
        out = real(*a)
        calls.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a), out))
        return out

    monkeypatch.setattr(ops_bvh, "traversal_steps", recorded)
    ops_bvh.reset_launch_counts()
    veach = os.path.join(REPO, "scenes", "veach_mis.json")
    _run([veach, "-width", "128", "-height", "72", "-mode", "complexity",
          "-o", str(tmp_path / "c.png")])
    assert ops_bvh.launch_counts["bvh_steps"] == 1
    ((pool, noff, toff, o, d, slots), got), = calls
    inf = torch.full((o.shape[0],), float("inf"), device=cuda)
    assert torch.equal(got, traversal_cost(pool, noff, toff, o, d, inf, stack_slots=slots))


@pytest.mark.cuda
def test_cli_resume_equals_uninterrupted_run_on_the_card(cuda, tmp_path):
    base = [CORNELL, *SMALL, "-progressive", "2", "-checkpoint-every", "2"]
    a_ck, b_ck = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    _run([*base, "-spp", "6", "-checkpoint", a_ck, "-o", str(tmp_path / "a.png")])
    _run([*base, "-spp", "2", "-checkpoint", b_ck, "-o", str(tmp_path / "b.png")])
    guard = _run([*base, "-spp", "6", "-checkpoint", b_ck, "-resume",
                  "-o", str(tmp_path / "c.png")])
    a, spp_a, _, _ = load_checkpoint(a_ck)
    b, spp_b, _, _ = load_checkpoint(b_ck)
    assert spp_a == spp_b == 6 and not guard.events
    assert np.array_equal(a, b)


@pytest.mark.cuda
def test_guard_rolls_back_a_nan_chunk_on_the_card(cuda):
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn

    sc = cli.load_scene(CORNELL)
    sc.options.width = sc.options.height = 64
    sc.options.max_depth = 2
    flat, cam = sc.flatten(cuda), CameraParams.from_host(sc.camera, cuda)
    step = make_accumulate_fn(sc.options, 2)
    attempts = []

    def poisoned(accum, scene, cam, source, pass_idx):
        out = step(accum, scene, cam, source, pass_idx)
        attempts.append(pass_idx)
        if pass_idx == 1 and attempts.count(1) == 1:
            return out * float("nan")
        return out

    guard = ChunkGuard(retries=2, backoff_s=0.0)
    src = PathUniforms(0, cuda)
    accum = torch.zeros((64, 64, 4), device=cuda)
    for c in range(3):
        accum = guard.run(poisoned, accum, flat, cam, src, c, spp_done=2 * c)
    assert chunk_health(accum)
    assert [e["kind"] for e in guard.events] == ["corrupt-chunk"]
    assert attempts == [0, 1, 1, 2]
    # the retried pass drew another sample set: not the unguarded render
    plain = torch.zeros_like(accum)
    for c in range(3):
        plain = step(plain, flat, cam, src, c)
    assert not torch.equal(accum, plain)
    assert float(accum[..., 3].min()) > 0.0
