"""The port's command line (``tinsel_tpu_torch/app/cli.py``) on the CPU.

At equal draws against tinsel_tpu's CLI on tests/test_periphery.py's mini
scene (24x20, maxDepth 2, 2 spp, ``-denoise``, a checkpoint every spp):
the port's CLI is fed the JAX key's draws (``JaxUniforms`` on the CLI's
``source``), the final checkpoints' ``accum`` must agree to the render
limits of ``PERF.md`` section 2 (99.5% of pixels within atol 1e-4 / rtol
1e-3, means within 1e-3 relative), and the PNGs within 1 LSB on at least
99.5% of pixels (both dither with the same ``default_rng(0)``).

The rest is the port alone, each output held to what the library computes
from the run's own checkpoint (PNG bytes equal), except ``-aov`` (against
JAX's ``render_aovs``: the pixel-center trace is deterministic, so the
PFMs agree to 1e-5) and ``-convert`` (the ``.npz`` equal to JAX's, array
by array). ``-resume`` must equal the uninterrupted run bit for bit.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tinsel_tpu_torch.app import cli
from tinsel_tpu_torch.core.color import resolve
from tinsel_tpu_torch.io.hdr import load_pfm
from tinsel_tpu_torch.io.png import encode_png, read_png
from tinsel_tpu_torch.parallel.checkpoint import load_checkpoint
from tinsel_tpu_torch.scene.loaders.tin import load_tin

from torch_parity import JaxUniforms, assert_pass_matches

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MINI_TIN = """
options
{
    width 24
    height 20
    maxDepth 2
}

camera
{
    position 0.0 1.0 4.0
    fov 45
}

material white
{
    color 0.8 0.8 0.8
    roughness 1.0
    specular 0.1
}

material light
{
    emission 10 10 10
    color 0 0 0
}

primitive
{
    type plane
    plane 0 1 0 0
    material white
}

primitive
{
    type sphere
    radius 0.5
    position 0 3 0
    material light
    lightSamples 1
}
"""

# a Cornell box at 32x32, depth 2: every CLI path below renders it
CORNELL = os.path.join(REPO, "scenes", "cornell.tin")
SMALL = ["-width", "32", "-height", "32", "-maxdepth", "2", "-device", "cpu"]


@pytest.fixture
def mini(tmp_path):
    path = tmp_path / "mini.tin"
    path.write_text(MINI_TIN)
    return str(path)


def _run(argv, source=None):
    """Parse ``argv`` with the port's parser and render it as ``main``
    does; returns the run's ChunkGuard."""
    args = cli.build_parser().parse_args(argv)
    return cli.render_one(cli.load_scene(args.scene), args, args.output, source=source)


def test_cli_matches_jax_cli_at_equal_draws(mini, tmp_path):
    from tinsel_tpu.app.cli import main as jmain

    j_png, j_ck = str(tmp_path / "j.png"), str(tmp_path / "j.npz")
    t_png, t_ck = str(tmp_path / "t.png"), str(tmp_path / "t.npz")
    common = ["-spp", "2", "-denoise", "-checkpoint-every", "1"]
    assert jmain([mini, *common, "-o", j_png, "-checkpoint", j_ck]) == 0
    guard = _run([mini, *common, "-o", t_png, "-checkpoint", t_ck, "-device", "cpu"],
                 source=JaxUniforms(jax.random.key(0, impl="rbg")))
    assert not guard.events
    a, spp_a, _, _ = load_checkpoint(j_ck)
    b, spp_b, _, _ = load_checkpoint(t_ck)
    assert spp_a == spp_b == 2
    assert a[..., :3].mean() > 1e-3
    assert_pass_matches(a, b)
    pa, pb = read_png(j_png), read_png(t_png)
    assert pa.shape == pb.shape == (20, 24, 3)
    within = (np.abs(pa.astype(int) - pb.astype(int)) <= 1).all(axis=-1)
    assert within.mean() >= 0.995, within.mean()


def test_cli_resume_equals_uninterrupted_run(tmp_path):
    """-progressive 1 makes a chunk of 1 spp, so the run has passes 0..2;
    B renders pass 0, then resumes at pass 1 from its checkpoint."""
    base = [CORNELL, *SMALL, "-progressive", "1", "-checkpoint-every", "1"]
    a_ck, b_ck = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    ga = _run([*base, "-spp", "3", "-checkpoint", a_ck, "-o", str(tmp_path / "a.png")])
    gb = _run([*base, "-spp", "1", "-checkpoint", b_ck, "-o", str(tmp_path / "b.png")])
    one, _, _, _ = load_checkpoint(b_ck)
    gc = _run([*base, "-spp", "3", "-checkpoint", b_ck, "-resume",
               "-o", str(tmp_path / "c.png")])
    a, spp_a, _, _ = load_checkpoint(a_ck)
    b, spp_b, _, _ = load_checkpoint(b_ck)
    assert spp_a == spp_b == 3
    assert np.array_equal(a, b)
    # the resumed passes drew new samples, not pass 0's again
    assert not np.array_equal(b, 3 * one)
    assert not (ga.events or gb.events or gc.events)
    assert (tmp_path / "c.png").read_bytes() == (tmp_path / "a.png").read_bytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_cli_seed_equals_library_render_seed(tmp_path, seed):
    """The CLI and ``render`` draw from one source, ``PathUniforms``: the
    CLI's ``-seed s`` buffer equals ``render(seed=s)`` bit for bit."""
    from tinsel_tpu_torch.render.renderer import render

    ck = str(tmp_path / "s.npz")
    _run([CORNELL, *SMALL, "-spp", "3", "-seed", str(seed), "-o", str(tmp_path / "s.png"),
          "-checkpoint", ck, "-checkpoint-every", "1"])
    sc = load_tin(CORNELL)
    sc.options.width = sc.options.height = 32
    sc.options.max_depth = 2
    lib = render(sc, spp=3, seed=seed, device="cpu")
    assert np.array_equal(load_checkpoint(ck)[0], lib.numpy())
    other = render(sc, spp=3, seed=seed + 1, device="cpu")
    assert not torch.equal(other, lib)


@pytest.mark.parametrize("flags", [["-denoise-guided"], ["-mode", "normals"],
                                   ["-mode", "complexity"], ["-tonemap", "reinhard", "-denoise"]])
def test_cli_outputs_equal_the_library_on_the_run(tmp_path, flags):
    """Each PNG equals the library's image computed from the run's own
    final accumulation (the checkpoint) on the same scene."""
    from tinsel_tpu_torch.ops.nlm import nlm_denoise, nlm_guided_denoise
    from tinsel_tpu_torch.render.aov import render_aovs
    from tinsel_tpu_torch.render.camera import CameraParams

    out, ck = str(tmp_path / "o.png"), str(tmp_path / "o.npz")
    _run([CORNELL, *SMALL, "-spp", "2", *flags, "-o", out, "-checkpoint", ck,
          "-checkpoint-every", "1"])
    accum = torch.from_numpy(load_checkpoint(ck)[0])
    sc = load_tin(CORNELL)
    sc.options.width = sc.options.height = 32
    tonemap = "reinhard" if "reinhard" in flags else "filmic"
    if "-mode" in flags:
        img = torch.clamp(accum[..., :3], 0.0, 1.0)
    else:
        img = resolve(accum, exposure=sc.options.exposure, limit=sc.options.limit,
                      tonemap=tonemap)
        if "-denoise-guided" in flags:
            aov = render_aovs(sc.flatten("cpu"), CameraParams.from_host(sc.camera, "cpu"), 32, 32)
            img = nlm_guided_denoise(img, aov["normal"], aov["albedo"], aov["depth"],
                                     falloff=200.0)
        else:
            img = nlm_denoise(img, 200.0, 1)
    assert torch.isfinite(accum).all() and float(img.mean()) > 0.01
    assert open(out, "rb").read() == encode_png(img.numpy())


def test_cli_aov_files_match_jax_render_aovs(mini, tmp_path):
    from tinsel_tpu.render.aov import render_aovs as jrender_aovs
    from tinsel_tpu.render.camera import CameraParams as JCam
    from tinsel_tpu.scene.loaders.tin import load_tin as jload_tin

    out = str(tmp_path / "m.png")
    _run([mini, "-spp", "1", "-aov", "-o", out, "-device", "cpu"])
    js = jload_tin(mini)
    ref = jax.jit(lambda f, c: jrender_aovs(f, c, 24, 20))(js.flatten(), JCam.from_host(js.camera))
    for name in ("normal", "depth", "albedo"):
        got = load_pfm(str(tmp_path / f"m_{name}.pfm"))
        want = np.asarray(ref[name])
        if name == "depth":
            want = np.repeat(want, 3, axis=-1)  # one channel, written as RGB
        assert got.shape == (20, 24, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (load_pfm(str(tmp_path / "m_depth.pfm")) > 0).mean() > 0.3


def test_cli_batch_animation(tmp_path):
    """A %d scene pattern renders each existing frame to its own PNG and
    stops at the first gap (tests/test_periphery.py's batch case)."""
    src = """
options
{{
    width 16
    height 16
    maxDepth 1
    maxSamples 2
}}
sky
{{
    horizon 0.4 0.4 {h}
    zenith 0.1 0.1 0.3
}}
"""
    for i, h in ((0, "0.4"), (1, "0.9")):
        (tmp_path / f"anim_{i}.tin").write_text(src.format(h=h))
    out = tmp_path / "out_%d.png"
    assert cli.main([str(tmp_path / "anim_%d.tin"), "-o", str(out), "-device", "cpu"]) == 0
    assert (tmp_path / "out_0.png").exists() and (tmp_path / "out_1.png").exists()
    assert not (tmp_path / "out_2.png").exists()
    a = read_png(str(tmp_path / "out_0.png"))
    b = read_png(str(tmp_path / "out_1.png"))
    assert a.shape == (16, 16, 3) and not np.array_equal(a, b)


def test_cli_progressive_previews(tmp_path):
    out = str(tmp_path / "p.png")
    _run([CORNELL, *SMALL, "-spp", "4", "-progressive", "2", "-o", out])
    assert read_png(str(tmp_path / "p_spp00002.png")).shape == (32, 32, 3)
    assert not (tmp_path / "p_spp00004.png").exists()  # the last is the output
    assert read_png(out).max() > 10


def test_cli_adaptive(tmp_path):
    out = str(tmp_path / "ad.png")
    assert _run([CORNELL, *SMALL, "-spp", "8", "-adaptive", "0.5", "-o", out]) is None
    img = read_png(out)
    assert img.shape == (32, 32, 3) and img.max() > 10
    with pytest.raises(SystemExit, match="-adaptive does not combine"):
        _run([CORNELL, *SMALL, "-spp", "8", "-adaptive", "0.5", "-o", out,
              "-checkpoint", str(tmp_path / "x.npz")])


def test_cli_convert_equals_jax_convert(tmp_path):
    from tinsel_tpu.app.cli import main as jmain

    rng = np.random.default_rng(5)
    verts = rng.random((30, 3)) * 4 - 2
    faces = rng.integers(0, 30, (40, 3)) + 1
    text = "".join(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
    text += "".join(f"f {a} {b} {c}\n" for a, b, c in faces)
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "m.obj").write_text(text)
    assert jmain(["-convert", str(tmp_path / "jax" / "m.obj")]) == 0
    assert cli.main(["-convert", str(tmp_path / "port" / "m.obj")]) == 0
    a = np.load(tmp_path / "jax" / "m.npz")
    b = np.load(tmp_path / "port" / "m.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([CORNELL, "-spp", "1", "-o", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_module_entry_point_runs_without_jax():
    """``python -m tinsel_tpu_torch --help`` exits 0, and importing the CLI
    and the viewer leaves jax and tinsel_tpu out of sys.modules."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "tinsel_tpu_torch", "--help"], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "-device" in out.stdout and "-denoise-guided" in out.stdout
    code = ("import sys, tinsel_tpu_torch.app.cli, tinsel_tpu_torch.app.viewer\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tinsel_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
