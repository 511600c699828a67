"""The NEE kernels K8 (light sample and shadow ray) and K9 (shading),
csrc/nee.cu, against their plain PyTorch versions (ops/nee.py) on the
card, at equal draws. Every test needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it runs where JAX is not
installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_nee_cuda.py

Tolerance. K8: none; csrc/nee.cu is compiled with -fmad=false and follows
the card's order of operations of the eager chain, so the shadow ray
(origin, direction, tmax), the distance and area * cos are equal on every
lane bit for bit. K9 and the whole ``sample_lights``: 1e-6 relative and
1e-12 absolute per value (the aim, where the operations are +, -, *, /,
sqrt, min and max, is bit-equality; ``logf`` and ``rsqrtf`` are the same
instructions on both sides). Cases: a static sphere light, a moving,
growing one, Cornell's quad and a jittered mesh light of 200 triangles
(the CDF search); a material grid for K9 (metallic, transmission,
subsurface, clearcoat, roughness at and below its 0.001 floor, lanes
inside a dielectric and below the surface, rejected and occluded lanes,
the probe's form, power mode's selection pmf); ``sample_lights`` on
scenes/cornell.tin, on an envmesh with the probe and a sphere light of 10
samples, and the same with ``NEE_CLOSEST_SHADOW``, in both light-sampling
modes; under autograd, its value and its gradients (p, the material, the
light transforms and radii, the emission, a mesh light's vertices) against
the plain path forced: the backward recomputes the plain versions from the
same inputs, and only the order of the gradient's sums differs. A per-lane
leaf at 1e-5 relative and 1e-6 absolute; a table's leaf, summed across
lanes by atomic adds in no fixed order (the plain path run twice differs
too), within 1e-4 of its largest entry.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import nee_cases as cases
from tinsel_tpu_torch.core.math import normalize
from tinsel_tpu_torch.core.sampling import NumpyUniforms, PathUniforms
from tinsel_tpu_torch.ops import nee
from tinsel_tpu_torch.render import lights, trace
from tinsel_tpu_torch.scene.model import MaterialsFlat

R = 100_003  # leaves the last block part-filled
TOL = dict(rtol=1e-6, atol=1e-12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _equal(a, b, what):
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    assert bool(same.all()), f"{what}: {int((~same).sum())} of {a.numel()} values differ"


@pytest.mark.cuda
@pytest.mark.parametrize("light", [8, 9, 5, 10], ids=["sphere", "moving", "quad", "mesh200"])
def test_light_sample_equals_plain_bit_for_bit(cuda, light):
    flat = cases.cornell_lights().flatten(device=cuda)
    _, _, _, p, n, _, times = cases.bounce_inputs(flat, R, light, cuda)
    src = NumpyUniforms(light, cuda)
    uni = [src.uniform((k,), (R,)) for k in range(3)]
    tr = trace.prim_transform(flat, light, times)
    with torch.no_grad():
        want = nee.light_sample_plain(flat, light, tr, p, n, times, uni)
        got = nee.light_sample(flat, light, tr, p, n, times, uni)
    for name in nee.LightSample._fields:
        _equal(getattr(got, name), getattr(want, name), name)
    assert bool((got.area_nl != nee.REJECTED).any())


def _material_grid(r, seed, dev):
    rng = np.random.default_rng(seed)

    def pick(*vals):
        return torch.from_numpy(rng.choice(np.asarray(vals, np.float32), r)).to(dev)

    def unit():
        return torch.from_numpy(rng.random(r, dtype=np.float32)).to(dev)

    color = torch.from_numpy(rng.random((r, 3), dtype=np.float32)).to(dev)
    color[:r // 16] = 0.0  # luminance 0: the untinted specular
    return MaterialsFlat(
        emission=torch.zeros(r, 3, device=dev), color=color,
        absorption=torch.zeros(r, 3, device=dev), eta=pick(1.33, 1.5, 2.4),
        metallic=pick(0.0, 0.0, 1.0, 0.4), subsurface=pick(0.0, 0.0, 0.8),
        specular=pick(0.0, 0.5, 1.0), roughness=pick(0.0, 0.0005, 0.001, 0.1, 0.5, 1.0),
        specular_tint=unit(), clearcoat=pick(0.0, 1.0, 0.3), clearcoat_gloss=unit(),
        transmission=pick(0.0, 0.0, 1.0, 0.3))


def _directions(rng, r, dev):
    return normalize(torch.from_numpy(rng.normal(size=(r, 3)).astype(np.float32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["light", "light_lanes", "probe", "power"])
def test_shade_equals_plain(cuda, form):
    rng = np.random.default_rng(11)
    m = _material_grid(R, 12, cuda)
    n = _directions(rng, R, cuda)
    wo = _directions(rng, R, cuda)  # about half the lanes view from below
    wi = _directions(rng, R, cuda)
    eta_i = torch.from_numpy(rng.choice(np.float32([1.0, 1.0, 1.5]), R)).to(cuda)
    eta_o = torch.where(eta_i == 1.0, m.eta, 1.0)
    vis = torch.from_numpy(rng.random(R) < 0.2).to(cuda)
    light_t = torch.from_numpy(rng.uniform(0.05, 4.0, R).astype(np.float32)).to(cuda)
    probe = form == "probe"
    if probe:
        light_t = torch.from_numpy(rng.choice(np.float32([0.0, 0.02, 0.3, 5.0]), R)).to(cuda)
        light_t = light_t * torch.from_numpy(rng.random(R, dtype=np.float32)).to(cuda)
        area_nl = None  # the probe: light_t is its pdf
    else:
        area_nl = torch.from_numpy(rng.uniform(1e-4, 2.0, R).astype(np.float32)).to(cuda)
        area_nl[torch.from_numpy(rng.random(R) < 0.1).to(cuda)] = nee.REJECTED
    emission = (torch.from_numpy(rng.uniform(0, 20, (R, 3)).astype(np.float32)).to(cuda)
                if form != "light" else torch.tensor([17.0, 12.0, 4.0], device=cuda))
    c = {"probe": (0.5, 0.5, 1e-12), "power": (1.0, 1.0, 1e-3)}.get(form,
                                                                    (1 / 11, 10 / 11, 1e-3))
    occludes = form != "light_lanes"
    pmf = None
    if form == "power":  # a selection pmf a lane, zero on some
        pmf = torch.from_numpy(rng.choice(np.float32([0.0, 0.2, 0.5, 1.0]), R)).to(cuda)
    acc = torch.from_numpy(rng.uniform(0, 1, (R, 3)).astype(np.float32)).to(cuda)
    args = (m, eta_i, eta_o, n, wo, wi, vis, occludes, light_t, area_nl, emission, *c)
    with torch.no_grad():
        if probe:  # as render/lights.py composes each form
            want = acc + nee.shade_plain(*args, probe=True) / lights.K_PROBE_SAMPLES
            got = nee.shade(*args, acc.clone(), probe=True)
        else:
            want = acc + nee.shade_plain(*args, pmf=pmf)
            got = nee.shade(*args, acc.clone(), pmf=pmf)
    torch.testing.assert_close(got, want, **TOL)
    contributed = (want != acc).any(dim=-1)
    assert int(contributed.sum()) > R // 20
    same = (got == want).all(dim=-1).float().mean().item()
    print(f"K9 {form}: {same:.6f} of lanes bit-equal")


def _sample_lights_both(flat, seed, closest, monkeypatch, eye, mode="all", r=R):
    monkeypatch.setattr(lights, "NEE_CLOSEST_SHADOW", closest)
    dev = flat.prims.start_p.device
    args = cases.bounce_inputs(flat, r, seed, dev, eye)
    src = PathUniforms(seed, dev)
    nee.reset_launch_counts()
    with torch.no_grad():
        got = lights.sample_lights(flat, *args, src, light_sampling=mode)
        launches = dict(nee.launch_counts)
        with monkeypatch.context() as mp:
            mp.setattr(nee, "fuses", lambda p: False)
            want = lights.sample_lights(flat, *args, src, light_sampling=mode)
    assert nee.launch_counts == launches  # the plain path launches neither kernel
    return got, want, launches


def _eye(which):
    return cases.CORNELL_TIN_EYE if which == "cornell_tin" else (0.0, 1.0, 3.3)


@pytest.mark.cuda
@pytest.mark.parametrize("closest", [False, True], ids=["occlusion", "closest"])
@pytest.mark.parametrize("which", ["cornell_tin", "envmesh_probe"])
def test_sample_lights_equals_plain(cuda, which, closest, monkeypatch):
    flat = getattr(cases, which)().flatten(device=cuda)
    got, want, launches = _sample_lights_both(flat, 2147483711, closest, monkeypatch,
                                              _eye(which))
    torch.testing.assert_close(got, want, **TOL)
    assert bool((want != 0).any(dim=-1).float().mean() > 0.05)
    lights_samples = sum(flat.prim_static[j].light_samples for j in flat.light_indices)
    # one K9 a sample taken: every sample of the call went through the kernels
    assert launches == {"nee_light": lights_samples,
                        "nee_shade": lights_samples + int(flat.probe is not None)}


@pytest.mark.cuda
@pytest.mark.parametrize("closest", [False, True], ids=["occlusion", "closest"])
def test_power_mode_equals_plain(cuda, closest, monkeypatch):
    flat = cases.cornell_lights().flatten(device=cuda)
    got, want, launches = _sample_lights_both(flat, 2147483713, closest, monkeypatch,
                                              (0.0, 1.0, 3.3), mode="power")
    torch.testing.assert_close(got, want, **TOL)
    assert bool((want != 0).any(dim=-1).float().mean() > 0.05)
    assert launches == {"nee_light": len(flat.light_indices), "nee_shade": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell_lights", "cornell_lights-vertex", "envmesh_probe",
                                  "cornell_lights-power"])
def test_sample_lights_grad_equals_plain(cuda, case, monkeypatch):
    which, form = (case.split("-") + [""])[:2]
    monkeypatch.setattr(trace, "MESH_VERTEX_GRADS", form == "vertex")
    flat = cases.leaf_scene(getattr(cases, which)().flatten(device=cuda), form == "vertex")
    args = cases.bounce_inputs(flat, R, 5, cuda, _eye(which))
    mode = "power" if form == "power" else "all"
    nee.reset_launch_counts()
    got, got_g = cases.nee_grads(flat, args, mode, PathUniforms(2147483717, cuda))
    assert nee.launch_counts["nee_shade"] >= 1  # the kernels ran forward
    launches = dict(nee.launch_counts)
    with monkeypatch.context() as mp:
        mp.setattr(nee, "fuses", lambda p: False)
        want, want_g = cases.nee_grads(flat, args, mode, PathUniforms(2147483717, cuda))
        again = cases.nee_grads(flat, args, mode, PathUniforms(2147483717, cuda))[1]
    assert nee.launch_counts == launches
    torch.testing.assert_close(got, want, **TOL)
    for g, w, w2 in zip(got_g, want_g, again):
        if w.shape[0] == R:  # a per-lane leaf: no sum across lanes
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        else:  # a table's: atomic adds across lanes, in no fixed order
            scale = float(w.abs().max().clamp_min(1e-30))
            dev, own = float((g - w).abs().max()) / scale, float((w2 - w).abs().max()) / scale
            print(f"{case} {tuple(w.shape)}: {dev:.3g} of the largest entry "
                  f"(plain again {own:.3g})")
            assert dev <= 1e-4
    assert sum(bool((w != 0).any()) for w in want_g) >= 8
