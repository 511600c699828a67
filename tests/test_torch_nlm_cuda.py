"""tinsel_tpu_torch on the card: the CUDA NLM kernels against their plain
PyTorch versions, and the renderer on the card against the CPU at equal
draws. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tinsel_tpu, so it also runs where JAX is
not installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_nlm_cuda.py

Tolerances: kernel vs plain 1e-5 (the kernel fuses multiply-adds and sums
in its own order); card vs CPU render as the JAX parity test
(tests/test_torch_render.py): 99.5% of pixels within atol 1e-4, rtol 1e-3.
"""

import numpy as np
import pytest
import torch

from tinsel_tpu_torch.core.sampling import NumpyUniforms
from tinsel_tpu_torch.ops import nlm as ops
from tinsel_tpu_torch.render import nlm as plain
from tinsel_tpu_torch.render.renderer import render
from tinsel_tpu_torch.scene.presets import cornell_scene


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _guides(rng, h, w):
    img = rng.random((h, w, 3)).astype(np.float32)
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    albedo = rng.random((h, w, 3)).astype(np.float32)
    depth = (rng.random((h, w, 1)) * 7).astype(np.float32)
    return img, normal, albedo, depth


def _on_card(a: np.ndarray, dev, offset: int = 0) -> torch.Tensor:
    """``a`` on the card; ``offset`` floats past an aligned base, so that
    a nonzero offset leaves the data 16-byte misaligned (cp.async path)."""
    buf = torch.empty(a.size + offset, dtype=torch.float32, device=dev)
    t = buf[offset:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    return t


# (shape, radius, falloff, misaligned floats, staging path). TMA takes
# widths that are multiples of 4 on aligned bases; the rest is cp.async.
# r = 1..3 run the compiled-radius search (interior tiles where the image
# has them, edge tiles always), r = 0 and 5 and a negative falloff the
# runtime-r search; r = 8 needs a single stage of shared memory. Images
# with fewer tiles than the card has CTA slots run K1 with 8 warps of 4
# rows, larger ones with 4 warps of 8 rows.
K1_CASES = [
    ((37, 53), 1, 200.0, 0, "cp.async"),
    ((37, 53), 2, 200.0, 0, "cp.async"),
    ((512, 512), 1, 200.0, 0, "tma"),
    ((1, 5), 3, 200.0, 0, "cp.async"),
    ((64, 128), 0, 200.0, 0, "tma"),
    ((96, 160), 2, 200.0, 0, "tma"),
    ((96, 160), 3, 200.0, 0, "tma"),
    ((70, 77), 3, 200.0, 0, "cp.async"),
    ((100, 132), 5, 200.0, 0, "tma"),
    ((45, 64), 8, 200.0, 0, "tma"),
    ((64, 64), 1, 200.0, 1, "cp.async"),
    ((33, 40), 1, -5.0, 0, "tma"),
    ((2160, 3840), 1, 200.0, 0, "tma"),
    # more tiles than CTA slots: the 8-rows-a-thread shape
    ((1100, 1000), 3, 200.0, 0, "tma"),
    ((1100, 999), 2, 200.0, 0, "cp.async"),
    ((1100, 1000), 5, 200.0, 0, "tma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius,falloff,offset,path", K1_CASES)
def test_nlm_filter_kernel_matches_plain(cuda, shape, radius, falloff, offset, path):
    a = np.random.default_rng(0).random((*shape, 3)).astype(np.float32)
    img = _on_card(a, cuda, offset)
    before = ops.launch_counts["nlm_filter"]
    out = ops.nlm_filter_cuda(img, falloff, radius)
    torch.cuda.synchronize()
    assert ops.launch_counts["nlm_filter"] == before + 1
    assert ops.last_geometry["nlm_filter"].path == path
    ref = plain.nlm_filter(img, falloff, radius)
    assert float((out - ref).abs().max()) <= 1e-5


# (shape, falloff, radius, guide factors, depth all zeros, misaligned
# floats, staging path)
K2_CASES = [
    ((33, 49), 40.0, 2, (8.0, 50.0, 1.0), False, 0, "cp.async"),
    ((512, 512), 200.0, 2, (8.0, 50.0, 1.0), False, 0, "tma"),
    ((64, 96), 40.0, 1, (8.0, 50.0, 1.0), False, 0, "tma"),
    ((70, 45), 40.0, 3, (8.0, 50.0, 1.0), False, 0, "cp.async"),
    ((96, 128), 40.0, 3, (8.0, 50.0, 1.0), False, 0, "tma"),
    ((40, 64), 40.0, 5, (8.0, 50.0, 1.0), False, 0, "tma"),
    ((48, 64), 40.0, 2, (8.0, 50.0, 1.0), True, 0, "tma"),
    ((64, 64), 40.0, 2, (8.0, 50.0, 1.0), False, 3, "cp.async"),
    ((40, 44), 40.0, 2, (8.0, 50.0, -1.0), False, 0, "tma"),
    ((1, 5), 40.0, 2, (8.0, 50.0, 1.0), False, 0, "cp.async"),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,falloff,radius,factors,flat_depth,offset,path", K2_CASES
)
def test_nlm_guided_kernel_matches_plain(cuda, shape, falloff, radius, factors,
                                         flat_depth, offset, path):
    arrays = list(_guides(np.random.default_rng(3), *shape))
    if flat_depth:  # max depth 0: the kernel divides by the 1e-6 clamp
        arrays[3] = np.zeros_like(arrays[3])
    x = [_on_card(a, cuda, offset) for a in arrays]
    kw = dict(falloff=falloff, radius=radius, f_normal=factors[0],
              f_albedo=factors[1], f_depth=factors[2])
    before = ops.launch_counts["nlm_guided"]
    out = ops.nlm_guided_cuda(*x, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts["nlm_guided"] == before + 1
    assert ops.last_geometry["nlm_guided"].path == path
    ref = plain.nlm_guided(*x, **kw)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_nlm_guided_kernel_propagates_a_nan_depth(cuda):
    """One NaN depth makes max(depth) NaN; the plain version then returns
    NaN everywhere, and so must the kernel."""
    arrays = list(_guides(np.random.default_rng(4), 40, 64))
    arrays[3][7, 11, 0] = np.nan
    x = [_on_card(a, cuda) for a in arrays]
    out = ops.nlm_guided_cuda(*x, falloff=40.0, radius=2)
    ref = plain.nlm_guided(*x, falloff=40.0, radius=2)
    assert bool(torch.isnan(ref).all())
    assert bool(torch.isnan(out).all())


@pytest.mark.cuda
def test_kernels_launch_on_a_second_card(cuda):
    """Each card needs its own shared-memory opt-in: launch on the first
    card, then on the second while the first stays current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    arrays = _guides(np.random.default_rng(6), 64, 96)
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        x = [_on_card(a, dev) for a in arrays]
        with torch.cuda.device(0):
            out1 = ops.nlm_filter_cuda(x[0], 200.0, 2)
            out2 = ops.nlm_guided_cuda(*x, falloff=40.0, radius=2)
        assert out1.device == out2.device == dev
        assert float((out1 - plain.nlm_filter(x[0], 200.0, 2)).abs().max()) <= 1e-5
        ref2 = plain.nlm_guided(*x, falloff=40.0, radius=2)
        assert float((out2 - ref2).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_dispatchers_launch_the_kernels(cuda):
    x = [torch.from_numpy(a).to(cuda) for a in _guides(np.random.default_rng(5), 16, 20)]
    ops.reset_launch_counts()
    ops.nlm_denoise(x[0])
    ops.nlm_guided_denoise(*x)
    assert ops.launch_counts == {"nlm_filter": 1, "nlm_guided": 1}


@pytest.mark.cuda
def test_kernel_backward_matches_the_cpu(cuda):
    """The backward is autograd of the plain version on either device."""
    img = np.random.default_rng(1).random((24, 40, 3)).astype(np.float32)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        x = torch.from_numpy(img).to(dev).requires_grad_(True)
        (ops.nlm_filter_cuda(x) ** 2).sum().backward()
        grads.append(x.grad.cpu())
    torch.testing.assert_close(grads[0], grads[1], atol=2e-5, rtol=0.0)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    img = torch.zeros((8, 8, 3), device=cuda)
    with pytest.raises(TypeError):
        ops.nlm_filter_cuda(img.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.nlm_filter_cuda(img.transpose(0, 1))
    with pytest.raises(ValueError, match="shape"):
        ops.nlm_guided_cuda(img, img, img, torch.zeros((8, 8, 2), device=cuda))
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        ops.nlm_guided_cuda(img, img, img.cpu(), torch.zeros((8, 8, 1), device=cuda))


@pytest.mark.cuda
def test_render_on_the_card_matches_the_cpu(cuda):
    out = [
        render(cornell_scene(24, 16, 3), spp=2, device=d, source=NumpyUniforms(5, d))
        .cpu().numpy()
        for d in (cuda, torch.device("cpu"))
    ]
    a, b = out
    assert np.isfinite(a).all() and a[..., 3].min() > 0.0
    close = np.isclose(a, b, atol=1e-4, rtol=1e-3).all(axis=-1)
    assert close.mean() >= 0.995, close.mean()
