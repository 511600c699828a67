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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,radius", [((37, 53), 1), ((37, 53), 2), ((512, 512), 1), ((1, 5), 3)]
)
def test_nlm_filter_kernel_matches_plain(cuda, shape, radius):
    img = torch.from_numpy(
        np.random.default_rng(0).random((*shape, 3)).astype(np.float32)
    ).to(cuda)
    before = ops.launch_counts["nlm_filter"]
    out = ops.nlm_filter_cuda(img, 200.0, radius)
    torch.cuda.synchronize()
    assert ops.launch_counts["nlm_filter"] == before + 1
    ref = plain.nlm_filter(img, 200.0, radius)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,falloff", [((33, 49), 40.0), ((512, 512), 200.0)])
def test_nlm_guided_kernel_matches_plain(cuda, shape, falloff):
    x = [torch.from_numpy(a).to(cuda) for a in _guides(np.random.default_rng(3), *shape)]
    before = ops.launch_counts["nlm_guided"]
    out = ops.nlm_guided_cuda(*x, falloff=falloff)
    torch.cuda.synchronize()
    assert ops.launch_counts["nlm_guided"] == before + 1
    ref = plain.nlm_guided(*x, falloff=falloff)
    assert float((out - ref).abs().max()) <= 1e-5


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
