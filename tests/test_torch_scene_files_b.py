"""(b) Image parity at equal draws on scene files, second third of the
golden scenes of tests/test_goldens.py (see test_torch_scene_files_a.py)."""

import pytest
import torch

from torch_parity import check_scene_file

torch.set_num_threads(2)
CASES = ["veach", "meshlight", "motionblur", "env"]


@pytest.mark.parametrize("name", CASES)
def test_scene_file_pass_matches_jax(name, tmp_path, monkeypatch):
    """veach: near-mirror plates lit by tiny, bright spheres, so its JAX
    render moves on 0.6-0.9% of the pixels when the camera moves by one ulp;
    it is held against that self-agreement (see check_scene_file)."""
    check_scene_file(name, tmp_path, monkeypatch, 10 + CASES.index(name),
                     ill_conditioned=name == "veach")
