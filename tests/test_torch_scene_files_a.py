"""(b) Image parity at equal draws on scene files, first third of the
golden scenes of tests/test_goldens.py: each package loads the file with
its own loader, and one 32x32 pass (depth at most 4) of the port, fed the
JAX package's draws, must match the JAX pass (99.5% of pixels within atol
1e-4 / rtol 1e-3, means within 1e-3; tests/torch_parity.py)."""

import pytest
import torch

from torch_parity import check_scene_file

torch.set_num_threads(2)
CASES = ["simple", "cornell", "gloss", "transmission"]


@pytest.mark.parametrize("name", CASES)
def test_scene_file_pass_matches_jax(name, tmp_path, monkeypatch):
    check_scene_file(name, tmp_path, monkeypatch, CASES.index(name))
