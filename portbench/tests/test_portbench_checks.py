"""The comparison fails what it should fail, at a size a test run can hold:
the control (the reference computed in bfloat16, put in the port's place)
and each fault a cell can have, planted under the timed path
(``harness/faults.py``), come out not correct in every cell of one card
(the cells of several cards: ``test_portbench_sharded.py``). The
harness's look for a card is skipped; the rest of a run is driven on the
CPU."""

import pytest
import torch

from harness.faults import FAULTS
from harness.run_cell import run
from test_portbench_harness import BENCH, SMALL, small, small_ajaxenv

CPU = torch.device("cpu")
CELLS = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]


def _cell(cell_name, tmp_path, monkeypatch):
    """The cell at a CPU test's size (ajaxenv: small stand-ins, depth 3)."""
    if cell_name.startswith("ajaxenv"):
        cell, path = small_ajaxenv(tmp_path)
        monkeypatch.setattr("harness.loops.scene_file", lambda cfg: path)
        return cell, dict(SMALL, max_depth=3)
    return small(cell_name), SMALL


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name, tmp_path, monkeypatch):
    cell, sizes = _cell(cell_name, tmp_path, monkeypatch)
    out = run(cell, 2**32 + 77, 0.2, False, CPU, 0.0, overrides=sizes, control="lowp")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_fault_is_not_correct(cell_name, fault, tmp_path, monkeypatch):
    cell, sizes = _cell(cell_name, tmp_path, monkeypatch)
    out = run(cell, 31337, 0.2, False, CPU, 0.0, overrides=sizes, fault=fault)
    assert not out["correct"], out["checks"]


def test_sound_run_is_correct():
    out = run(small("cornell.render"), 31337, 0.2, False, CPU, 0.0, overrides=SMALL)
    assert out["correct"], out["checks"]
