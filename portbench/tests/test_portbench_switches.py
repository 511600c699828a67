"""A configuration's ``switches`` (module flags of the port) are set under
the port and under the reference before anything loads, and a name that
either lacks fails the run."""

import importlib

import pytest
import torch

import reference.side as ref
from harness import port
from harness.run_cell import run
from harness.switches import set_both, set_switches
from test_portbench_harness import SMALL, small

NAME = "render.lights.NEE_CLOSEST_SHADOW"


@pytest.fixture
def restored():
    """Every flag of both sides as it was, after the test."""
    mods = [importlib.import_module(f"{side.PACKAGE}.render.lights") for side in (port, ref)]
    before = [m.NEE_CLOSEST_SHADOW for m in mods]
    yield mods
    for m, v in zip(mods, before):
        m.NEE_CLOSEST_SHADOW = v


def test_switch_is_set_on_both_sides(restored):
    assert set_switches(port.PACKAGE, {NAME: True}) == {NAME: False}
    set_both(port, ref, {NAME: True})
    assert [m.NEE_CLOSEST_SHADOW for m in restored] == [True, True]


def test_run_takes_the_configuration_switches(restored):
    """A cell whose configuration turns the closest-hit shadow on runs with
    it on both sides, and reads correct."""
    cell = small("cornell.render")
    cell.config["switches"] = {NAME: True}
    out = run(cell, 2**31 + 5, 0.2, False, torch.device("cpu"), 0.0, overrides=SMALL)
    assert [m.NEE_CLOSEST_SHADOW for m in restored] == [True, True]
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["render.lights.NO_SUCH_SWITCH", "render.no_module.FLAG",
                                  "FLAG"])
def test_unknown_switch_fails_the_run(name, restored):
    cell = small("cornell.render")
    cell.config["switches"] = {name: True}
    with pytest.raises(ValueError, match="unknown switch"):
        run(cell, 1, 0.1, False, torch.device("cpu"), 0.0, overrides=SMALL)
