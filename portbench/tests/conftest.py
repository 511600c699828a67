"""The folder's tests import the harness (``portbench/``) and the port
(the checkout's root) by name. Under several pytest-xdist workers each
worker computes on one thread: workers that each spread over every core
wait on one another far longer than they compute."""

import importlib
import json
import os
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)
if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def switches_restored():
    """Every switch that a configuration of BENCHMARK.json sets, back as it
    was on both sides after each test: a run sets them for its process."""
    import reference.side as ref
    from harness import port, spec

    names = set()
    for c in spec.benchmark()["configs"]:
        names |= set(json.loads((spec.ROOT / c["file"]).read_text()).get("switches", {}))
    flags = [(importlib.import_module(f"{side.PACKAGE}.{name.rpartition('.')[0]}"),
              name.rpartition(".")[2]) for side in (port, ref) for name in sorted(names)]
    before = [getattr(mod, attr) for mod, attr in flags]
    yield
    for (mod, attr), value in zip(flags, before):
        setattr(mod, attr, value)
