"""What a run reads: ``BENCHMARK.json`` at the root of the checkout, and
the data files of the cell's configuration (``configs/<name>.json``),
traffic mix (``traffic/<name>.json``), limits (``limits/<cell>.json``)
and per-layer metric readers (``metrics/<name>.py``), each found by the
name that BENCHMARK.json gives it. No cell is named in code."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json, with "name"
    traffic: dict  # traffic/<traffic>.json, with "name"
    limits: dict  # limits/<cell>.json
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its data files."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = dict(_json(root / configs[w["config"]]["file"]), name=w["config"])
    traffic = dict(_json(HERE / "traffic" / f"{w['traffic']}.json"), name=w["traffic"])
    limits = _json(HERE / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(w["chips"]), config=cfg, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, folder: str = "metrics"):
    """``read(x)`` of ``<folder>/<name>.py``: a per-layer metric's value
    from a traced run (``metrics/``), or an end-to-end metric's from the
    measured window (``e2e/``); None where there is nothing to read."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
