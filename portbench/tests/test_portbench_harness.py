"""The harness on the CPU at small sizes: every configuration builds, every
traffic mix's loop runs, the reference agrees with the port's CPU path at
equal draws, the copied work functions count what ``chip_smoke.py``
counts, and BENCHMARK.json and the result line keep the contract's form."""

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from harness import spec
from harness.loops import LOOPS, load
from harness.run_cell import run
from harness.standins import scene_file

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")
SMALL = dict(width=16, height=16)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def small(cell_name: str, **traffic):
    """The cell with the traffic cut to a CPU test's size."""
    cell = spec.cell(cell_name)
    t = cell.traffic
    t["spp_per_pass"] = 2
    if t["loop"] == "viewer":
        t["move_every"] = 2
    t.update(traffic)
    return cell


def small_ajaxenv(tmp_path):
    """ajaxenv with its stand-ins at a small size, written into tmp_path."""
    cell = small("ajaxenv.render")
    st = cell.config["standins"]
    st["mesh"] = dict(st["mesh"], detail=12)
    st["probe"] = dict(st["probe"], width=64, height=32)
    return cell, scene_file(cell.config, tmp_path)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_configuration_builds(config, tmp_path):
    import reference.side as ref
    from harness import port

    cfg = dict(json.loads((ROOT / next(c["file"] for c in BENCH["configs"]
                                       if c["name"] == config)).read_text()), name=config)
    if cfg.get("standins"):
        cfg["standins"]["mesh"]["detail"] = 12
        cfg["standins"]["probe"].update(width=64, height=32)
    path = scene_file(cfg, tmp_path)
    for side in (port, ref):
        scene = side.load_tin(path)
        assert (scene.options.width, scene.options.height) == (cfg["width"], cfg["height"])
        assert scene.options.max_depth == cfg["maxDepth"]
        flat = scene.flatten(CPU)
        assert flat.prims.start_p.shape[0] == len(scene.primitives)
    if cfg.get("standins"):
        tris = [len(p.mesh.indices) for p in scene.primitives if p.mesh is not None]
        assert 2 * 12 ** 2 in tris


def test_standins_are_fixed_and_reused(tmp_path):
    cell, path = small_ajaxenv(tmp_path)
    files = sorted(tmp_path.iterdir())
    stamp = {p.name: p.stat().st_mtime_ns for p in files}
    blobs = {p.name: p.read_bytes() for p in files}
    assert scene_file(cell.config, tmp_path) == path
    assert {p.name: p.stat().st_mtime_ns for p in tmp_path.iterdir()} == stamp
    other = tmp_path / "again"
    scene_file(cell.config, other)
    for name in ("igea_standin.ply", "loft_standin.hdr"):
        assert (other / name).read_bytes() == blobs[name]


@pytest.mark.parametrize("traffic", ["render", "viewer"])
def test_loop_runs(traffic):
    from harness import port

    cell = small(f"cornell.{traffic}")
    loop = LOOPS[cell.traffic["loop"]](port, cell, 7, CPU, SMALL)
    for _ in range(3):
        loop.iterate()
    assert loop.done == 3 and loop.kept.items


@pytest.mark.parametrize("cell_name", [w["name"] for w in BENCH["workloads"]])
def test_reference_agrees_with_port_on_cpu(cell_name, tmp_path, monkeypatch):
    """At equal draws through the frozen PathUniforms copy, the port's CPU
    path (its plain versions) and the reference read no gap."""
    if cell_name.startswith("ajaxenv"):
        cell, path = small_ajaxenv(tmp_path)
        monkeypatch.setattr("harness.loops.scene_file", lambda cfg: path)
        sizes = dict(SMALL, max_depth=3)
    else:
        cell, sizes = small(cell_name), SMALL
    out = run(cell, 2**31 + 12345, 0.2, False, CPU, 0.0, overrides=sizes)
    assert out["correct"]
    # a pass's increment is read back from a float32 sum (after - before),
    # which rounds: no value is off, and the summed gap is that rounding
    assert out["checks"]["px_off"]["value"] == 0.0, out["checks"]
    assert out["checks"]["rel_l1"]["value"] < 1e-6, out["checks"]
    if cell.traffic["loop"] == "viewer":
        assert out["checks"]["rel_l1"]["value"] == 0.0, out["checks"]
        return
    # each pass itself, from an empty buffer, is the same bit for bit
    import reference.side as ref
    from harness import port
    from harness.uniforms import PathUniforms

    passes = []
    for side in (port, ref):
        scene, flat, cam = load(side, cell.config, CPU, sizes)
        step = side.make_accumulate_fn(scene.options, cell.traffic["spp_per_pass"])
        source = PathUniforms(2**31 + 12345, CPU)
        zero = torch.zeros((scene.options.height, scene.options.width, 4))
        passes.append([step(zero, flat, cam, source, k) for k in (0, 1, 7)])
    for a, b in zip(*passes):
        assert torch.equal(a, b)


def test_work_functions_count_as_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import reference.side as ref
    from harness import port, work
    from reference.tinsel_ref.accel import sweep as plain_sweep
    from reference.tinsel_ref.accel import traverse as plain_walk
    from harness.records import pack_records

    assert (work.HBM_BYTES_PER_S, work.FP32_OPS_PER_S) == (chip_smoke.HBM_BYTES_PER_S,
                                                           chip_smoke.FP32_OPS_PER_S)
    cell = small("cornell.render")
    _, flat_p, cam = load(port, cell.config, CPU, SMALL)
    _, flat_r, _ = load(ref, cell.config, CPU, SMALL)
    g = torch.Generator().manual_seed(3)
    o = torch.tensor([0.0, 1.0, -3.4]).expand(512, 3).contiguous()
    d = torch.nn.functional.normalize(torch.randn(512, 3, generator=g) * 0.3
                                      + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    t = torch.zeros(512)
    tmax = torch.full((512,), 3.0)
    for closest in (True, False):
        st = {}
        if closest:
            plain_sweep.sweep_closest(flat_r, o, d, t, stats=st)
        else:
            plain_sweep.sweep_any(flat_r, o, d, t, tmax, stats=st)
        mine = work.sweep_work(plain_sweep.layout(flat_r.prim_static, True),
                               pack_records(flat_r)[0].size, st, closest)
        assert mine == chip_smoke.sweep_work(flat_p, st, closest)
        assert work.bound_ms(mine) == chip_smoke.bound(mine)[0]
    # a walk on a mesh of its own
    from reference.tinsel_ref.scene.procedural import sphere

    pool, handle = _mesh_pool(sphere(radius=1.0, n_theta=40, n_phi=40))
    args = (pool, handle.node_offset, handle.tri_offset, torch.zeros(256, 3),
            torch.nn.functional.normalize(torch.randn(256, 3, generator=g), dim=-1),
            torch.where(torch.arange(256) % 5 == 0, 0.0, 10.0), handle.stack_slots)
    st = {}
    plain_walk.intersect_mesh(*args[:6], stack_slots=args[6], stats=st)
    want = chip_smoke.walk_bounds(plain_walk.intersect_mesh, args, st, 8)[0]
    assert math.isclose(work.walk_bound_ms(plain_walk.intersect_mesh, args, 8), want)


def _mesh_pool(mesh):
    """(pool, handle) of one mesh, flattened by the reference."""
    from reference.tinsel_ref.scene.model import MESH, Primitive, Scene

    sc = Scene()
    sc.add_primitive(Primitive(type=MESH, mesh=mesh))
    flat = sc.flatten(CPU)
    h = next(p.mesh for p in flat.prim_static if p.mesh is not None)
    return flat.pool, h


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert list(cells) == ["cornell.render", "ajaxenv.render", "cornell.viewer"]
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
        assert len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        if m["name"] != "setup_s":
            assert (HERE / "e2e" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        rep = [m for m in BENCH["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in rep} and len(rep) >= 2
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_result_line_keeps_the_contract():
    cell = small("cornell.render")
    out = run(cell, 5, 0.1, False, CPU, 0.0, overrides=SMALL)
    line = json.dumps(out)
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert set(back["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in back["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and isinstance(m["value"], float)
    for name, c in back["checks"].items():
        assert NAME.match(name) and set(c) == {"value", "limit"}


def test_traced_run_reads_layers_on_cpu():
    """The traced run's structure on the CPU: the profiler holds no device
    records here, so the device metrics find nothing to read and are left
    out; the result keeps its keys."""
    cell = small("cornell.render", trace_iterations=1)
    out = run(cell, 9, 0.1, True, CPU, 0.0, overrides=SMALL)
    assert out["correct"] and "breakdown" in out
    assert "idle_share.render" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_no_card_no_result():
    """Without a CUDA device the command prints no result and exits with
    another code than 0."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "cornell.render",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the command exits with another code than 0 and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_data", "__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cornell.render",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """A short run of the first cell on the card prints a correct result."""
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cornell.render",
                        "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert np.isfinite(out["metrics"]["Mpaths_per_s"]["value"])
