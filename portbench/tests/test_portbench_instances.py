"""Scenes above ``INSTANCE_TOPK_MIN`` = 12 big instances, on the CPU at a
test's size: the reference walks every (instance, ray) lane and equals the
port's shortlist rounds (its plain path here); a cell of such a scene
reads correct and its control and faults do not; a mesh stand-in named by
many primitives and a configuration without a probe are written and
loaded; ajaxenv's stand-ins keep their bytes; the K6 launches' bound and
the traced hook that times them."""

import hashlib
import json
import math
import types
from pathlib import Path

import pytest
import torch

import reference.side as ref
from harness import port, spec, work
from harness import trace as tracing
from harness.faults import FAULTS
from harness.run_cell import _keep_rounds, run
from harness.standins import scene_file
from reference.tinsel_ref.render import trace as ref_trace
from test_portbench_harness import SMALL, small

CPU = torch.device("cpu")
KNOB = spec.ROOT / "scenes" / "assets" / "knob.ply"  # 2,208 triangles
GRID = 4  # 16 instances: above INSTANCE_TOPK_MIN


def instanced_tin(path: Path, mesh: str, grid: int = GRID) -> str:
    """A .tin of grid x grid primitives that instance ``mesh``, on a plane
    under a sphere light, at 32 x 32 and depth 3."""
    prims = "".join(
        f"primitive\n{{\n    type mesh\n    mesh {mesh}\n"
        f"    position {(ix - (grid - 1) / 2) * 0.9} 0.4 {(iy - (grid - 1) / 2) * 0.9}\n"
        f"    scale 0.4\n    material m{(iy * grid + ix) % 4}\n}}\n"
        for iy in range(grid) for ix in range(grid))
    mats = "".join(f"material m{k}\n{{\n    color {0.2 + 0.2 * k} 0.5 {0.8 - 0.2 * k}\n"
                   f"    roughness {0.2 + 0.2 * k}\n}}\n" for k in range(4))
    path.write_text(
        "options\n{\n    width 32\n    height 32\n    maxDepth 3\n}\n"
        "camera\n{\n    position 0 2.6 4.2\n    target 0 0.3 0\n    fov 45\n}\n"
        "sky\n{\n    horizon 0.1 0.1 0.12\n    zenith 0.02 0.03 0.06\n}\n"
        "material light\n{\n    emission 40 40 40\n    color 0 0 0\n}\n"
        "material ground\n{\n    color 0.5 0.5 0.5\n    roughness 0.7\n}\n" + mats +
        "primitive\n{\n    type plane\n    plane 0 1 0 0\n    material ground\n}\n"
        "primitive\n{\n    type sphere\n    radius 0.5\n    position 1 4 1\n"
        "    material light\n    lightSamples 1\n}\n" + prims)
    return str(path)


@pytest.fixture
def knobs(tmp_path):
    return instanced_tin(tmp_path / "knobs.tin", str(KNOB))


def _rays(n=2048, seed=1):
    """Rays from above the grid: half aimed at it, half in any direction."""
    g = torch.Generator().manual_seed(seed)
    o = torch.stack([torch.rand(n, generator=g) * 6 - 3, torch.rand(n, generator=g) * 2 + 0.05,
                     torch.rand(n, generator=g) * 6 - 3], -1)
    aim = torch.stack([torch.rand(n, generator=g) * 3 - 1.5, torch.rand(n, generator=g) * 0.8,
                       torch.rand(n, generator=g) * 3 - 1.5], -1) - o
    d = torch.where((torch.arange(n) % 2 == 0)[:, None], aim, torch.randn(n, 3, generator=g))
    return (o, torch.nn.functional.normalize(d, dim=-1), torch.zeros(n),
            torch.rand(n, generator=g) * 5)


@pytest.mark.parametrize("chunk", [ref_trace.CHUNK_LANES, 3 * 2048])
def test_reference_walks_every_instance_as_the_rounds(knobs, chunk, monkeypatch):
    """The reference's full batch (whole, or in chunks of three instances)
    and the port's shortlist rounds give the same closest hit (t, tri,
    instance; then t, prim and normal of the trace call) and the same
    shadow rays, bit for bit."""
    monkeypatch.setattr(ref_trace, "CHUNK_LANES", chunk)
    flat_r = ref.load_tin(knobs).flatten(CPU)
    flat_p = port.load_tin(knobs).flatten(CPU)
    o, d, times, tmax = _rays()
    tab_p = port.ops_instances.table(flat_p, CPU)
    assert len(tab_p.prims) == GRID * GRID > ref_trace.INSTANCE_TOPK_MIN
    best = torch.full((o.shape[0],), math.inf)
    mine = port.ops_instances.rounds_closest(flat_p, tab_p, o, d, times, best)
    theirs = ref_trace._full_batch_closest(flat_r, ref_trace._batch(flat_r, CPU), o, d, times,
                                           best)
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
    assert 0.2 < torch.isfinite(mine[0]).double().mean() < 0.95
    hp = port.integrator.trace_closest(flat_p, o, d, times)
    hr = ref_trace.trace_closest(flat_r, o, d, times)
    for name in ("t", "prim", "normal"):
        assert torch.equal(getattr(hp, name), getattr(hr, name)), name
    occ = port.lights.trace_any(flat_p, o, d, times, tmax)
    assert torch.equal(occ, ref_trace.trace_any(flat_r, o, d, times, tmax))
    assert 0.05 < occ.double().mean() < 0.95


def _knob_cell(path):
    cell = small("cornell.render")
    cell.config = dict(name="knobs", scene=path, width=32, height=32, maxDepth=3)
    return cell


SIZES = dict(width=32, height=32, max_depth=3)


def test_instanced_cell_is_correct(knobs):
    out = run(_knob_cell(knobs), 2**31 + 99, 0.2, False, CPU, 0.0, overrides=SIZES)
    assert out["correct"], out["checks"]
    assert out["checks"]["px_off"]["value"] == 0.0, out["checks"]


@pytest.mark.parametrize("broken", ["lowp", *FAULTS])
def test_instanced_control_and_faults_are_not_correct(knobs, broken):
    key = "control" if broken == "lowp" else "fault"
    out = run(_knob_cell(knobs), 4242, 0.2, False, CPU, 0.0, overrides=SIZES,
              **{key: broken})
    assert not out["correct"], out["checks"]


def test_standin_named_by_many_primitives_without_a_probe(tmp_path):
    """A mesh stand-in replaces every one of 16 primitives' paths, and a
    configuration without a probe stand-in writes none; the scene loads
    on both sides with one mesh, instanced 16 times. A path named once
    where ``mesh`` asks for exactly one, or not at all, fails."""
    scene = instanced_tin(tmp_path / "paniq.tin", "../../reference/data/meshes/brain.ply")
    st = {"seed": 3, "meshes": [{"replaces": "../../reference/data/meshes/brain.ply",
                                 "file": "brain_standin.ply", "detail": 10}]}
    cfg = dict(name="paniq", scene=scene, standins=st)
    out = tmp_path / "data"
    path = scene_file(cfg, out)
    assert sorted(p.name for p in out.iterdir()) == ["brain_standin.ply", "paniq.tin",
                                                     "standins.json"]
    assert Path(path).read_text().count(str(out / "brain_standin.ply")) == GRID * GRID
    assert json.loads((out / "standins.json").read_text()) == st
    for side in (port, ref):
        s = side.load_tin(path)
        meshes = {id(p.mesh) for p in s.primitives if p.mesh is not None}
        assert len(meshes) == 1 and sum(p.mesh is not None for p in s.primitives) == 16
        assert len(next(p.mesh for p in s.primitives if p.mesh is not None).indices) == 200
    with pytest.raises(ValueError, match="exactly one"):
        scene_file(dict(cfg, standins=dict(st, meshes=[], mesh=st["meshes"][0])),
                   tmp_path / "once")
    gone = dict(st["meshes"][0], replaces="meshes/none.ply")
    with pytest.raises(ValueError, match="at least one"):
        scene_file(dict(cfg, standins=dict(st, meshes=[gone])), tmp_path / "none")


# ajaxenv's stand-ins as the benchmark first wrote them (its scene file with
# the data directory written as <DATA>): the card keeps the files it has
AJAXENV_SHA256 = {
    "ajaxenv.tin": "db999d81e4cc6f6f2f4f3a3156aa0f83ec2714139e307f29b85512c8d2584c47",
    "igea_standin.ply": "480a42f55585e63898921487931962bb2a82e20f75630b07fd6c9fca4eceb2bf",
    "loft_standin.hdr": "784e3575536c81e5046f8ecb6a0210330b75cd01f32a298305bd9ed5bf6a5d95",
    "standins.json": "9e4e1b744fc75e7f56cc1176a65beecbcb81590f893bed2d686e15bda717a1d5",
}


def test_ajaxenv_standins_keep_their_bytes(tmp_path):
    scene_file(spec.cell("ajaxenv.render").config, tmp_path)
    got = {}
    for p in tmp_path.iterdir():
        b = p.read_bytes()
        if p.suffix == ".tin":
            b = b.replace(str(tmp_path).encode(), b"<DATA>")
        got[p.name] = hashlib.sha256(b).hexdigest()
    assert got == AJAXENV_SHA256


def test_rounds_bound_is_the_bytes_moved():
    """3 rays, 20 instances. K6c, static: 3 x (24 B of ray + 4 B best t + 16
    B of (t, tri, inst)) + 20 x 96 B of records = 2,052 B. K6a, moving: 3 x
    (24 + 4 B time + 4 B tmax + 1 B occlusion in + 1 B out) + 1,920 B =
    2,022 B. At 3.35 TB/s."""
    assert work.rounds_bound_ms(3, 20, False, True) == 2052 / 3.35e12 * 1e3
    assert work.rounds_bound_ms(3, 20, True, False) == 2022 / 3.35e12 * 1e3


class _Event:
    def __init__(self, **kw):
        self.t = 0.0

    def record(self):
        pass

    def elapsed_time(self, other):
        return 0.5


def _no_card(monkeypatch):
    """The hook's CUDA calls as no-ops, so that it runs on the CPU."""
    monkeypatch.setattr(tracing.torch.cuda, "Event", _Event)
    monkeypatch.setattr(tracing.torch.cuda, "_sleep", lambda n: None)
    monkeypatch.setattr(tracing.torch.cuda, "synchronize", lambda *a: None)


def test_round_spans_time_each_launch_with_its_sizes(monkeypatch):
    """Each launch that reaches the C entry is kept with its rays,
    instances and motion; a call with no rays launches nothing and keeps
    nothing; the module is whole again afterwards."""
    _no_card(monkeypatch)
    mod = types.SimpleNamespace(_entry=lambda kernel: (lambda *a: 0))

    def fake(kernel):
        def cuda(scene, tab, origins, *rest):
            if origins.shape[0]:
                mod._entry(kernel)(1, 2)
            return kernel
        return cuda

    mod.rounds_closest_cuda, mod.rounds_any_cuda = fake("rounds_closest"), fake("rounds_any")
    orig = dict(vars(mod))
    tab = types.SimpleNamespace(prims=tuple(range(20)), motion=False)
    with tracing.round_spans(mod, _keep_rounds) as calls:
        mod.rounds_closest_cuda(None, tab, torch.zeros(5, 3), None)
        mod.rounds_any_cuda(None, tab, torch.zeros(0, 3), None)
        mod.rounds_any_cuda(None, tab, torch.zeros(7, 3), None)
    assert [(k, kept) for k, kept, _ in calls] == [
        ("rounds_closest", dict(rays=5, instances=20, motion=False)),
        ("rounds_any", dict(rays=7, instances=20, motion=False))]
    assert vars(mod) == orig


def test_traced_hook_records_no_k6_on_cornell(monkeypatch):
    """A Cornell pass (no big mesh) under the hook launches no K6."""
    _no_card(monkeypatch)
    cell = small("cornell.render")
    from harness.loops import LOOPS

    loop = LOOPS["accumulate"](port, cell, 7, CPU, SMALL)
    with tracing.round_spans(port.ops_instances, _keep_rounds) as calls:
        loop.iterate()
    assert calls == []
