"""Cells of several cards on the CPU: the launcher starts one rank process
a card (here gloo ranks on the CPU, through ``tests/sharded_rank.py``),
the ``sharded`` loop reads correct, the control and every fault such a
cell can have read not correct, a failed or hung rank ends the run with
no result and no process left, and a cell of one card starts no rank."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness import check, cli, spec
from harness.faults import SHARDED_FAULTS

HERE = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("sharded_rank.py")
CELL = "ajaxenv.render.4gpu"
# the sharded cell on Cornell at a CPU test's size
SMALL = dict(cell=CELL, config="cornell", overrides=dict(width=32, height=32, max_depth=4),
             traffic=dict(spp_per_pass=2, backend="gloo"), device="cpu",
             seed=2**31 + 1234567, seconds=0.2)


def _launch(mode: str, spec_: dict, world: int = 4, deadline: float = 300.0):
    """The launcher (``harness/cli.py::launched``) in a process of its own,
    over ``world`` ranks of the worker: (completed process, seconds)."""
    code = ("import sys, time; sys.path[:0] = sys.argv[1:3]; "
            "from harness.cli import launched; "
            "sys.exit(launched([sys.executable] + sys.argv[3:6], int(sys.argv[6]), "
            "float(sys.argv[7]), time.perf_counter()))")
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code, str(HERE), str(HERE.parent), str(WORKER),
                        mode, json.dumps(spec_), str(world), str(deadline)],
                       capture_output=True, text=True, timeout=deadline + 120,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    return p, time.monotonic() - t0


def _result(p) -> dict:
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_sharded_loop_is_correct_over_gloo():
    out = _result(_launch("run", SMALL)[0])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"Mpaths_per_s", "peak_mem_GiB", "setup_s"}
    assert out["checks"]["px_off"]["value"] == 0.0, out["checks"]
    assert list(out)[-1] == "checks"


def test_sharded_traced_run_keeps_its_keys():
    """On the CPU the trace holds no device record: the three metrics find
    nothing to read and are left out; the result keeps its keys."""
    out = _result(_launch("run", dict(SMALL, trace=True, seed=77))[0])
    assert out["correct"] and "breakdown" in out and out["metrics"] == {}
    assert {"busy_s", "window_s"} <= set(out["device"]) and out["attempted"] == 2


@pytest.mark.parametrize("broken", ["lowp", *SHARDED_FAULTS])
def test_sharded_control_and_faults_are_not_correct(broken):
    key = "control" if broken == "lowp" else "fault"
    out = _result(_launch("run", dict(SMALL, **{key: broken}))[0])
    assert not out["correct"], out["checks"]


def test_sharded_readers_take_each_step_apart():
    """The all-reduce readers compare the ranks step by step: a rank that
    arrived last in one step and first in the next waited in one only."""
    from harness.spec import metric_reader
    from harness.trace import RankTraces

    def rank(ar, busy_s=0.5):
        return dict(iterations=2, window_s=2.0, busy_s=busy_s, allreduce_ms=ar, ops={}, gaps={})

    t = RankTraces([rank([0.2, 500.0]), rank([480.0, 0.3]), rank([100.0, 200.0]),
                    rank([0.4, 0.5], busy_s=1.0)])
    assert metric_reader("allreduce_ms.sharded")(t) == pytest.approx(0.25)
    waits = [499.7, 479.8, 99.8 + 199.7, 0.2 + 0.2]
    assert metric_reader("rank_wait_share.sharded")(t) == pytest.approx(
        100 * sum(w / 2000.0 for w in waits) / 4)
    assert metric_reader("idle_share.sharded")(t) == pytest.approx(100 * (3 * 0.75 + 0.5) / 4)
    short = RankTraces([rank([0.2, 500.0]), rank([480.0])])  # a rank's step not seen
    assert metric_reader("allreduce_ms.sharded")(short) is None
    assert metric_reader("rank_wait_share.sharded")(short) is None


@pytest.mark.parametrize("height,reach", [(500, 1), (32, 1), (32, 2), (64, 1)])
def test_straddling_band_holds_the_boundary(height, reach):
    cell = spec.cell(CELL)
    rows = cell.limits["rows"]
    for seed in range(200):
        (y0, y1), = check.bands(cell, 2**32 + seed, height, 1, reach)
        assert y1 - y0 == rows and 0 <= y0 and y1 <= height
        b = height // 2  # the (2, 2) mesh's one boundary
        assert y0 + reach <= b - reach and b + reach <= y1 - reach


@pytest.mark.parametrize("mode", ["raise", "hang"])
def test_failed_or_hung_rank_ends_the_run(mode, tmp_path):
    deadline = 20.0
    p, took = _launch(mode, dict(SMALL, pids=str(tmp_path)), deadline=deadline)
    assert p.returncode != 0 and p.stdout.strip() == "", p.stdout
    assert took < deadline + 30
    pids = [int(f.read_text()) for f in tmp_path.glob("*.pid")]
    assert pids
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_one_card_cell_starts_no_rank(monkeypatch):
    """A cell of one card runs in the command's own process: no launcher,
    no rank process."""
    import harness.launch
    import harness.run_cell

    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(harness.launch, "run_ranks", lambda *a, **k: pytest.fail("a launcher"))
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: pytest.fail("a process"))
    monkeypatch.setattr(harness.run_cell, "run",
                        lambda cell, *a, **k: ran.append(cell.name) or dict(checks={}))
    assert cli.main(["--workload", "cornell.render", "--seed", "1", "--seconds", "1"], 0.0) == 0
    assert ran == ["cornell.render"]


def test_four_card_cell_starts_a_rank_a_card(monkeypatch):
    """The command's process for a cell of four cards writes the stand-ins
    and launches four ranks of the same command, with the same arguments."""
    import harness.standins

    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness.standins, "scene_file", lambda cfg: started.append(cfg["name"]))
    monkeypatch.setattr(cli, "launched", lambda cmd, world, deadline, t0:
                        started.append((cmd, world, deadline, t0)) or 0)
    argv = ["--workload", CELL, "--seed", "9", "--seconds", "51", "--trace", "1",
            "--fault", "lost_share"]
    assert cli.main(argv, 12.5) == 0
    assert started == ["ajaxenv", ([sys.executable, str(HERE / "run.py"), *argv], 4,
                                   1200.0 + 51 + 600.0, 12.5)]


def test_launcher_starts_the_ranks_without_torch():
    """The launcher of a four-card cell imports neither torch nor CUDA
    before it starts the ranks (each rank imports its own)."""
    code = ("import sys; sys.path[:0] = sys.argv[1:3]; import harness.cli as cli, "
            "harness.standins as st; st.scene_file = lambda cfg: None; "
            "cli.launched = lambda *a: print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'torch', 'tinsel_tpu_torch', 'reference'})) or 0; "
            "sys.exit(cli.main(sys.argv[3:], 0.0))")
    out = subprocess.run([sys.executable, "-c", code, str(HERE), str(HERE.parent),
                          "--workload", CELL, "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_rank_without_enough_cards_ends_the_run(monkeypatch, capsys):
    """A rank that sees fewer cards than the cell asks for exits with
    another code than 0 before it runs anything."""
    import harness.run_cell

    for k, v in dict(PORTBENCH_RENDEZVOUS="file:///nowhere", PORTBENCH_RESULT="/nowhere",
                     PORTBENCH_T0="0.0", PORTBENCH_LAUNCHER=str(os.getppid()), RANK="1",
                     LOCAL_RANK="1", WORLD_SIZE="4").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr("harness.launch.watch_launcher", lambda env: None)
    monkeypatch.setattr(harness.run_cell, "run_rank", lambda *a, **k: pytest.fail("ran"))
    assert cli.main(["--workload", CELL, "--seed", "1", "--seconds", "1"], 0.0) == 3
    assert "needs 4 CUDA device(s); 3 visible" in capsys.readouterr().err


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_sharded_loop_on_one_card_over_nccl(card):
    """The sharded loop at world 1 on NCCL, Cornell at its own size."""
    spec_ = dict(cell=CELL, config="cornell", traffic=dict(mesh=[1, 1]), device="cuda",
                 seed=4000000123, seconds=2.0)
    out = _result(_launch("run", spec_, world=1)[0])
    assert out["correct"] and out["device"]["platform"] == "gpu", out["checks"]
