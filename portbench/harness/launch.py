"""A cell on several cards: the process that the command starts becomes the
launcher, which starts one rank process a card and waits for them.

Rank r runs the same command with ``RANK`` = ``LOCAL_RANK`` = r and
``WORLD_SIZE`` set, on ``cuda:r``; the ranks meet through a ``file://``
store under ``portbench/_data/rendezvous/`` (inside the checkout) and
join one process group through the port's ``init_distributed``. Rank 0
writes the run's one result object to a file beside the store; the
launcher prints it. Where a rank exits with another code than 0, or the
deadline passes, the launcher kills every rank's process group and the
run prints no result. A rank whose launcher is gone ends itself."""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

from .spec import HERE

RENDEZVOUS_DIR = HERE / "_data" / "rendezvous"
SETUP_ALLOWANCE_S = 1200.0  # the first run in a checkout builds the kernels
CHECK_ALLOWANCE_S = 600.0  # the reference's check after the window
_ENV = "PORTBENCH_RENDEZVOUS"


@dataclasses.dataclass
class RankEnv:
    """What the launcher hands a rank: the store's address, the file of the
    result, and the launcher's start on the shared monotonic clock."""
    rendezvous: str
    result: str
    t_start: float
    launcher: int  # the launcher's process id


def rank_env() -> RankEnv | None:
    """This process's rank environment, or None where it is no rank."""
    if _ENV not in os.environ:
        return None
    return RankEnv(os.environ[_ENV], os.environ["PORTBENCH_RESULT"],
                   float(os.environ["PORTBENCH_T0"]), int(os.environ["PORTBENCH_LAUNCHER"]))


class SetupMarks:
    """The ends of a rank's set-up phases, each in seconds from the
    launcher's start (the shared monotonic clock): a diagnostic written to
    standard error, not a metric."""

    def __init__(self, t0: float):
        self.t0, self.at = t0, []

    def __call__(self, phase: str, at: float | None = None):
        self.at.append((phase, (time.perf_counter() if at is None else at) - self.t0))

    def line(self, rank: int) -> str:
        return (f"portbench: rank {rank} set-up, each phase's end in s from the launcher's "
                "start: " + ", ".join(f"{p} {t:.3f}" for p, t in self.at))


def window_lines(rank: int, times: list, dispatch: list, usage) -> list:
    """A rank's window as diagnostic lines for standard error: each step's
    wall seconds, the host seconds the rank took to dispatch it (before it
    waits for its card and the all-reduce), and its process's CPU seconds
    over the window (``usage``: the ``resource.getrusage`` pair around it)."""
    u0, u1 = usage
    return [f"portbench: rank {rank} step s: " + " ".join(f"{t:.4f}" for t in times),
            f"portbench: rank {rank} dispatch s: " + " ".join(f"{t:.4f}" for t in dispatch),
            f"portbench: rank {rank} window CPU: user {u1.ru_utime - u0.ru_utime:.2f} s, "
            f"system {u1.ru_stime - u0.ru_stime:.2f} s"]


def deadline_s(seconds: float) -> float:
    return SETUP_ALLOWANCE_S + float(seconds) + CHECK_ALLOWANCE_S


def watch_launcher(env: RankEnv):
    """End this rank where its launcher is gone (killed without its
    cleanup): a daemon thread that compares the parent with the launcher."""
    def watch():
        while True:
            if os.getppid() != env.launcher:
                os._exit(70)
            time.sleep(1.0)
    threading.Thread(target=watch, name="portbench-launcher-watch", daemon=True).start()


def write_result(env: RankEnv, result: dict):
    tmp = f"{env.result}.tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, env.result)


def _kill_group(p: subprocess.Popen):
    """Kill a rank and whatever it started (its own session), then reap it."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    p.wait()


def run_ranks(cmd: list, world: int, deadline: float, t_start: float) -> dict | None:
    """Start ``world`` ranks of ``cmd`` and wait for them: rank 0's result
    object, or None (the reason on standard error) where a rank failed,
    the deadline passed or rank 0 wrote no result. Every rank's process
    group is killed before this returns; the ranks' standard output goes
    to standard error, so the launcher's is the result line alone."""
    RENDEZVOUS_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    store = RENDEZVOUS_DIR / f"{tag}.store"
    result = RENDEZVOUS_DIR / f"{tag}.result.json"
    for p in (store, result):
        p.unlink(missing_ok=True)
    procs = []
    old = signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))  # to the finally below
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                       PORTBENCH_RENDEZVOUS=f"file://{store}", PORTBENCH_RESULT=str(result),
                       PORTBENCH_T0=repr(float(t_start)), PORTBENCH_LAUNCHER=str(os.getpid()))
            procs.append(subprocess.Popen(cmd, env=env, stdout=sys.stderr,
                                          start_new_session=True))
        print(f"portbench: launcher started {world} ranks at "
              f"{time.perf_counter() - t_start:.3f} s", file=sys.stderr)
        end = time.monotonic() + deadline
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                print(f"portbench: rank {bad[0][0]} exited {bad[0][1]}; every rank stopped",
                      file=sys.stderr)
                return None
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > end:
                print(f"portbench: the ranks ran past their deadline of {deadline:.0f} s; "
                      "every rank stopped", file=sys.stderr)
                return None
            time.sleep(0.1)
        if not result.exists():
            print("portbench: rank 0 wrote no result", file=sys.stderr)
            return None
        return json.loads(result.read_text())
    finally:
        for p in procs:
            _kill_group(p)
        signal.signal(signal.SIGTERM, old)
        for p in (store, result, result.with_name(result.name + ".tmp")):
            p.unlink(missing_ok=True)
