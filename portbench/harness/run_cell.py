"""One run of one cell: set-up, the measured window (or the traced run),
then, with the port's state freed, the check against the reference.
``run`` returns the result object that ``harness/cli.py`` prints; it looks
for no card itself, so the tests drive it on the CPU at small sizes."""

from __future__ import annotations

import contextlib
import gc
import time

import torch

from . import check, trace as tracing
from .loops import LOOPS, sync
from .spec import Cell, metric_reader
from .switches import set_both


class Window:
    """What the end-to-end readers (``e2e/<name>.py``) read."""

    def __init__(self, loop, seconds: float):
        self.unit, self.paths = loop.unit, loop.paths
        self.times = []
        gc.collect()  # the collector stays on in the window, as users have it
        sync(loop.dev)
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            loop.iterate()
            b = time.perf_counter()
            self.times.append(b - a)
            if loop.stops(b - t0 >= seconds):
                break
        self.seconds = b - t0
        self.iterations = len(self.times)
        self.peak_bytes = torch.cuda.max_memory_allocated(loop.dev) if loop.dev.type == "cuda" \
            else 0


def _keep_sweep(kernel, i):
    return i < 4 or i % 16 == 0


def _keep_walk(kernel, i):
    return i < 2 or i % (16 if kernel == "bvh_closest" else 128) == 0


def _keep_rounds(kernel, i):
    return True  # a launch's bound reads its sizes alone


def traced(loop, port, tr: dict) -> tracing.Trace:
    """The traced run: a profiled segment, then for the renderer passes with
    the trace calls' spans and a pass with its K5 / K3 / K4 / K6 launches
    timed one by one (their inputs kept for the bounds), for the viewer
    frames with their host spans after the step."""
    t = tracing.Trace(loop.unit)
    tracing.profiled(loop, int(tr["trace_iterations"]), t, port.launch_counts)
    if loop.unit == "pass" and loop.dev.type == "cuda":  # events need a card
        for _ in range(int(tr["trace_iterations"])):
            with tracing.trace_spans(port, t):
                tracing.pass_span(loop, t)
        with tracing.kernel_spans(port.ops_sweep, _keep_sweep) as sweeps, \
                tracing.kernel_spans(port.ops_bvh, _keep_walk) as walks, \
                tracing.round_spans(port.ops_instances, _keep_rounds) as rounds:
            loop.iterate()
        t.captured = dict(sweep=sweeps, walk=walks, rounds=rounds)
    if loop.unit == "frame":
        loop.post = []
        for _ in range(int(tr["trace_iterations"])):
            loop.iterate()
        t.post_ms = [sum(spans) * 1e3 for spans in loop.post]
        loop.post = None
    return t


def kernel_bounds(t: tracing.Trace, cell, dev, overrides=None):
    """(bound ms, device ms) of each kept K5 / K3 / K4 / K6 launch, the
    bound counted by the reference's plain sweep and walk on the launch's
    own inputs, or, for K6, from its sizes (``harness/work.py``)."""
    import reference.side as ref
    from reference.tinsel_ref.accel import sweep as plain_sweep
    from reference.tinsel_ref.accel import traverse as plain_walk
    from .records import pack_records

    from . import work
    from .loops import load

    calls = t.captured
    if not calls:
        return
    _, flat, _ = load(ref, cell.config, dev, overrides)
    for kernel, args, (e0, e1) in calls["sweep"]:
        if args is None:
            continue
        _, o, d, times, tmax, _, hoist = args
        stats, closest = {}, kernel == "sweep_closest"
        if closest:
            plain_sweep.sweep_closest(flat, o, d, times, stats=stats, hoist=hoist)
        else:
            plain_sweep.sweep_any(flat, o, d, times, tmax, stats=stats, hoist=hoist)
        lay = plain_sweep.layout(flat.prim_static, hoist)
        nbytes_ops = work.sweep_work(lay, pack_records(flat, hoist=hoist)[0].size, stats, closest)
        t.kernel_calls.setdefault("sweep", []).append((work.bound_ms(nbytes_ops),
                                                       e0.elapsed_time(e1)))
    for kernel, args, (e0, e1) in calls["walk"]:
        if args is None:
            continue
        closest = kernel == "bvh_closest"
        fn = plain_walk.intersect_mesh if closest else plain_walk.intersect_mesh_any
        b = work.walk_bound_ms(fn, args[:7], 8 if closest else 1)
        t.kernel_calls.setdefault("walk", []).append((b, e0.elapsed_time(e1)))
    for kernel, sizes, (e0, e1) in calls["rounds"]:
        if sizes is None:
            continue
        b = work.rounds_bound_ms(closest=kernel == "rounds_closest", **sizes)
        t.kernel_calls.setdefault("rounds", []).append((b, e0.elapsed_time(e1)))
    t.captured = None


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _side(control, fault):
    """(side, precision mode, quiet) of a run: the port, or the reference in
    bfloat16 in its place, broken by ``fault`` where one is given."""
    import reference.side as ref

    from . import port

    side, mode, quiet = port, contextlib.nullcontext(), None
    if control == "lowp":
        from reference.lowp import Bf16

        mode = Bf16()
        side, quiet = ref, mode.quiet
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    if fault is not None:
        from .faults import broken

        side = broken(side, fault)
    return side, mode, quiet


def _readings(cell, dev, window, trace_rec, setup_s) -> dict:
    """The cell's end-to-end metrics from the window, or its per-layer
    metrics from the traced run."""
    metrics = {}
    if trace_rec is not None:
        for m in cell.per_layer:
            v = metric_reader(m["name"])(trace_rec)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
            elif dev.type == "cuda" and cell.name in m.get("workloads", ()):
                # a metric that lists this cell has something to read on the
                # card: reading nothing means the yardstick lost its hook
                raise RuntimeError(f"per-layer metric {m['name']} read nothing in {cell.name}")
    else:
        for m in cell.end_to_end:
            v = metric_reader(m["name"], "e2e")(window) if m["name"] != "setup_s" else setup_s
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    return metrics


def _result(cell, dev, numbers, attempted, metrics, peak, trace_rec) -> dict:
    checks = check.judged(numbers, cell.limits["limits"])
    device = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                  kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  count=cell.chips, memory_peak_bytes=int(peak))
    out = dict(correct=check.correct(checks), attempted=attempted,
               failed=sum(1 for c in checks.values() if not c["value"] <= c["limit"]),
               metrics=metrics, device=device)
    if trace_rec is not None:
        device.update(busy_s=trace_rec.busy_s, window_s=trace_rec.window_s)
        out["breakdown"] = trace_rec.breakdown()
    out["checks"] = checks
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
        overrides=None, control=None, fault=None) -> dict:
    """The result of one run (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` when traced, ``checks`` last).
    ``control="lowp"`` puts the reference computed in bfloat16 in the
    port's place; ``fault`` breaks the timed path (``harness/faults.py``)."""
    import reference.side as ref

    from . import port

    set_both(port, ref, cell.config.get("switches"))
    side, mode, quiet = _side(control, fault)
    kind = cell.traffic["loop"]
    extra = {}
    if control is not None and kind == "accumulate":
        # the control renders only the rows the check will compare (each
        # lane's answer is its own): at a cell's full size its plain walk in
        # bfloat16 would take many minutes a pass
        height = (overrides or {}).get("height", cell.config["height"])
        band = check.bands(cell, seed, height, 1)[0]
        if band is not None:
            extra["band"] = band
    with mode:
        loop = LOOPS[kind](side, cell, seed, dev, overrides, quiet, **extra)
        setup_s = time.perf_counter() - t_start
        cuda = dev.type == "cuda"
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        window = trace_rec = None
        if trace:
            trace_rec = traced(loop, port, cell.traffic)
        else:
            window = Window(loop, seconds)
    peak = max(setup_peak, torch.cuda.max_memory_allocated(dev) if cuda else 0)
    kept = loop.kept.items
    attempted = window.iterations if window else trace_rec.iterations
    del loop
    _free(dev)

    if trace_rec is not None:
        kernel_bounds(trace_rec, cell, dev, overrides)
    metrics = _readings(cell, dev, window, trace_rec, setup_s)
    _free(dev)

    fn = check.check_accumulate if kind == "accumulate" else check.check_viewer
    numbers = fn(ref, kept, cell, seed, dev, overrides)
    return _result(cell, dev, numbers, attempted, metrics, peak, trace_rec)


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool, dev, t_start: float,
             rendezvous: str, overrides=None, control=None, fault=None,
             marks=None) -> dict | None:
    """One rank of a run of a cell of several cards (the ``sharded`` loop):
    join the process group (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` from
    the environment) at ``rendezvous`` over the traffic's ``backend``, set
    up, run the window (or the traced steps) in step with the other ranks,
    gather their peaks (and traces) to rank 0 and leave the group; then
    rank 0 checks its sample against the reference and returns the result,
    the other ranks None. ``t_start``: the launcher's start, so ``setup_s``
    runs from it to the window's start on every rank. ``marks``: the rank's
    ``SetupMarks`` so far; its set-up phases and, after the window, each
    step's times go to standard error (diagnostics, not metrics)."""
    import resource
    import sys

    import torch.distributed as dist

    import reference.side as ref

    from . import port
    from .launch import SetupMarks, window_lines

    marks = marks or SetupMarks(t_start)
    set_both(port, ref, cell.config.get("switches"))
    side, mode, quiet = _side(control, fault)
    marks("imports")
    port.init_distributed(rendezvous, backend=cell.traffic["backend"])
    rank = dist.get_rank()
    marks("process group")
    try:
        extra = dict(marks=marks)
        if control is not None:
            # as in run(): the control renders only the rows the check compares
            extra["band"] = lambda o: check.bands(cell, seed, o.height, 1, check.reach(o))[0]
        cuda = dev.type == "cuda"
        with mode:
            loop = LOOPS[cell.traffic["loop"]](side, cell, seed, dev, overrides, quiet, **extra)
            setup_s = time.perf_counter() - t_start
            sys.stderr.write(marks.line(rank) + "\n")
            setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            window = mine = None
            if trace:
                t = tracing.Trace(loop.unit)
                tracing.profiled(loop, int(cell.traffic["trace_iterations"]), t,
                                 port.launch_counts)
                mine = tracing.rank_summary(t)
            else:
                usage = [resource.getrusage(resource.RUSAGE_SELF)]
                window = Window(loop, seconds)
                usage.append(resource.getrusage(resource.RUSAGE_SELF))
                lines = window_lines(rank, window.times, loop.dispatch, usage)
                sys.stderr.write("".join(f"{line}\n" for line in lines))  # one write a rank
                sys.stderr.flush()
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, dict(peak=max(setup_peak, window_peak),
                                              window_peak=window_peak, trace=mine))
        kept = loop.kept.items
        attempted = window.iterations if window else int(cell.traffic["trace_iterations"])
        lead = loop.lead
        del loop
        _free(dev)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if not lead:
        return None
    trace_rec = tracing.RankTraces([g["trace"] for g in gathered]) if trace else None
    if window is not None:
        window.peak_bytes = max(g["window_peak"] for g in gathered)
    metrics = _readings(cell, dev, window, trace_rec, setup_s)
    numbers = check.check_accumulate(ref, kept, cell, seed, dev, overrides)
    return _result(cell, dev, numbers, attempted, metrics, max(g["peak"] for g in gathered),
                   trace_rec)
