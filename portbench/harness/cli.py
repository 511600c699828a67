"""``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of BENCHMARK.json on the card. The
last line of standard output is the result object; the numbers compared
with the reference, each beside its limit, are the last lines of standard
error and the result's last key. Without enough CUDA devices, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits with another code than 0.

A cell of one card runs in this process on ``cuda:0``. For a cell of
several, this process is the launcher (``harness/launch.py``): it writes
the configuration's stand-ins, starts one rank process of the same command
a card and prints the result that rank 0 hands it."""

from __future__ import annotations

import argparse
import json
import os
import sys

from .faults import SHARDED_FAULTS

FORBIDDEN = ("jax", "jaxlib", "flax", "tinsel_tpu")


def loaded_forbidden() -> list:
    """Top-level names, compared whole, of loaded modules that the run may
    not hold (``tinsel_tpu_torch`` is not ``tinsel_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("lowp",), default=None,
                   help="the reference in bfloat16 in the port's place (the control)")
    p.add_argument("--fault", choices=SHARDED_FAULTS, default=None,
                   help="a fault planted under the timed path (harness/faults.py)")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    from . import spec

    cell = spec.cell(args.workload)
    if cell.chips > 1:
        return ranks(args, argv, cell, t_start)
    import torch

    if not enough_cards(torch, cell):
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # one process, few threads: the host paces the port
    from .run_cell import run

    result = run(cell, args.seed, args.seconds, bool(args.trace), dev, t_start,
                 control=args.control, fault=args.fault)
    return report(result)


def enough_cards(torch, cell) -> bool:
    """Whether CUDA shows the cards the cell asks for; says so where not."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips:
        return True
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); {n} visible",
          file=sys.stderr)
    return False


def report(result: dict) -> int:
    """Print the result (the compared numbers on standard error, then the
    result line), unless the process holds a module it may not hold."""
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def launched(cmd: list, world: int, deadline: float, t_start: float) -> int:
    """The launcher: ``world`` ranks of ``cmd``, then rank 0's result."""
    from .launch import run_ranks

    result = run_ranks(cmd, world, deadline, t_start)
    return 5 if result is None else report(result)


def ranks(args, argv, cell, t_start: float) -> int:
    """A cell of several cards: in the launcher, start the ranks; in a rank,
    run its share on ``cuda:LOCAL_RANK`` and, in rank 0, hand over the
    result. The launcher neither imports torch nor asks CUDA: each rank
    looks for the cards, and a rank that finds too few ends the run with no
    result."""
    import time

    from . import spec
    from .launch import SetupMarks, deadline_s, rank_env, watch_launcher, write_result

    env = rank_env()
    if env is None:
        from .standins import scene_file

        scene_file(cell.config)  # written once, before the ranks read them
        print(f"portbench: launcher wrote the stand-ins at {time.perf_counter() - t_start:.3f} s",
              file=sys.stderr)
        return launched([sys.executable, str(spec.HERE / "run.py"), *argv], cell.chips,
                        deadline_s(args.seconds), t_start)
    marks = SetupMarks(env.t_start)
    marks("started", t_start)
    watch_launcher(env)
    import torch

    if not enough_cards(torch, cell):
        return 3
    dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    marks("torch and CUDA")
    from .run_cell import run_rank

    result = run_rank(cell, args.seed, args.seconds, bool(args.trace), dev, env.t_start,
                      env.rendezvous, control=args.control, fault=args.fault, marks=marks)
    found = loaded_forbidden()
    if found:
        print(f"portbench: rank {os.environ['RANK']} loaded {found}", file=sys.stderr)
        return 4
    if result is not None:
        write_result(env, result)
    return 0
