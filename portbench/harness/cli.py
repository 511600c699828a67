"""``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of BENCHMARK.json on the card. The
last line of standard output is the result object; the numbers compared
with the reference, each beside its limit, are the last lines of standard
error and the result's last key. Without enough CUDA devices, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits with another code than 0."""

from __future__ import annotations

import argparse
import json
import sys

from .faults import FAULTS

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
    p.add_argument("--fault", choices=FAULTS, default=None,
                   help="a fault planted under the timed path (harness/faults.py)")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    import torch

    from . import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); {n} visible",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # one process, few threads: the host paces the port
    from .run_cell import run

    result = run(cell, args.seed, args.seconds, bool(args.trace), dev, t_start,
                 control=args.control, fault=args.fault)
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
