"""A rank for the tests of cells of several cards, started by the
launcher (``harness/launch.py``) with the rank's environment:

    python sharded_rank.py run '<spec>'    # run_rank at a test's size
    python sharded_rank.py raise '<spec>'  # rank 1 raises, the others wait
    python sharded_rank.py hang '<spec>'   # every rank waits past any deadline

``<spec>`` is a JSON object: ``cell`` (a workload of BENCHMARK.json),
``config`` (a configuration put in its place), ``overrides``,
``traffic`` (keys replaced in the cell's traffic, such as ``backend``), ``device``
("cpu" or "cuda": ``cuda:LOCAL_RANK``), ``seed``, ``seconds``, ``trace``,
``control``, ``fault``, and ``pids`` (a directory where each rank writes
its process id)."""

import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(mode: str, spec_: dict) -> int:
    from harness.launch import rank_env, watch_launcher, write_result

    env = rank_env()
    watch_launcher(env)
    rank = int(os.environ["RANK"])
    if spec_.get("pids"):
        Path(spec_["pids"], f"{rank}.pid").write_text(str(os.getpid()))
    if mode == "raise" and rank == 1:
        raise RuntimeError("a rank that raises")
    if mode in ("raise", "hang"):
        time.sleep(3600)
        return 0
    import torch

    from harness import spec
    from harness.run_cell import run_rank

    torch.set_num_threads(1)
    cell = spec.cell(spec_["cell"])
    if spec_.get("config"):
        bench = spec.benchmark()
        path = next(c["file"] for c in bench["configs"] if c["name"] == spec_["config"])
        cell.config = dict(json.loads((spec.ROOT / path).read_text()), name=spec_["config"])
    cell.traffic.update(spec_.get("traffic", {}))
    dev = torch.device("cpu")
    if spec_.get("device") == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    result = run_rank(cell, int(spec_["seed"]), float(spec_["seconds"]),
                      bool(spec_.get("trace")), dev, env.t_start, env.rendezvous,
                      overrides=spec_.get("overrides"), control=spec_.get("control"),
                      fault=spec_.get("fault"))
    if result is not None:
        write_result(env, result)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], json.loads(sys.argv[2])))
