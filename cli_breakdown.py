"""Where the CLI's render loop spends its time, on an NVIDIA GPU.

    python3 cli_breakdown.py          # from the repository root

Prints one JSON line per record:

1. ``scenes/veach_mis.json`` at its own 1280x720, depth 6, 4 spp (one spp
   a chunk, as the CLI cuts it): the CLI's accumulate loop as a plain
   loop in turns of four variants, ms per spp of each turn, in the order
   a b c d d c b a:
   a. the CLI's source, ``PathUniforms`` (a draw reseeds the device's
      generator from a hash of (seed, path));
   b. the same source seeded from ``np.random.SeedSequence`` instead
      of the hash (the cost of the seeding);
   c. a with the guard's health check (one reduction, one host read)
      after each chunk;
   d. one ``torch.Generator`` for all draws, the path ignored (the
      cost of reseeding at all).
   Also the draws a pass makes and the host microseconds a reseed costs.
2. the CLI in process on the same file, 4 spp, without a checkpoint
   (twice) and with ``-checkpoint-every 4`` (once): its own ms/spp line;
   then ``save_checkpoint`` of the 1280x720 buffer alone.
3. ``scenes/cornell.tin`` (256x256, depth 4, 64 spp): the CLI's line
   against the library's ``render`` of a scene loaded beforehand, in
   turns cli lib lib cli, with the library's flatten timed apart.

The card's name and power limit (nvidia-smi) lead the output.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CLI_LINE = re.compile(r"(\d+) spp in ([\d.]+)s \(([\d.]+) ms/spp, ([\d.]+) Mpaths/s\)")
VEACH_SPP = 4
CORNELL_SPP = 64


def emit(rec):
    print(json.dumps(rec), flush=True)


class SeedSequenceUniforms:
    """``PathUniforms`` seeded by ``np.random.SeedSequence([seed, *path])``
    a draw instead of the hash."""

    def __init__(self, seed, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def _seeded(self, path):
        state = np.random.SeedSequence([self.seed, *map(int, path)]).generate_state(1, np.uint64)
        self.generator.manual_seed(int(state[0]))
        return self.generator

    def uniform(self, path, shape):
        return torch.rand(tuple(shape), generator=self._seeded(path), device=self.device)

    def randint(self, path, shape, low, high):
        return torch.randint(low, high, tuple(shape), generator=self._seeded(path),
                             device=self.device)


class OneGenerator:
    """One ``torch.Generator`` for every draw; the path is ignored."""

    def __init__(self, seed, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def uniform(self, path, shape):
        return torch.rand(tuple(shape), generator=self.generator, device=self.device)

    def randint(self, path, shape, low, high):
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.device)


class Counting:
    """Counts the draws made through ``base``."""

    def __init__(self, base):
        self.base, self.draws = base, 0

    def uniform(self, path, shape):
        self.draws += 1
        return self.base.uniform(path, shape)

    def randint(self, path, shape, low, high):
        self.draws += 1
        return self.base.randint(path, shape, low, high)


def cli_line(argv):
    from tinsel_tpu_torch.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            sys.exit(f"cli_breakdown: the CLI failed on {argv}")
    m = CLI_LINE.search(buf.getvalue())
    if m is None:
        sys.exit(f"cli_breakdown: no timing line from {argv}")
    return float(m[3])


def loop_turns(dev, path: str, spp: int):
    from tinsel_tpu_torch.app import cli
    from tinsel_tpu_torch.core.sampling import PathUniforms
    from tinsel_tpu_torch.parallel.failure import chunk_health
    from tinsel_tpu_torch.render.camera import CameraParams
    from tinsel_tpu_torch.render.renderer import make_accumulate_fn

    sc = cli.load_scene(path)
    o = sc.options
    flat, cam = sc.flatten(dev), CameraParams.from_host(sc.camera, dev)
    chunk = max(1, min(spp, (1 << 20) // (o.width * o.height)))
    step = make_accumulate_fn(o, chunk)
    sources = {"a": PathUniforms, "b": SeedSequenceUniforms, "c": PathUniforms,
               "d": OneGenerator}

    def turn(v):
        src = sources[v](0, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accum = torch.zeros((o.height, o.width, 4), device=dev)
        for c in range(spp // chunk):
            accum = step(accum, flat, cam, src, c)
            if v == "c" and not chunk_health(accum):
                sys.exit(f"cli_breakdown: a non-finite chunk on {path}")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / spp

    turn("a")  # warm-up
    counted = Counting(PathUniforms(0, dev))
    step(torch.zeros((o.height, o.width, 4), device=dev), flat, cam, counted, 0)
    times = {v: [] for v in "abcd"}
    for v in "abcddcba":
        times[v].append(turn(v))
    reseed_us = {}
    for name, cls in (("path_uniforms", PathUniforms), ("seed_sequence", SeedSequenceUniforms)):
        src = cls(0, dev)
        t0 = time.perf_counter()
        for i in range(10_000):
            src._seeded((2, i % 6, 1, 3, i, 2))
        reseed_us[name] = (time.perf_counter() - t0) * 1e2
    emit(dict(record="loop", scene=path, spp=spp, spp_per_chunk=chunk,
              path_uniforms_ms_per_spp=times["a"], seed_sequence_ms_per_spp=times["b"],
              path_uniforms_with_health_check_ms_per_spp=times["c"],
              one_generator_ms_per_spp=times["d"], draws_per_pass=counted.draws,
              host_us_per_reseed=reseed_us))


def cli_veach(tmp: Path, dev):
    from tinsel_tpu_torch.parallel.checkpoint import save_checkpoint

    veach = str(ROOT / "scenes" / "veach_mis.json")
    base = [veach, "-spp", str(VEACH_SPP), "-o", str(tmp / "veach.png")]
    plain = [cli_line(base) for _ in range(2)]
    with_ck = cli_line([*base, "-checkpoint", str(tmp / "veach.npz"),
                        "-checkpoint-every", str(VEACH_SPP)])
    accum = torch.rand((720, 1280, 4), device=dev)
    write_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        save_checkpoint(str(tmp / "veach_alone.npz"), accum, VEACH_SPP, 0)
        write_s.append(time.perf_counter() - t0)
    emit(dict(record="cli", scene=veach, spp=VEACH_SPP, cli_ms_per_spp=plain,
              cli_with_checkpoint_ms_per_spp=with_ck, checkpoint_write_s=write_s,
              checkpoint_write_ms_per_spp=[s * 1e3 / VEACH_SPP for s in write_s]))


def cornell_turns(tmp: Path, dev):
    from tinsel_tpu_torch.app import cli
    from tinsel_tpu_torch.render.renderer import render

    cornell = str(ROOT / "scenes" / "cornell.tin")
    argv = [cornell, "-spp", str(CORNELL_SPP), "-o", str(tmp / "cornell.png")]
    cli_ms, lib_ms, flatten_s = [], [], []
    for who in ("cli", "lib", "lib", "cli"):
        if who == "cli":
            cli_ms.append(cli_line(argv))
            continue
        sc = cli.load_scene(cornell)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.flatten(dev)
        torch.cuda.synchronize()
        flatten_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        render(sc, spp=CORNELL_SPP, device=dev)
        torch.cuda.synchronize()
        lib_ms.append((time.perf_counter() - t0) * 1e3 / CORNELL_SPP)
    emit(dict(record="cornell", scene=cornell, spp=CORNELL_SPP, cli_ms_per_spp=cli_ms,
              library_ms_per_spp=lib_ms, library_flatten_s=flatten_s))


def main():
    if not torch.cuda.is_available():
        sys.exit("cli_breakdown: no CUDA device")
    if not (ROOT / "tinsel_tpu_torch").is_dir():
        sys.exit("cli_breakdown: run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import tempfile

    from tinsel_tpu_torch.device import resolve_device
    from tinsel_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    dev = resolve_device(None)
    _build.build_all(_build.SOURCES + tuple(_build.HOST_SOURCES))
    with tempfile.TemporaryDirectory(prefix="cli_breakdown_") as tmp:
        cli_line([str(ROOT / "scenes" / "cornell.tin"), "-spp", "4", "-o",
                  str(Path(tmp) / "warm.png")])  # first launches, outside every span
        loop_turns(dev, str(ROOT / "scenes" / "veach_mis.json"), VEACH_SPP)
        cli_veach(Path(tmp), dev)
        cornell_turns(Path(tmp), dev)


if __name__ == "__main__":
    main()
