"""Command-line renderer: the port of ``tinsel_tpu/app/cli.py``, with its
flags and behaviour.

    python -m tinsel_tpu_torch scenes/cornell.tin -spp 256 -o cornell.png

Flags: ``-spp -width -height -exposure -maxdepth -clamp``, ``-o``, batch
animation on a ``%d`` pattern in the scene name (each frame renders to
completion), ``-convert MESH`` (mesh -> ``.npz`` cache), ``-mode normals |
complexity``, ``-denoise`` (NLM, kernel K1) and ``-denoise-guided`` (the
AOV-guided NLM, kernel K2), ``-aov`` (normal/depth/albedo PFMs),
``-checkpoint/-resume/-checkpoint-every``, ``-guard-retries``, ``-seed``,
``-sampler``, ``-rr``, ``-adaptive``, ``-lights power``, ``-tonemap``,
``-progressive`` and ``-view`` (the HTTP viewer). One argument is the
port's own: ``-device`` (default ``cuda``; the run raises without a GPU,
and ``-device cpu`` is how to render on the CPU).

Samples: pass c of a render draws from ``PathUniforms(seed)`` under (c,),
a function of (seed, c) alone, as the JAX package's ``fold_in(key, c)``;
so a render resumed from a checkpoint continues the sample sequence of an
uninterrupted one, and a retried chunk draws anew (``ChunkGuard``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch


def build_parser():
    p = argparse.ArgumentParser(
        prog="tinsel-tpu-torch", description="path tracer on PyTorch and CUDA"
    )
    p.add_argument("scene", nargs="?", help=".tin/.json scene (use %%d for batch)")
    p.add_argument("-spp", type=int, default=None, help="samples per pixel")
    p.add_argument("-width", type=int, default=None)
    p.add_argument("-height", type=int, default=None)
    p.add_argument("-exposure", type=float, default=None)
    p.add_argument("-maxdepth", type=int, default=None)
    p.add_argument("-clamp", type=float, default=None)
    p.add_argument(
        "-aov", action="store_true",
        help="also write per-pixel normal/depth/albedo AOV PFMs next to "
        "the output image",
    )
    p.add_argument(
        "-adaptive", type=float, default=0.0, metavar="FRAC",
        help="adaptive sampling: each round spends the whole sample batch "
        "on the FRAC highest-variance 16x16 tiles (0 disables). "
        "Incompatible with -view/-checkpoint/-progressive",
    )
    p.add_argument(
        "-lights", choices=["all", "power"], default=None,
        help="NEE strategy: 'all' traces one shadow ray per light; 'power' "
        "picks one light per lane from a power CDF",
    )
    p.add_argument(
        "-rr", type=int, default=None, metavar="N",
        help="Russian-roulette start bounce (0 disables)",
    )
    p.add_argument(
        "-mode", choices=["pathtrace", "normals", "complexity"], default=None
    )
    p.add_argument(
        "-sampler", choices=["random", "stratified", "bluenoise"],
        default=None, help="pixel/shutter sampler",
    )
    p.add_argument(
        "-progressive", type=int, default=0, metavar="N",
        help="write a preview PNG every N spp",
    )
    p.add_argument("-o", "--output", default=None, help="output PNG path")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-tonemap", choices=["filmic", "reinhard"], default="filmic",
                   help="display transform; reinhard consumes options.limit")
    p.add_argument("-denoise", action="store_true", help="NLM pass on output")
    p.add_argument(
        "-denoise-guided", action="store_true",
        help="joint NLM guided by normal/depth/albedo AOVs (implies an AOV trace)",
    )
    p.add_argument("-nlm-falloff", type=float, default=200.0)
    p.add_argument("-nlm-radius", type=int, default=1)
    p.add_argument("-checkpoint", default=None, help="checkpoint file path")
    p.add_argument("-checkpoint-every", type=int, default=64)
    p.add_argument("-guard-retries", type=int, default=2,
                   help="per-chunk retry budget for NaN/device-failure "
                   "recovery (parallel/failure.py)")
    p.add_argument("-resume", action="store_true")
    p.add_argument("-convert", default=None, metavar="MESH",
                   help="convert a mesh to the .npz cache format (the JAX "
                   "package's schema) and exit")
    p.add_argument("-view", action="store_true",
                   help="interactive progressive viewer (HTTP)")
    p.add_argument("-port", type=int, default=8000)
    p.add_argument("-batch-start", type=int, default=0)
    p.add_argument("-batch-count", type=int, default=1_000_000)
    p.add_argument("-device", default="cuda",
                   help="torch device to render on (default cuda; raises "
                   "without a GPU; 'cpu' renders on the CPU)")
    return p


def load_scene(path: str):
    from ..scene.loaders.tin import load_tin
    from ..scene.loaders.tungsten import load_tungsten

    return load_tungsten(path) if path.endswith(".json") else load_tin(path)


def _apply_overrides(o, args):
    for name, val in (("max_samples", args.spp), ("width", args.width),
                      ("height", args.height), ("exposure", args.exposure),
                      ("max_depth", args.maxdepth), ("clamp", args.clamp)):
        if val is not None:
            setattr(o, name, val)


def render_one(scene, args, out_path: str, source=None):
    """Render ``scene`` with the parsed ``args`` and write ``out_path``.
    ``source``: the UniformSource of the render (default
    ``PathUniforms(args.seed)`` on the device). Returns the run's
    ChunkGuard, whose ``events`` log its anomalies (None for -adaptive)."""
    from ..core.color import resolve
    from ..core.sampling import PathUniforms
    from ..device import resolve_device
    from ..io.png import write_png
    from ..ops.nlm import nlm_denoise, nlm_guided_denoise
    from ..parallel.checkpoint import load_checkpoint, save_checkpoint
    from ..parallel.failure import ChunkGuard
    from ..render.aov import render_aovs, write_aovs
    from ..render.camera import CameraParams
    from ..render.renderer import make_accumulate_fn
    from ..utils.profiling import sync

    device = resolve_device(args.device)
    o = scene.options
    _apply_overrides(o, args)
    for name, val in (("rr_depth", args.rr), ("light_sampling", args.lights),
                      ("mode", args.mode), ("sampler", args.sampler)):
        if val is not None:
            setattr(o, name, val)

    if source is None:
        source = PathUniforms(args.seed, device)

    spp = o.max_samples if o.mode == "pathtrace" else 1

    if args.adaptive > 0.0 and o.mode == "pathtrace":
        if args.checkpoint or args.resume or args.progressive:
            raise SystemExit(
                "-adaptive does not combine with -checkpoint/-resume/"
                "-progressive (per-tile counts are not checkpointed)"
            )
        from ..render.adaptive import adaptive_render

        t0 = time.perf_counter()
        accum = sync(adaptive_render(
            scene, budget_spp=spp, seed=args.seed, options=o,
            frac=args.adaptive, device=device, source=source,
        ))
        dt = time.perf_counter() - t0
        print(
            f"adaptive: {spp} avg spp in {dt:.2f}s "
            f"({dt / max(spp, 1) * 1e3:.1f} ms/spp)"
        )
        write_png(out_path, resolve(accum, exposure=o.exposure, limit=o.limit,
                                    tonemap=args.tonemap).cpu().numpy())
        print(f"wrote {out_path}")
        return None
    flat = scene.flatten(device)
    cam = CameraParams.from_host(scene.camera, device)
    chunk = max(1, min(spp, (1 << 20) // max(o.width * o.height, 1)))
    if args.progressive:
        chunk = max(1, min(chunk, args.progressive))
    accum = torch.zeros((o.height, o.width, 4), dtype=torch.float32, device=device)
    start_spp = 0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        a, start_spp, _, _ = load_checkpoint(args.checkpoint)
        accum = torch.from_numpy(a).to(device)
        print(f"resumed {args.checkpoint} at {start_spp} spp")

    guard = ChunkGuard(retries=args.guard_retries,
                       salvage_path=args.checkpoint, seed=args.seed)
    t0 = time.perf_counter()
    s = start_spp
    ckpt_mark = s
    c = s // chunk
    while s < spp:
        this = min(chunk, spp - s)
        step = make_accumulate_fn(o, this)
        accum = guard.run(step, accum, flat, cam, source, c, spp_done=s)
        s += this
        c += 1
        if args.progressive and s % args.progressive == 0 and s < spp:
            img = resolve(accum, exposure=o.exposure, limit=o.limit,
                          tonemap=args.tonemap)
            base, ext = os.path.splitext(out_path)
            write_png(f"{base}_spp{s:05d}{ext or '.png'}", img.cpu().numpy())
            el = time.perf_counter() - t0
            print(
                f"{s} spp  render: ({el / max(s - start_spp, 1) * 1e3:.1f} "
                f"ms/spp) total: ({el * 1e3:.1f} ms)", flush=True
            )
        if args.checkpoint and s - ckpt_mark >= args.checkpoint_every:
            save_checkpoint(args.checkpoint, accum, s, args.seed)
            ckpt_mark = s
            print(f"checkpoint @ {s} spp")
    sync(accum)
    dt = time.perf_counter() - t0
    done = max(spp - start_spp, 1)
    print(
        f"{spp} spp in {dt:.2f}s ({dt / done * 1000:.1f} ms/spp, "
        f"{o.width * o.height * done / max(dt, 1e-9) / 1e6:.2f} Mpaths/s)"
    )

    aovs = None
    if o.mode in ("normals", "complexity"):
        img = torch.clamp(accum[..., :3], 0.0, 1.0)
    else:
        img = resolve(accum, exposure=o.exposure, limit=o.limit,
                      tonemap=args.tonemap)
        if args.denoise_guided:
            aovs = render_aovs(flat, cam, o.width, o.height)
            img = nlm_guided_denoise(
                img, aovs["normal"], aovs["albedo"], aovs["depth"],
                falloff=args.nlm_falloff,
            )
        elif args.denoise:
            img = nlm_denoise(img, args.nlm_falloff, args.nlm_radius)
    write_png(out_path, img.cpu().numpy())
    print(f"wrote {out_path}")
    if args.aov:
        if aovs is None:
            aovs = render_aovs(flat, cam, o.width, o.height)
        for pth in write_aovs(os.path.splitext(out_path)[0], aovs):
            print(f"wrote {pth}")
    return guard


def main(argv=None):
    args = build_parser().parse_args(argv)
    # (the JAX package enables XLA's persistent compile cache here; the
    # port compiles its kernels once into tinsel_tpu_torch/_build/)

    if args.convert:
        from ..scene.loaders.mesh_io import import_mesh, save_mesh_cache

        mesh = import_mesh(args.convert, cache=False)
        out = os.path.splitext(args.convert)[0] + ".npz"
        save_mesh_cache(out, mesh)
        print(f"converted {args.convert} -> {out}")
        return 0

    if not args.scene:
        print("error: no scene file given", file=sys.stderr)
        return 2

    if "%" in args.scene:  # batch animation mode
        frame = args.batch_start
        rendered = 0
        while rendered < args.batch_count:
            path = args.scene % frame
            if not os.path.exists(path):
                break
            out = args.output or f"frame_{frame}.png"
            out = out % frame if "%" in out else out
            render_one(load_scene(path), args, out)
            frame += 1
            rendered += 1
        return 0

    scene = load_scene(args.scene)
    if args.view:
        from .viewer import run_viewer

        _apply_overrides(scene.options, args)
        run_viewer(scene, scene.options, seed=args.seed, port=args.port,
                   nlm_falloff=args.nlm_falloff, nlm_radius=args.nlm_radius,
                   device=args.device)
        return 0
    out = args.output or os.path.splitext(os.path.basename(args.scene))[0] + ".png"
    render_one(scene, args, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
