"""Interactive progressive viewer: a small built-in HTTP page around the
chunked accumulate loop (port of ``tinsel_tpu/app/viewer.py``).

The render loop keeps accumulating passes on the device and re-encodes
the resolved PNG; the page polls it and posts control changes (exposure,
mode, denoise off / NLM (kernel K1) / guided NLM (kernel K2), pause,
restart, and fly-camera move/rotate from keyboard events). Any change that
alters the image resets the accumulation buffer. A restart draws pass 0's
samples again (``PathUniforms``: a pass's draws depend on the seed and the
pass index only).

Fly camera: w/s/a/d translate forward/back/left/right, q/e down/up, arrow
keys yaw/pitch, [ ] halve/double the move speed; position plus yaw/pitch
kept on the host and recomposed into the camera quaternion per change.

Usage: ``python -m tinsel_tpu_torch scene.tin -view [-port 8000]``, then
open http://localhost:8000/.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..core.math import quat_rotate

_PAGE = """<!doctype html>
<html><head><title>tinsel-tpu viewer</title><style>
body {{ background:#15171a; color:#dfe3e8; font:14px system-ui; margin:24px }}
img {{ image-rendering: pixelated; width:{disp_w}px; border:1px solid #333 }}
button {{ margin:2px; padding:4px 10px }}
#bar {{ margin:8px 0 }}
</style></head><body>
<h3>tinsel-tpu — progressive viewer</h3>
<div id="bar">
<button onclick="ctl('mode=pathtrace')">pathtrace</button>
<button onclick="ctl('mode=normals')">normals</button>
<button onclick="ctl('mode=complexity')">complexity</button>
<button onclick="ctl('exposure=down')">exposure −</button>
<button onclick="ctl('exposure=up')">exposure +</button>
<button onclick="ctl('denoise=toggle')">denoise</button>
<button onclick="ctl('pause=toggle')">pause</button>
<button onclick="ctl('restart=1')">restart</button>
<span id="status"></span>
</div>
<img id="view" src="/frame.png">
<script>
function ctl(q) {{ fetch('/ctl?' + q); }}
// fly camera: WASD + QE move, arrows look, [ ] speed (main.cpp:417-529)
const KEYS = {{
  'w':'move=f', 's':'move=b', 'a':'move=l', 'd':'move=r',
  'q':'move=d', 'e':'move=u',
  'ArrowLeft':'rot=l', 'ArrowRight':'rot=r',
  'ArrowUp':'rot=u', 'ArrowDown':'rot=d',
  '[':'speed=down', ']':'speed=up',
  '1':'mode=normals', '2':'mode=complexity', '3':'mode=pathtrace',
}};
document.addEventListener('keydown', ev => {{
  const q = KEYS[ev.key];
  if (q) {{ ctl(q); ev.preventDefault(); }}
}});
setInterval(() => {{
  document.getElementById('view').src = '/frame.png?' + Date.now();
  fetch('/status').then(r => r.json()).then(s => {{
    document.getElementById('status').textContent =
      ` ${{s.spp}} spp  ${{s.ms_per_spp.toFixed(1)}} ms/spp  ` +
      `exposure ${{s.exposure.toFixed(2)}}  mode ${{s.mode}}` +
      (s.cam_pos ? `  cam [${{s.cam_pos.map(v => v.toFixed(2))}}]` : '') +
      (s.denoise !== 'off' ? `  [${{s.denoise.toUpperCase()}}]` : '') + (s.paused ? '  [paused]' : '');
  }});
}}, 500);
</script></body></html>"""


class FlyCamera:
    """Host-side fly-camera state: position plus yaw (about world +Y) and
    pitch (about local +X), composed into the scene camera's quaternion on
    each change; roll is dropped."""

    def __init__(self, position, rotation, speed: float):
        self.position = np.asarray(position, np.float32).copy()
        fwd = quat_rotate(torch.as_tensor(np.asarray(rotation, np.float32)),
                          torch.tensor([0.0, 0.0, -1.0])).numpy()
        self.pitch = float(np.arcsin(np.clip(fwd[1], -1.0, 1.0)))
        self.yaw = float(np.arctan2(-fwd[0], -fwd[2]))
        self.speed = speed

    def quat(self) -> np.ndarray:
        cy, sy = np.cos(self.yaw * 0.5), np.sin(self.yaw * 0.5)
        cp, sp = np.cos(self.pitch * 0.5), np.sin(self.pitch * 0.5)
        # qy(yaw) * qx(pitch), [x, y, z, w]
        return np.asarray(
            [cy * sp, sy * cp, -sy * sp, cy * cp], np.float32
        )

    def move(self, cmd: str):
        fwd = np.asarray(
            [-np.sin(self.yaw) * np.cos(self.pitch),
             np.sin(self.pitch),
             -np.cos(self.yaw) * np.cos(self.pitch)], np.float32
        )
        right = np.asarray([np.cos(self.yaw), 0.0, -np.sin(self.yaw)],
                           np.float32)
        up = np.asarray([0.0, 1.0, 0.0], np.float32)
        step = {
            "f": fwd, "b": -fwd, "l": -right, "r": right, "u": up, "d": -up,
        }.get(cmd)
        if step is not None:
            self.position = self.position + self.speed * step

    def rotate(self, cmd: str, angle: float = np.deg2rad(5.0)):
        if cmd == "l":
            self.yaw += angle
        elif cmd == "r":
            self.yaw -= angle
        elif cmd == "u":
            self.pitch = min(self.pitch + angle, np.pi / 2 - 1e-3)
        elif cmd == "d":
            self.pitch = max(self.pitch - angle, -np.pi / 2 + 1e-3)


class ViewerState:
    """What the HTTP handler and the render loop share, under ``lock``."""

    def __init__(self, exposure: float, fly: "FlyCamera | None" = None):
        self.lock = threading.Lock()
        self.exposure = exposure
        self.mode = "pathtrace"
        self.denoise = "off"  # off | nlm | guided (AOV-guided joint NLM)
        self.paused = False
        self.restart = False
        self.png = b""
        self.spp = 0
        self.ms_per_spp = 0.0
        self.fly = fly
        self.cam_dirty = False


def _make_handler(state: ViewerState, disp_w: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Cache-Control", "no-store")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html", _PAGE.format(disp_w=disp_w).encode())
            elif url.path == "/frame.png":
                with state.lock:
                    png = state.png
                self._send(200, "image/png", png or b"")
            elif url.path == "/status":
                with state.lock:
                    fly = state.fly
                    body = json.dumps(dict(
                        spp=state.spp,
                        ms_per_spp=state.ms_per_spp,
                        exposure=state.exposure,
                        mode=state.mode,
                        denoise=state.denoise,
                        paused=state.paused,
                        cam_pos=None if fly is None else [float(v) for v in fly.position],
                        fly_speed=None if fly is None else fly.speed,
                    )).encode()
                self._send(200, "application/json", body)
            elif url.path == "/ctl":
                q = parse_qs(url.query)
                with state.lock:
                    if "exposure" in q:
                        state.exposure *= 1.25 if q["exposure"][0] == "up" else 0.8
                    if "denoise" in q:
                        cyc = ("off", "nlm", "guided")
                        state.denoise = cyc[(cyc.index(state.denoise) + 1) % len(cyc)]
                    if "pause" in q:
                        state.paused = not state.paused
                    if "mode" in q and q["mode"][0] in ("pathtrace", "normals", "complexity"):
                        if q["mode"][0] != state.mode:
                            state.mode = q["mode"][0]
                            state.restart = True
                    if "restart" in q:
                        state.restart = True
                    if state.fly is not None:
                        if "move" in q:
                            state.fly.move(q["move"][0])
                            state.cam_dirty = True
                        if "rot" in q:
                            state.fly.rotate(q["rot"][0])
                            state.cam_dirty = True
                        if "speed" in q:
                            state.fly.speed *= 2.0 if q["speed"][0] == "up" else 0.5
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def run_viewer(scene, options, seed: int = 0, port: int = 8000,
               nlm_falloff: float = 200.0, nlm_radius: int = 1,
               max_spp: int | None = None, stop_event=None, device=None):
    """Serve the viewer and run the progressive accumulate loop until
    ``stop_event`` is set (or ctrl-C); at ``max_spp`` it idles. Blocks.
    ``device``: None means cuda. Returns the accumulation buffer."""
    from ..core.color import resolve
    from ..core.sampling import PathUniforms
    from ..device import resolve_device
    from ..io.png import encode_png
    from ..ops.nlm import nlm_denoise, nlm_guided_denoise
    from ..render.aov import render_aovs
    from ..render.camera import CameraParams
    from ..render.renderer import make_accumulate_fn

    dev = resolve_device(device)
    # fly speed scaled to the camera's distance from the origin, so that
    # one step is a visible fraction of the frame on any scene scale
    fly = FlyCamera(
        scene.camera.position, scene.camera.rotation,
        speed=max(0.25, 0.05 * float(np.linalg.norm(scene.camera.position))),
    )
    state = ViewerState(exposure=options.exposure, fly=fly)
    disp_w = max(options.width * max(1, 512 // max(options.width, 1)), options.width)
    server = ThreadingHTTPServer(("127.0.0.1", port), _make_handler(state, disp_w))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer: http://localhost:{port}/  (ctrl-C to stop)")

    flat = scene.flatten(dev)
    cam = CameraParams.from_host(scene.camera, dev)
    source = PathUniforms(seed, dev)

    chunk = max(1, min(16, (1 << 20) // max(options.width * options.height, 1)))
    steps = {}

    def get_step(mode):
        if mode not in steps:
            o = dataclasses.replace(options, mode=mode)
            steps[mode] = make_accumulate_fn(o, chunk if mode == "pathtrace" else 1)
        return steps[mode]

    accum = torch.zeros((options.height, options.width, 4), dtype=torch.float32, device=dev)
    aovs = None  # the guided denoiser's guides, rendered again after a camera move
    spp = 0
    c = 0
    t0 = time.perf_counter()
    try:
        while stop_event is None or not stop_event.is_set():
            with state.lock:
                mode = state.mode
                if state.cam_dirty:
                    aovs = None
                    cam = dataclasses.replace(
                        cam,
                        position=torch.as_tensor(state.fly.position, device=dev),
                        rotation=torch.as_tensor(state.fly.quat(), device=dev),
                    )
                    state.cam_dirty = False
                    state.restart = True
                if state.restart:
                    accum = torch.zeros_like(accum)
                    spp = 0
                    c = 0
                    t0 = time.perf_counter()
                    state.restart = False
                paused = state.paused
                exposure = state.exposure
                denoise = state.denoise
            if paused or (max_spp is not None and spp >= max_spp):
                time.sleep(0.1)
                continue

            accum = get_step(mode)(accum, flat, cam, source, c)
            spp += chunk if mode == "pathtrace" else 1
            c += 1

            if mode == "pathtrace":
                img = resolve(accum, exposure=exposure, limit=options.limit)
                if denoise == "nlm":
                    img = nlm_denoise(img, nlm_falloff, nlm_radius)
                elif denoise == "guided":
                    if aovs is None:
                        aovs = render_aovs(flat, cam, options.width, options.height)
                    img = nlm_guided_denoise(
                        img, aovs["normal"], aovs["albedo"], aovs["depth"],
                        falloff=nlm_falloff,
                    )
            else:
                img = torch.clamp(accum[..., :3] / max(c, 1), 0.0, 1.0)
            png = encode_png(img.cpu().numpy())
            dt = time.perf_counter() - t0
            with state.lock:
                state.png = png
                state.spp = spp
                state.ms_per_spp = dt / max(spp, 1) * 1e3
    except KeyboardInterrupt:
        print("\nviewer stopped")
    finally:
        server.shutdown()
        server.server_close()
    return accum
