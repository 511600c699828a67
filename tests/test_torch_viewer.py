"""The port's viewer (``tinsel_tpu_torch/app/viewer.py``) on the CPU.

``FlyCamera`` against tinsel_tpu's: initial yaw and pitch from a camera
quaternion, the composed quaternion, ``move`` and ``rotate``, all within
1e-6. Then the HTTP viewer on a free port, mirroring tests/test_viewer.py:
it serves the page, frames and status, refines, takes the controls
(exposure, the denoise cycle off -> nlm -> guided, pause, mode) and moves
its fly camera over HTTP, restarting the accumulation. Every wait has a
deadline of 30 s; the render thread is a daemon and must end when asked.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tinsel_tpu.app.viewer import FlyCamera as JFly
from tinsel_tpu_torch.app.viewer import FlyCamera as TFly
from tinsel_tpu_torch.app.viewer import run_viewer
from tinsel_tpu_torch.scene.presets import cornell_scene

torch.set_num_threads(2)
TOL = 1e-6
DEADLINE_S = 30


def _quat(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]]).astype(np.float32)


ROTATIONS = [np.array([0, 0, 0, 1], np.float32), _quat([0, 1, 0], 0.7),
             _quat([1, 0.3, -0.2], -1.1), _quat([0.2, -1, 0.5], 2.6)]


@pytest.mark.parametrize("k", range(len(ROTATIONS)))
def test_flycam_agrees_with_jax(k):
    pos = np.array([0.5, 1.0, -2.0], np.float32)
    j, t = JFly(pos, ROTATIONS[k], 1.5), TFly(pos, ROTATIONS[k], 1.5)
    assert abs(j.yaw - t.yaw) < TOL and abs(j.pitch - t.pitch) < TOL
    np.testing.assert_allclose(t.quat(), j.quat(), atol=TOL)
    for cmd in ("f", "r", "u", "b", "l", "d", "x"):
        j.move(cmd)
        t.move(cmd)
        np.testing.assert_allclose(t.position, j.position, atol=TOL)
    for cmd, angle in (("l", 0.3), ("u", 1.0), ("r", 0.05), ("d", 2.0), ("u", 3.0)):
        j.rotate(cmd, angle)
        t.rotate(cmd, angle)
        assert abs(j.yaw - t.yaw) < TOL and abs(j.pitch - t.pitch) < TOL
    j.rotate("l")
    t.rotate("l")
    j.move("f")
    t.move("f")
    np.testing.assert_allclose(t.position, j.position, atol=TOL)
    np.testing.assert_allclose(t.quat(), j.quat(), atol=TOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _until(fetch, ok, what):
    """Poll ``fetch`` until ``ok`` holds of its result or the deadline."""
    deadline = time.time() + DEADLINE_S
    last = None
    while time.time() < deadline:
        try:
            last = fetch()
            if ok(last):
                return last
        except OSError:
            pass
        time.sleep(0.02)
    raise AssertionError(f"{what} within {DEADLINE_S} s (last: {last!r:.200})")


@pytest.fixture
def viewer():
    """A viewer on the CPU on a free port: yields (base url, stop event)."""
    # 48x48: a frame of 16 spp takes long enough on the CPU that a poll
    # sees the accumulation restart after a camera move
    scene = cornell_scene(width=48, height=48, max_depth=2)
    port = _free_port()
    stop = threading.Event()
    t = threading.Thread(target=run_viewer, args=(scene, scene.options),
                         kwargs=dict(port=port, max_spp=100000, stop_event=stop,
                                     device="cpu"),
                         daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{port}", stop
    finally:
        stop.set()
        t.join(timeout=DEADLINE_S)
    assert not t.is_alive(), "the viewer loop did not stop"


def _status(base):
    return json.loads(_get(f"{base}/status"))


def test_viewer_serves_and_refines(viewer):
    base, _ = viewer
    png = _until(lambda: _get(f"{base}/frame.png"), lambda b: b.startswith(b"\x89PNG"),
                 "a first frame")
    assert len(png) > 100
    assert b"tinsel-tpu" in _get(f"{base}/")
    status = _status(base)
    assert status["spp"] >= 1 and status["mode"] == "pathtrace"

    _get(f"{base}/ctl?exposure=up")
    _get(f"{base}/ctl?denoise=toggle")
    s2 = _status(base)
    assert s2["exposure"] > status["exposure"]
    assert s2["denoise"] == "nlm"  # the toggle cycles off -> nlm -> guided
    spp0 = s2["spp"]
    _until(lambda: _status(base), lambda s: s["spp"] > spp0, "refinement under nlm")
    _get(f"{base}/ctl?denoise=toggle")
    s3 = _status(base)
    assert s3["denoise"] == "guided"
    _until(lambda: _status(base), lambda s: s["spp"] > s3["spp"], "refinement under guided")
    _get(f"{base}/ctl?denoise=toggle")
    assert _status(base)["denoise"] == "off"

    # paused, the loop finishes at most the frame it is in and the one it
    # may start before the request lands: 16 spp each
    before = _status(base)["spp"]
    _get(f"{base}/ctl?pause=toggle")
    assert _until(lambda: _status(base), lambda s: s["paused"], "pause")["paused"]
    end = time.time() + 2.0
    while time.time() < end:
        assert _status(base)["spp"] <= before + 32
        time.sleep(0.05)
    held = _status(base)["spp"]
    _get(f"{base}/ctl?pause=toggle")
    _until(lambda: _status(base), lambda s: s["spp"] > held, "refinement after pause")

    _get(f"{base}/ctl?mode=normals")
    s5 = _until(lambda: _status(base), lambda s: s["mode"] == "normals" and s["spp"] >= 1,
                "a normals frame")
    assert s5["mode"] == "normals"
    assert _get(f"{base}/frame.png").startswith(b"\x89PNG")
    with pytest.raises(urllib.error.HTTPError, match="404"):
        _get(f"{base}/nope")


def test_viewer_flycam_over_http(viewer):
    base, _ = viewer
    s = _until(lambda: _status(base), lambda s: s["spp"] >= 48, "three frames")
    pos0 = np.array(s["cam_pos"])
    _get(f"{base}/ctl?move=f")
    _get(f"{base}/ctl?rot=l")
    _get(f"{base}/ctl?speed=up")
    # the move restarts the accumulation (spp falls), which then refines
    s2 = _until(lambda: _status(base), lambda t: t["spp"] < s["spp"], "a restart")
    assert not np.allclose(s2["cam_pos"], pos0), "the camera moved"
    assert s2["fly_speed"] > s["fly_speed"]
    _until(lambda: _status(base), lambda t: t["spp"] > s2["spp"], "refinement after the move")
