"""A frozen copy of the port's viewer fly camera (``app/viewer.py``), so
that the reference moves its camera as the viewer moves it."""

from __future__ import annotations

import numpy as np
import torch

from .tinsel_ref.core.math import quat_rotate


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
