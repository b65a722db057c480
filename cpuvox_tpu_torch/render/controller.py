"""Camera controllers: smoothed mouse look + WASD fly movement.

Pure-logic equivalents of the reference's SmoothMouseLook.cs:41-70 (smoothed mouse
deltas with pitch clamp) and UnityManager.cs:106-117 (WASD at moveSpeed with
scroll-wheel speed scaling :148-153), reusable by any frontend (the headless demo
feeds scripted inputs).

A copy of ``cpuvox_tpu/render/controller.py`` (plain numpy): the port keeps its
own copy and imports nothing of the JAX package.  ``tests/test_torch_copies.py``
holds the two equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera, camera_forward, camera_rotation

F = np.float32


@dataclasses.dataclass
class MouseLook:
    sensitivity: float = 8.0
    smoothing: float = 3.0
    pitch_min: float = -90.0
    pitch_max: float = 90.0
    _smooth_x: float = 0.0
    _smooth_y: float = 0.0

    def update(self, cam: Camera, mouse_dx: float, mouse_dy: float) -> Camera:
        scale = self.sensitivity * self.smoothing
        t = 1.0 / self.smoothing
        self._smooth_x += (mouse_dx * scale - self._smooth_x) * t
        self._smooth_y += (mouse_dy * scale - self._smooth_y) * t
        yaw = cam.yaw_deg + self._smooth_x
        pitch = float(np.clip(cam.pitch_deg - self._smooth_y,
                              self.pitch_min, self.pitch_max))
        return dataclasses.replace(cam, yaw_deg=yaw, pitch_deg=pitch)


@dataclasses.dataclass
class FlyMovement:
    move_speed: float = 50.0

    def scroll(self, delta: float):
        if delta < 0:
            self.move_speed *= 0.9
        elif delta > 0:
            self.move_speed *= 1.1

    def update(self, cam: Camera, dt: float, forward: float = 0.0,
               strafe: float = 0.0) -> Camera:
        """forward/strafe in [-1, 1] (W/S and D/A)."""
        rot = camera_rotation(cam)
        fwd = rot @ np.array([0, 0, 1], F)
        right = rot @ np.array([1, 0, 0], F)
        pos = np.asarray(cam.position, F) + (fwd * F(forward)
                                             + right * F(strafe)) * F(dt * self.move_speed)
        return dataclasses.replace(cam, position=tuple(float(p) for p in pos))
