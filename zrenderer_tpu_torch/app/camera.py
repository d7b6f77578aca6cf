"""Camera controller: pitch/yaw navigation and turntable orbits
(counterpart of ``zrenderer_tpu/app/camera.py``, a host module copied so
the port runs without the JAX package; ``tests/test_torch_ui.py`` holds
its matrices equal to the reference's).

``forward`` is derived from pitch/yaw (the fly-camera convention), and the
controller offers the movement verbs an interactive host binds to input:
mouse-look, fly movement and a turntable orbit for animations.
"""

from __future__ import annotations

import numpy as np

from zrenderer_tpu_torch.math import zmath as zm
from zrenderer_tpu_torch.scene.scene import Camera


def forward_from_pitch_yaw(pitch: float, yaw: float) -> np.ndarray:
    """Unit forward for a camera looking down -Z at pitch=yaw=0,
    pitch about +X (positive looks up), yaw about +Y (positive looks left
    toward -X ... the row-vector rotate of (0,0,-1) by R_x(pitch)R_y(yaw))."""
    q = zm.quat_from_roll_pitch_yaw(pitch, yaw, 0.0)
    return zm.rotate_vec3(q, (0.0, 0.0, -1.0))[:3].astype(np.float32)


class CameraController:
    def __init__(self, camera: Camera):
        self.camera = camera
        # Initialize angles from the stored orientation when present.
        if not (camera.pitch or camera.yaw):
            f = np.asarray(camera.forward, np.float32)
            camera.pitch = float(np.arcsin(np.clip(f[1], -1, 1)))
            camera.yaw = float(np.arctan2(-f[0], -f[2]))
        self._sync_forward()

    def _sync_forward(self) -> None:
        self.camera.forward = forward_from_pitch_yaw(
            self.camera.pitch, self.camera.yaw
        )

    def look(self, dpitch: float, dyaw: float) -> None:
        """Mouse-look: adjust pitch/yaw (pitch clamped past-vertical)."""
        self.camera.pitch = float(
            np.clip(self.camera.pitch + dpitch, -1.55, 1.55)
        )
        self.camera.yaw = float(self.camera.yaw + dyaw)
        self._sync_forward()

    def move(self, forward: float = 0.0, right: float = 0.0, up: float = 0.0):
        """Fly movement along the camera basis."""
        f = np.asarray(self.camera.forward, np.float32)
        world_up = np.array([0, 1, 0], np.float32)
        r = np.cross(f, world_up)
        norm = np.linalg.norm(r)
        r = r / norm if norm > 1e-6 else np.array([1, 0, 0], np.float32)
        self.camera.position = (
            np.asarray(self.camera.position, np.float32)
            + f * forward + r * right + world_up * up
        ).astype(np.float32)

    def orbit(self, target, radius: float, azimuth: float, elevation: float):
        """Turntable placement: position on a sphere around `target`,
        looking at it — the standard demo/benchmark camera path."""
        t = np.asarray(target, np.float32)
        ce, se = np.cos(elevation), np.sin(elevation)
        offset = np.array(
            [radius * ce * np.sin(azimuth), radius * se,
             radius * ce * np.cos(azimuth)],
            np.float32,
        )
        self.camera.position = t + offset
        f = t - self.camera.position
        f = f / np.linalg.norm(f)
        self.camera.forward = f.astype(np.float32)
        self.camera.pitch = float(np.arcsin(np.clip(f[1], -1, 1)))
        self.camera.yaw = float(np.arctan2(-f[0], -f[2]))
