"""Frame statistics (counterpart of ``zrenderer_tpu/engine/stats.py``).

Frames per second and average frame time recomputed once per second,
plus Mtri/s submitted and Gpix/s shaded.  These are host-clock rates of
``render()`` calls, not device times.
"""

from __future__ import annotations

import time


class FrameStats:
    def __init__(self, window_name: str = "zrenderer-tpu-torch"):
        self.window_name = window_name
        self.time = 0.0
        self.delta_time = 0.0
        self.fps = 0.0
        self.average_cpu_time_ms = 0.0
        self.mtri_per_s = 0.0
        self.gpix_per_s = 0.0
        # Plane-crossing triangles the capped clipper dropped in the last
        # frame checked (RenderConfig.debug or Renderer.clip_overflow).
        self.clip_dropped = 0
        self._start = time.perf_counter()
        self._previous_time = 0.0
        self._refresh_time = 0.0
        self._frame_counter = 0
        self._tri_counter = 0
        self._pix_counter = 0

    def update(self, triangles: int = 0, pixels: int = 0) -> None:
        """Call once per frame."""
        now = time.perf_counter() - self._start
        self.time = now
        self.delta_time = now - self._previous_time
        self._previous_time = now

        if now - self._refresh_time >= 1.0:
            t = now - self._refresh_time
            fps = self._frame_counter / t
            self.fps = fps
            self.average_cpu_time_ms = (1.0 / fps) * 1000.0 if fps > 0 else 0.0
            self.mtri_per_s = self._tri_counter / t / 1e6
            self.gpix_per_s = self._pix_counter / t / 1e9
            self._refresh_time = now
            self._frame_counter = 0
            self._tri_counter = 0
            self._pix_counter = 0
        self._frame_counter += 1
        self._tri_counter += triangles
        self._pix_counter += pixels

    def format_line(self) -> str:
        warn = (f"  clip_dropped={self.clip_dropped}"
                if self.clip_dropped else "")
        return (
            f"FPS: {self.fps:.1f}  CPU time: {self.average_cpu_time_ms:.3f} ms  "
            f"{self.mtri_per_s:.2f} Mtri/s  {self.gpix_per_s:.2f} Gpix/s"
            f"{warn} | {self.window_name}"
        )
