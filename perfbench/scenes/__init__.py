"""The benchmark's traffic generator: a scene and the camera orbit that
drives the interactive frame loop, both made from ``--seed``.

A traffic file (``perfbench/traffic/<name>.json``) holds only parameters:

* ``scene``: ``kind`` names the scene builder ``perfbench/scenes/<kind>.py``
  and the rest of the entry is that builder's parameters;
* ``orbit``: ``frames_per_turn`` frames a turn about the vertical axis
  through the scene's ``center``, at the scene camera's distance and
  elevation; the seed sets the start azimuth;
* ``warmup_frames``: frames of set-up, spread evenly over one turn, so that
  every size the turn needs has been allocated before the window;
* ``check_frames``: frames of the window that the plain reference
  recomputes: one drawn from the seed in each of ``check_frames - 1``
  equal stretches of the window, and its last frame;
* ``profile_frames``: frames of the traced run's profiled stretch.

A scene builder is a module with ``build(params, seed) -> SceneArrays``:
its draws (a mesh and its node-to-world transform each, in draw order),
the scene camera and the orbit's centre, as plain arrays.  It may also
define ``prepare(renderer, arrays)``, run after ``load_scene`` and the
configuration's ``set_environment``, for set-up that the scene needs
beyond its meshes.  A later scene kind is a new file here and a traffic
file that names it; neither the harness nor this module changes.  Every
seed of one traffic file has to give the same sizes.
"""

from __future__ import annotations

import importlib
import math
import re
from dataclasses import dataclass, field

import numpy as np

VERTEX_FLOATS = 16  # position 0:3, uv 3:5, color 5:9, normal 9:12, tangent 12:16
_KIND = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


@dataclass
class Draw:
    """One mesh drawn once: ``vertices`` (N, 16) f32, ``indices`` (3T,)
    u32 into them, ``transform`` (4, 4) f32 node-to-world (row vectors,
    ``p @ transform``)."""

    vertices: np.ndarray
    indices: np.ndarray
    transform: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))


@dataclass
class SceneArrays:
    """A scene as plain arrays: its draws, its camera, the orbit's centre."""

    draws: list
    eye: np.ndarray  # (3,) f32, the scene camera's position
    yfov: float
    znear: float
    zfar: float
    center: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))

    @property
    def num_triangles(self) -> int:
        return sum(len(d.indices) // 3 for d in self.draws)


@dataclass
class OrbitCamera:
    """The camera of one frame: position, unit forward (to the centre)."""

    position: np.ndarray  # (3,) f32
    forward: np.ndarray  # (3,) f32
    yfov: float
    znear: float
    zfar: float


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of ``seed`` (any whole number)."""
    return np.random.default_rng([seed % 2**64, stream])


def module(kind: str):
    """The scene builder ``perfbench/scenes/<kind>.py``."""
    if not _KIND.match(kind):
        raise ValueError(f"bad scene kind {kind!r}")
    return importlib.import_module(f"{__name__}.{kind}")


def make_scene(params: dict, seed: int) -> SceneArrays:
    """The scene a traffic file's ``scene`` entry describes."""
    return module(params["kind"]).build(params, seed % 2**63)


class Orbit:
    """Frame ``i``'s camera: the scene camera turned about the vertical
    axis through the scene's centre by ``2 pi i / frames_per_turn`` past a
    start azimuth drawn from the seed, looking at the centre."""

    def __init__(self, scene: SceneArrays, params: dict, seed: int):
        self.frames_per_turn = int(params["frames_per_turn"])
        self.center = np.asarray(scene.center, np.float64)
        eye = scene.eye.astype(np.float64) - self.center
        self.radius = math.hypot(eye[0], eye[2])
        self.height = float(eye[1])
        self.azimuth0 = math.atan2(eye[0], eye[2]) + float(
            rng(seed, 1).uniform(0.0, 2.0 * math.pi))
        self.yfov, self.znear, self.zfar = scene.yfov, scene.znear, scene.zfar

    def camera(self, i: int) -> OrbitCamera:
        a = self.azimuth0 + 2.0 * math.pi * (i % self.frames_per_turn) \
            / self.frames_per_turn
        offset = np.array([self.radius * math.sin(a), self.height,
                           self.radius * math.cos(a)])
        eye = self.center + offset
        fwd = -offset / np.linalg.norm(offset)
        return OrbitCamera(eye.astype(np.float32), fwd.astype(np.float32),
                           self.yfov, self.znear, self.zfar)
