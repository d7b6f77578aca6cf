"""Scene kind ``soup``: ``triangles`` random triangles in a cube of
half-side ``extent`` about the origin, each corner within
``triangle_size`` of its centre, one draw with the identity transform.  A
frozen copy of ``make_triangle_soup`` of
``zrenderer_tpu_torch/scene/procedural.py`` at commit 1b17ee2, written over
plain arrays (``perfbench/tests`` holds it equal to the port's).  The seed
sets positions and colours; every seed gives the same sizes."""

from __future__ import annotations

import numpy as np

from perfbench.scenes import Draw, SceneArrays


def soup(num_triangles: int, seed: int, extent: float,
         triangle_size: float = 1.0) -> SceneArrays:
    """``make_triangle_soup(num_triangles, seed, extent, 0.0,
    triangle_size)``."""
    rng = np.random.default_rng(seed)
    n = num_triangles * 3
    verts = np.zeros((n, 16), np.float32)
    centers = rng.uniform(-extent, extent, size=(num_triangles, 1, 3))
    offsets = rng.uniform(-1.0, 1.0, size=(num_triangles, 3, 3)) * triangle_size
    verts[:, 0:3] = (centers + offsets).reshape(n, 3)
    verts[:, 5:9] = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    verts[:, 8] = 1.0
    return SceneArrays([Draw(verts, np.arange(n, dtype=np.uint32))],
                       np.array([0, 0, 12], np.float32), 0.8, 0.1, 100.0)


def build(params: dict, seed: int) -> SceneArrays:
    return soup(int(params["triangles"]), seed, float(params["extent"]),
                float(params.get("triangle_size", 1.0)))
