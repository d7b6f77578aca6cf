"""Scene kind ``lattice``: a Morton-ordered lattice of coloured cubes,
``triangles`` of them rounded down to whole cubes, one draw with the
identity transform.  A frozen copy of ``make_stress_scene`` of
``zrenderer_tpu_torch/scene/procedural.py`` at commit 1b17ee2, written over
plain arrays (``perfbench/tests`` holds it equal to the port's).  The seed
sets the cubes' colours; every seed gives the same sizes."""

from __future__ import annotations

import numpy as np

from perfbench.scenes import VERTEX_FLOATS, Draw, SceneArrays

# (normal, tangent, four corners CCW seen from outside, color) of the cube's
# faces, as ``procedural._FACES``.
_FACES = [
    ((0, 0, 1), (1, 0, 0, 1), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)], (1, 0, 0, 1)),
    ((0, 0, -1), (-1, 0, 0, 1), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)], (0, 1, 0, 1)),
    ((1, 0, 0), (0, 0, -1, 1), [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)], (0, 0, 1, 1)),
    ((-1, 0, 0), (0, 0, 1, 1), [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)], (1, 1, 0, 1)),
    ((0, 1, 0), (1, 0, 0, 1), [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)], (1, 0, 1, 1)),
    ((0, -1, 0), (1, 0, 0, 1), [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)], (0, 1, 1, 1)),
]



def _morton_sorted(grid):
    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    morton = (spread(grid[:, 0]) | (spread(grid[:, 1]) << np.uint64(1))
              | (spread(grid[:, 2]) << np.uint64(2)))
    return grid[np.argsort(morton)]


def _cube():
    """The unit cube: (24, 16) f32 vertices and (36,) indices."""
    verts = []
    indices = []
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for normal, tangent, corners, color in _FACES:
        base = len(verts)
        for corner, uv in zip(corners, uvs):
            v = np.zeros(VERTEX_FLOATS, np.float32)
            v[0:3] = corner
            v[3:5] = uv
            v[5:9] = color
            v[9:12] = normal
            v[12:16] = tangent
            verts.append(v)
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return np.stack(verts), np.array(indices, np.int64)


def lattice(num_triangles: int, seed: int) -> SceneArrays:
    """``make_stress_scene(num_triangles, seed)``."""
    rng = np.random.default_rng(seed)
    cubes = max(1, num_triangles // 12)
    side = int(np.ceil(cubes ** (1.0 / 3.0)))
    grid = np.stack(
        np.meshgrid(np.arange(side), np.arange(side), np.arange(side),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)[:cubes]
    grid = _morton_sorted(grid)
    spacing = 2.6
    centers = (grid - (side - 1) / 2.0) * spacing
    base_verts, base_idx = _cube()
    verts = np.tile(base_verts, (cubes, 1)).reshape(cubes, 24, 16)
    verts[:, :, 0:3] += centers[:, None, :].astype(np.float32)
    colors = rng.uniform(0.1, 1.0, (cubes, 1, 3)).astype(np.float32)
    verts[:, :, 5:8] = colors
    verts[:, :, 8] = 1.0
    verts = verts.reshape(cubes * 24, 16)
    idx = (base_idx[None, :] + (np.arange(cubes) * 24)[:, None]).reshape(-1)
    dist = side * spacing * 1.35
    eye = np.array([dist * 0.55, dist * 0.4, dist], np.float32)
    return SceneArrays([Draw(verts, idx.astype(np.uint32))], eye, 0.9, 0.5,
                       float(6 * dist))


def build(params: dict, seed: int) -> SceneArrays:
    return lattice(int(params["triangles"]), seed)
