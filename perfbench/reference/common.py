"""Inputs the plain references share: the scene's corner columns and
draw transforms, the host matrices of a camera, and the count of a pass's
raster work."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import geometry as geo
from perfbench.reference import raster
from perfbench.reference import zmath as zm

# The least arithmetic a covered (row, pixel) pair needs once coverage is
# known: z = (e0 za0 + e1 za1) + e2 za2 (3 products, 2 sums) and the tests
# z >= 0, z < z_buffer.  The winner's interpolants are per pixel, not per
# pair, and are not counted.
OPS_PER_PAIR = 7
VERTEX_BYTES = 16  # one clip-space vertex, xyzw f32


def padded_rows(num_tris: int, tri_align: int) -> int:
    """Input rows after the renderer pads the triangles to ``tri_align``."""
    return -(-num_tris // tri_align) * tri_align


def draw_matrices(node_to_world: np.ndarray,
                  view_proj: np.ndarray) -> np.ndarray:
    """(D, 4, 4) object-to-clip matrices, node_to_world @ view_proj."""
    return np.einsum("nij,jk->nik", node_to_world,
                     view_proj).astype(np.float32)


def camera_view_proj(cam, width: int, height: int) -> np.ndarray:
    return zm.view_proj(cam.position, cam.forward, cam.yfov, cam.znear,
                        cam.zfar, width, height)


class Inputs:
    """The scene on the reference's device, made from the harness's arrays
    (never from the program's buffers): the corner columns of every draw's
    triangles in draw order, each triangle's draw, the draws'
    node-to-world transforms."""

    def __init__(self, scene, render_config: dict, device):
        self.scene = scene
        self.device = torch.device(device)
        self.width = int(render_config.get("width", 1920))
        self.height = int(render_config.get("height", 1080))
        self.obj = geo.corners(scene.draws, self.device)
        self.node_to_world = np.stack(
            [np.asarray(d.transform, np.float32) for d in scene.draws])
        counts = [len(d.indices) // 3 for d in scene.draws]
        self.tri_draw = None  # one draw: its matrix broadcasts
        if len(counts) > 1:
            self.tri_draw = torch.repeat_interleave(
                torch.arange(len(counts)), torch.tensor(counts)).to(
                    self.device)
        self.rows_in = padded_rows(sum(counts),
                                   int(render_config.get("tri_align", 256)))

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def per_row(self, matrices: np.ndarray) -> torch.Tensor:
        """(D, n, m) per-draw matrices as (n, m, T) per triangle, or
        (n, m, 1) for one draw."""
        m = self.tensor(matrices).permute(1, 2, 0)
        return m if self.tri_draw is None else m[:, :, self.tri_draw]

    def world_corners(self) -> np.ndarray:
        """(D * 8, 3) f32: the corners of each draw's local vertex AABB
        moved to the world by its transform."""
        lo = np.stack([d.vertices[:, 0:3].min(axis=0) for d in
                       self.scene.draws]).astype(np.float32)
        hi = np.stack([d.vertices[:, 0:3].max(axis=0) for d in
                       self.scene.draws]).astype(np.float32)
        pick = np.array([(i, j, k) for i in (0, 1) for j in (0, 1)
                         for k in (0, 1)])
        bounds = np.stack([lo, hi], axis=1)  # (D, 2, 3)
        local = np.ones((len(lo), 8, 4), np.float32)
        for axis in range(3):
            local[:, :, axis] = bounds[:, pick[:, axis], axis]
        world = np.einsum("dkj,dji->dki", local, self.node_to_world)
        return world.reshape(-1, 4)[:, :3]

    def normal_matrices(self) -> np.ndarray:
        """(D, 3, 3) f32: the inverse-transpose of each draw's rotation."""
        return np.linalg.inv(self.node_to_world[:, :3, :3]).transpose(
            0, 2, 1).astype(np.float32)


def pass_work(rows: geo.Rows, width: int, height: int,
              plane_bytes: int) -> dict:
    """The least work of one raster pass: each visible row's three
    clip-space vertices read once and ``plane_bytes`` a pixel written once
    (bytes), OPS_PER_PAIR a covered pair (operations)."""
    jmin, jmax, imin, imax = rows.bbox
    visible = int((rows.alive & (jmin <= jmax) & (imin <= imax)).sum())
    pairs = raster.covered_pairs(rows, width, height)
    return {"bytes": visible * 3 * VERTEX_BYTES + width * height * plane_bytes,
            "ops": pairs * OPS_PER_PAIR, "visible": visible, "pairs": pairs}


def add_work(*passes: dict) -> dict:
    return {k: sum(p[k] for p in passes) for k in passes[0]}
