"""CPU reference rasterizer: the pixel-exactness oracle of the port.

The per-pixel loop is the port's copy of ``zrenderer_tpu/raster_ref/
raster_cpu.py``: a scalar transcription of docs/RASTER_SPEC.md §2-§4 in
NumPy, independent of the CUDA kernels and of their plain torch versions,
and written as simply as possible.  It consumes the setup rows of the
port's geometry stage run on CPU tensors (which the tests hold bit-exact
against the reference's NumPy geometry), so ``render_scene_cpu`` needs
neither the JAX package nor a card.  ``tests/test_torch_host.py`` holds it
equal to the reference's oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import geometry as tg

CLEAR_COLOR = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
CLEAR_DEPTH = np.float32(1.0)


def rasterize_setup(tri_i32: np.ndarray, tri_f32: np.ndarray,
                    width: int, height: int):
    """Rasterize setup rows; returns (rgba_f32 (H,W,4), depth (H,W)).

    Rows are processed in array order, the submission order that breaks
    depth ties (RASTER_SPEC.md §3).
    """
    zbuf = np.full((height, width), CLEAR_DEPTH, np.float32)
    # Latched per-pixel numerator/denominator of the winning triangle.
    nr = np.zeros((height, width), np.float32)
    ng = np.zeros((height, width), np.float32)
    nb = np.zeros((height, width), np.float32)
    den = np.zeros((height, width), np.float32)

    half = tg.SUBPIXEL // 2
    for t in range(tri_i32.shape[0]):
        ti = tri_i32[t]
        if ti[tg.I_VALID] == 0:
            continue
        jmin, jmax = int(ti[tg.I_JMIN]), int(ti[tg.I_JMAX])
        imin, imax = int(ti[tg.I_IMIN]), int(ti[tg.I_IMAX])
        if jmin > jmax or imin > imax:
            continue
        tf = tri_f32[t]
        x0, y0, x1, y1, x2, y2 = (int(v) for v in ti[0:6])
        dx0, dy0, dx1, dy1, dx2, dy2 = (int(v) for v in ti[6:12])
        b0, b1, b2 = (int(v) for v in ti[12:15])

        for i in range(imin, imax + 1):
            py = tg.SUBPIXEL * i + half
            for j in range(jmin, jmax + 1):
                px = tg.SUBPIXEL * j + half
                # int32 wrap-around, as on the device.
                e0 = np.int32(dx0) * np.int32(py - y1) - np.int32(dy0) * np.int32(px - x1)
                e1 = np.int32(dx1) * np.int32(py - y2) - np.int32(dy1) * np.int32(px - x2)
                e2 = np.int32(dx2) * np.int32(py - y0) - np.int32(dy2) * np.int32(px - x0)
                if e0 < b0 or e1 < b1 or e2 < b2:
                    continue
                ef0, ef1, ef2 = np.float32(e0), np.float32(e1), np.float32(e2)
                z = ef0 * tf[tg.F_ZA0] + ef1 * tf[tg.F_ZA1] + ef2 * tf[tg.F_ZA2]
                if not (z >= 0.0 and z < zbuf[i, j]):
                    continue
                zbuf[i, j] = z
                den[i, j] = ef0 * tf[tg.F_RW0] + ef1 * tf[tg.F_RW1] + ef2 * tf[tg.F_RW2]
                nr[i, j] = ef0 * tf[tg.F_CR0] + ef1 * tf[tg.F_CR1] + ef2 * tf[tg.F_CR2]
                ng[i, j] = ef0 * tf[tg.F_CG0] + ef1 * tf[tg.F_CG1] + ef2 * tf[tg.F_CG2]
                nb[i, j] = ef0 * tf[tg.F_CB0] + ef1 * tf[tg.F_CB1] + ef2 * tf[tg.F_CB2]

    covered = den > 0
    safe_den = np.where(covered, den, np.float32(1.0))
    rgba = np.empty((height, width, 4), np.float32)
    rgba[..., 0] = np.where(covered, nr / safe_den, CLEAR_COLOR[0])
    rgba[..., 1] = np.where(covered, ng / safe_den, CLEAR_COLOR[1])
    rgba[..., 2] = np.where(covered, nb / safe_den, CLEAR_COLOR[2])
    rgba[..., 3] = 1.0
    return rgba, zbuf


def pack_u8(rgba_f32: np.ndarray) -> np.ndarray:
    """RASTER_SPEC.md §4: u8 = floor(clamp(c, 0, 1) * 255 + 0.5)."""
    c = np.clip(rgba_f32, 0.0, 1.0).astype(np.float32)
    return np.floor(c * np.float32(255.0) + np.float32(0.5)).astype(np.uint8)


def render_scene_cpu(scene, mesh_data, width: int, height: int,
                     camera=None):
    """Oracle render of a scene at (width, height): the port's geometry on
    CPU tensors, then the scalar loop.  Returns (rgba_u8 (H,W,4), depth
    (H,W) f32)."""
    flat = flatten_scene(scene, mesh_data, pad=False)
    camera = camera if camera is not None else scene.active_camera
    vp = tg.view_proj_from_camera(camera, width, height)
    matrices = np.stack(
        [m.astype(np.float32) @ vp for m in flat.node_to_world], axis=0
    ).astype(np.float32)
    ccols, tri_node = flat.expand_corner_cols()
    tri_i32, tri_f32 = tg.geometry_pipeline_cols(
        torch.from_numpy(ccols), torch.from_numpy(tri_node),
        torch.from_numpy(matrices), width, height)
    rgba, depth = rasterize_setup(tri_i32.numpy(), tri_f32.numpy(),
                                  width, height)
    return pack_u8(rgba), depth
