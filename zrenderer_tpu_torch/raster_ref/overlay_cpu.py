"""CPU reference compositor for the 2D overlay pass, the oracle
(counterpart of ``zrenderer_tpu/raster_ref/overlay_cpu.py``, a host module
copied so the port runs without the JAX package; ``tests/test_torch_ui.py``
holds it bit-equal to the reference's).

A painter's-algorithm transcription: triangles composite strictly in
submission order, each pixel blended at once (src-over, straight alpha),
the texture sampled bilinearly at raster time, per-triangle scissor, and
unlimited overlay depth: the device pass's K-layer stack must match it
wherever a pixel's depth stays within K.  It shares the 2D triangle setup
with the device pass (``ops/overlay.setup_overlay_triangles``), so both
consume the same integer coverage data and f32 interpolation constants.
"""

from __future__ import annotations

import numpy as np

from zrenderer_tpu_torch.ops import geometry as g
from zrenderer_tpu_torch.ops import overlay as ov

f32 = np.float32


def _sample_bilinear_wrap(atlas_u8: np.ndarray, u, v):
    """Bilinear WRAP sample; atlas_u8: (h, w, 4) uint8.  The formula of
    ops/overlay.sample_atlas_bilinear (texels unpack to f32/255 before the
    lerp)."""
    h, w = atlas_u8.shape[:2]
    x = u * f32(w) - f32(0.5)
    y = v * f32(h) - f32(0.5)
    x0 = np.floor(x).astype(np.int32)
    y0 = np.floor(y).astype(np.int32)
    fx = (x - x0.astype(f32))[..., None]
    fy = (y - y0.astype(f32))[..., None]

    def fetch(ix, iy):
        ix = np.remainder(ix, w)
        iy = np.remainder(iy, h)
        return atlas_u8[iy, ix].astype(f32) * f32(1.0 / 255.0)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _quantize_u8(c):
    return np.floor(np.clip(c, 0.0, 1.0) * f32(255.0) + f32(0.5)).astype(
        np.uint8
    )


def composite_overlay_cpu(frame_u8: np.ndarray, verts: np.ndarray,
                          scissors: np.ndarray, atlas_u8: np.ndarray,
                          return_count: bool = False):
    """Composite a 2D triangle draw list onto an (H, W, 4) u8 frame.

    verts: (T, 3, 8) f32 (x, y, u, v, r, g, b, a); scissors: (T, 4) i32.
    Returns the composited u8 frame (alpha forced opaque, matching the
    device pass); with ``return_count`` also returns the per-pixel coverage
    count plane (the layer-depth ground truth).
    """
    height, width = frame_u8.shape[:2]
    tri_i32, tri_f32 = ov.setup_overlay_triangles(
        np.asarray(verts, f32), np.asarray(scissors, np.int32),
        width, height,
    )

    dst = frame_u8[..., :3].astype(f32) / f32(255.0)
    count = np.zeros((height, width), np.int32)
    half = g.SUBPIXEL // 2

    for t in range(len(tri_i32)):
        ti = tri_i32[t]
        if ti[g.I_VALID] == 0:
            continue
        jmin, jmax = ti[g.I_JMIN], ti[g.I_JMAX]
        imin, imax = ti[g.I_IMIN], ti[g.I_IMAX]
        if jmin > jmax or imin > imax:
            continue
        tf = tri_f32[t]
        js = np.arange(jmin, jmax + 1)
        is_ = np.arange(imin, imax + 1)
        px = (js * g.SUBPIXEL + half)[None, :]
        py = (is_ * g.SUBPIXEL + half)[:, None]
        e0 = ti[g.I_DX0] * (py - ti[g.I_Y1]) - ti[g.I_DY0] * (px - ti[g.I_X1])
        e1 = ti[g.I_DX1] * (py - ti[g.I_Y2]) - ti[g.I_DY1] * (px - ti[g.I_X2])
        e2 = ti[g.I_DX2] * (py - ti[g.I_Y0]) - ti[g.I_DY2] * (px - ti[g.I_X0])
        inside = (
            (e0 >= ti[g.I_BIAS0]) & (e1 >= ti[g.I_BIAS1]) & (e2 >= ti[g.I_BIAS2])
        )
        if not inside.any():
            continue
        ef0 = e0.astype(f32)
        ef1 = e1.astype(f32)
        ef2 = e2.astype(f32)

        def interp(c0):
            return (ef0 * tf[c0] + ef1 * tf[c0 + 1]) + ef2 * tf[c0 + 2]

        u = interp(ov.F2_U0)
        v = interp(ov.F2_V0)
        # Vertex color quantizes to u8 at raster time (the device layer
        # planes' precision).
        vr = _quantize_u8(interp(ov.F2_R0)).astype(f32) * f32(1.0 / 255.0)
        vg = _quantize_u8(interp(ov.F2_G0)).astype(f32) * f32(1.0 / 255.0)
        vb = _quantize_u8(interp(ov.F2_B0)).astype(f32) * f32(1.0 / 255.0)
        va = _quantize_u8(interp(ov.F2_A0)).astype(f32) * f32(1.0 / 255.0)

        tex = _sample_bilinear_wrap(atlas_u8, u, v)
        src_rgb = np.stack([vr, vg, vb], axis=-1) * tex[..., :3]
        src_a = (va * tex[..., 3])[..., None] * inside[..., None].astype(f32)

        region = dst[imin : imax + 1, jmin : jmax + 1]
        dst[imin : imax + 1, jmin : jmax + 1] = (
            src_rgb * src_a + region * (1.0 - src_a)
        )
        count[imin : imax + 1, jmin : jmax + 1] += inside.astype(np.int32)

    out = np.concatenate(
        [_quantize_u8(dst), np.full((height, width, 1), 255, np.uint8)],
        axis=-1,
    )
    if return_count:
        return out, count
    return out
