"""Texture sampling from a mip atlas (counterpart of the trilinear path of
``zrenderer_tpu/ops/sampling.py``).

The reference samples through an "oct" atlas: per texel, its own 2x2 quad
and the parent level's 3x3 neighbourhood, 16 u32 lanes, so that one TPU
gather fetches every trilinear tap (TPU gathers pay per index).  A GPU
gather pays per byte, so the port reads the same eight taps from the mip
atlas itself: four at the fine level, four at the parent, each at the
index the oct atlas stores for it (fine taps wrap inside the level, the
parent 2x2 is picked from the 3x3 anchored at ``(t - 1) >> 1`` of the
wrapped fine texel ``t`` with the clamped offsets ``dx, dy``).  Weights and
lerp order are the reference's, so the output bits equal
``sample_trilinear_oct``'s.

Texels are RGBA8 packed as u32 bits in ``int32`` tensors (shift, then
mask: ``(x >> 24) & 0xFF``).  Mip geometry is closed form for power-of-two
chains: ``lw = W0 >> L`` and ``off_x(L) = 2*W0 - (W0 >> (L-1))``.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
F32 = torch.float32
_INV255 = float(np.float32(1.0 / 255.0))


def _wrap(i, n):
    """Floor modulo (the reference's jnp.remainder)."""
    return torch.remainder(i, n)


def _mip_geometry(base_h: int, base_w: int, level):
    """Closed-form (lh, lw, off_x) i32 planes of mip ``level`` in the strip
    atlas."""
    lw = torch.clamp_min(torch.bitwise_right_shift(base_w, level), 1)
    lh = torch.clamp_min(torch.bitwise_right_shift(base_h, level), 1)
    lm1 = torch.clamp_min(level - 1, 0)
    off = 2 * base_w - torch.clamp_min(
        torch.bitwise_right_shift(base_w, lm1), 1)
    off_x = torch.where(level <= 0, 0, off)
    return lh, lw, off_x


def pack_texels_u32(atlas_f32):
    """(h, w, 4) f32 -> (h, w) RGBA8 as u32 bits in int32."""
    q = torch.floor(torch.clamp(atlas_f32, 0.0, 1.0) * 255.0 + 0.5)
    q = q.to(torch.int64)
    packed = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
              | (q[..., 3] << 24))
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(I32)


def _unpack_u32(texel):
    """RGBA8 bits (...) -> (..., 4) f32 in [0, 1]."""
    return torch.stack([((texel >> s) & 0xFF).to(F32) * _INV255
                        for s in (0, 8, 16, 24)], dim=-1)


def mip_level_from_derivatives(uv, base_h: int, base_w: int,
                               num_levels: int):
    """Per-pixel LOD from finite-difference uv derivatives over the frame.

    uv: (H, W, 2).  Returns (H, W) f32 clamped log2 of the largest texel
    footprint.  The last row and column difference against themselves, so
    the frame must be the visible one (crop before calling)."""
    u, v = uv[..., 0], uv[..., 1]
    du_dx = torch.abs(torch.diff(u, dim=1, append=u[:, -1:]))
    dv_dx = torch.abs(torch.diff(v, dim=1, append=v[:, -1:]))
    du_dy = torch.abs(torch.diff(u, dim=0, append=u[-1:, :]))
    dv_dy = torch.abs(torch.diff(v, dim=0, append=v[-1:, :]))
    w, h = float(base_w), float(base_h)
    rho = torch.maximum(torch.maximum(du_dx * w, dv_dx * h),
                        torch.maximum(du_dy * w, dv_dy * h))
    lod = torch.log2(torch.clamp_min(rho, float(np.float32(1e-8))))
    return torch.clamp(lod, 0.0, float(num_levels - 1))


def sample_trilinear(atlas_u32, base_h: int, base_w: int, num_levels: int,
                     uv, lod, layer=None):
    """Trilinear sample of the (L*base_h, 2*base_w) RGBA8 mip atlas:
    bilinear at floor(lod) and at the parent level, lerped by the LOD
    fraction.  uv: (..., 2) wrap space; lod: (...) f32; layer: None or
    (...) i32 texture-array layer.  Returns (..., 4) f32, the bits of the
    reference's ``sample_trilinear_oct`` on the same atlas."""
    l0 = torch.floor(lod).to(I32)
    l1 = torch.clamp_max(l0 + 1, num_levels - 1)
    f = (lod - l0.to(F32))[..., None]

    lh, lw, off_x = _mip_geometry(base_h, base_w, l0)
    ph, pw, poff_x = _mip_geometry(base_h, base_w, l1)
    u, v = uv[..., 0], uv[..., 1]
    x = u * lw.to(F32) - 0.5
    y = v * lh.to(F32) - 0.5
    x0 = torch.floor(x).to(I32)
    y0 = torch.floor(y).to(I32)
    fx = (x - x0.to(F32))[..., None]
    fy = (y - y0.to(F32))[..., None]
    ix = _wrap(x0, lw)
    iy = _wrap(y0, lh)

    xp = u * pw.to(F32) - 0.5
    yp = v * ph.to(F32) - 0.5
    qx = torch.floor(xp).to(I32)
    qy = torch.floor(yp).to(I32)
    fxp = (xp - qx.to(F32))[..., None]
    fyp = (yp - qy.to(F32))[..., None]
    # The parent 3x3 the oct atlas stores for fine texel (iy, ix) is
    # anchored at ((iy - 1) >> 1, (ix - 1) >> 1); the offsets come from
    # the unwrapped x0/y0 as in the reference.
    dx = torch.clamp(qx - ((x0 - 1) >> 1), 0, 1)
    dy = torch.clamp(qy - ((y0 - 1) >> 1), 0, 1)
    by = ((iy - 1) >> 1) + dy
    bx = ((ix - 1) >> 1) + dx

    # All eight taps in one gather: the fine 2x2 at (iy, ix), then the
    # parent 2x2 at (by, bx), each in (0, 0), (0, 1), (1, 0), (1, 1) order.
    fr, fr1 = iy, _wrap(iy + 1, lh)
    fc, fc1 = ix + off_x, _wrap(ix + 1, lw) + off_x
    pr, pr1 = _wrap(by, ph), _wrap(by + 1, ph)
    pc, pc1 = _wrap(bx, pw) + poff_x, _wrap(bx + 1, pw) + poff_x
    rows = torch.stack([fr, fr, fr1, fr1, pr, pr, pr1, pr1])
    cols = torch.stack([fc, fc1, fc, fc1, pc, pc1, pc, pc1])
    if layer is not None:
        rows = rows + layer * base_h
    taps = _unpack_u32(atlas_u32.reshape(-1)[
        (rows * atlas_u32.shape[1] + cols).long()])
    c00, c10, c01, c11, p00, p10, p01, p11 = taps.unbind(0)

    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    c0 = top * (1 - fy) + bot * fy
    topp = p00 * (1 - fxp) + p10 * fxp
    botp = p01 * (1 - fxp) + p11 * fxp
    c1 = topp * (1 - fyp) + botp * fyp
    return c0 * (1 - f) + c1 * f
