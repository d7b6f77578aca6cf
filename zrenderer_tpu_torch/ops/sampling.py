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


# ---------------------------------------------------------------------------
# The reference's other samplers and their gather atlases.  The lit pass
# does not use them (see the module docstring); they are here so the
# port offers the reference's texture API whole.  Each runs as torch ops
# on the atlas's device, op for op as in the reference, so its taps and
# output bits equal the reference function's.
# ---------------------------------------------------------------------------


def _gather_flat(atlas_u32, flat_idx):
    """Scalar texel gather at flat indices, unpacked to (..., 4) f32."""
    return _unpack_u32(atlas_u32.reshape(-1)[flat_idx.long()])


def _level_i32(level, like):
    """An integer mip level as an i32 tensor on ``like``'s device."""
    return torch.as_tensor(level, dtype=I32, device=like.device)


def sample_bilinear_level(atlas, base_h: int, base_w: int, uv, level,
                          layer=None):
    """Bilinear sample at integer mip ``level`` with four scalar gathers.

    atlas: (L*base_h, 2*base_w) RGBA8 strip atlas; uv: (..., 2) wrap
    space; level: (...) i32; layer: None or (...) i32 (wrap stays in the
    layer's rows).  Returns (..., 4) f32."""
    level = _level_i32(level, atlas)
    lh, lw, off_x = _mip_geometry(base_h, base_w, level)
    w2 = atlas.shape[1]
    x = uv[..., 0] * lw.to(F32) - 0.5
    y = uv[..., 1] * lh.to(F32) - 0.5
    x0 = torch.floor(x).to(I32)
    y0 = torch.floor(y).to(I32)
    fx = (x - x0.to(F32))[..., None]
    fy = (y - y0.to(F32))[..., None]
    row0 = 0 if layer is None else layer * base_h

    def fetch(ix, iy):
        ix = _wrap(ix, lw)
        iy = _wrap(iy, lh) + row0
        return _gather_flat(atlas, iy * w2 + (ix + off_x))

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_nearest_level(atlas, base_h: int, base_w: int, uv, level):
    """Nearest texel at integer mip ``level``: (..., 4) f32."""
    level = _level_i32(level, atlas)
    lh, lw, off_x = _mip_geometry(base_h, base_w, level)
    w2 = atlas.shape[1]
    ix = _wrap(torch.floor(uv[..., 0] * lw.to(F32)).to(I32), lw)
    iy = _wrap(torch.floor(uv[..., 1] * lh.to(F32)).to(I32), lh)
    return _gather_flat(atlas, iy * w2 + (ix + off_x))


def _level_region(atlas_u32, base_h: int, base_w: int, level: int):
    """Mip ``level``'s (lh, lw) texels in the strip atlas."""
    lw = max(base_w >> level, 1)
    lh = max(base_h >> level, 1)
    off = 0 if level == 0 else 2 * base_w - max(base_w >> (level - 1), 1)
    return atlas_u32[0:lh, off:off + lw], off


def _own_quad(region):
    """Each texel's wrap-correct 2x2: self, right, down, diagonal."""
    right = torch.roll(region, -1, dims=1)
    down = torch.roll(region, -1, dims=0)
    diag = torch.roll(right, -1, dims=0)
    return [region, right, down, diag]


def _parent_taps(atlas_u32, base_h: int, base_w: int, num_levels: int,
                 level: int, lh: int, lw: int):
    """The parent level's 3x3 anchored at ``((t - 1) >> 1)`` of each texel
    of level ``level``, wrap-correct: nine (lh, lw) planes, row-major."""
    pl = min(level + 1, num_levels - 1)
    parent, _ = _level_region(atlas_u32, base_h, base_w, pl)
    ph, pw = parent.shape
    dev = atlas_u32.device
    bx = (np.arange(lw) - 1) >> 1  # unwrapped anchors (floor div)
    by = (np.arange(lh) - 1) >> 1
    taps = []
    for j in range(3):
        ry = torch.as_tensor(np.mod(by + j, ph), device=dev)
        for i in range(3):
            rx = torch.as_tensor(np.mod(bx + i, pw), device=dev)
            taps.append(parent[ry][:, rx])
    return taps


def build_quad_atlas(atlas_u32, base_h: int, base_w: int, num_levels: int):
    """(h, 2w, 4) RGBA8 lanes (c00, c10, c01, c11) per texel: its 2x2
    neighbourhood, wrap handled per mip region (the reference's
    one-gather bilinear atlas)."""
    h, w2 = atlas_u32.shape
    quad = torch.zeros((h, w2, 4), dtype=atlas_u32.dtype,
                       device=atlas_u32.device)
    for level in range(num_levels):
        region, off = _level_region(atlas_u32, base_h, base_w, level)
        lh, lw = region.shape
        quad[0:lh, off:off + lw] = torch.stack(_own_quad(region), dim=-1)
    return quad


def build_oct_atlas(atlas_u32, base_h: int, base_w: int, num_levels: int):
    """(h, 2w, 16) RGBA8 lanes per texel: its own 2x2 quad (lanes 0-3),
    the parent level's 3x3 anchored at ``(t - 1) >> 1`` (lanes 4-12) and
    three lanes of padding (the texel again), as the reference builds
    its one-gather trilinear atlas."""
    h, w2 = atlas_u32.shape
    oct_ = torch.zeros((h, w2, 16), dtype=atlas_u32.dtype,
                       device=atlas_u32.device)
    for level in range(num_levels):
        region, off = _level_region(atlas_u32, base_h, base_w, level)
        lh, lw = region.shape
        taps = _parent_taps(atlas_u32, base_h, base_w, num_levels, level,
                            lh, lw)
        oct_[0:lh, off:off + lw] = torch.stack(
            _own_quad(region) + taps + [region] * 3, dim=-1)
    return oct_


def build_pvar_atlas(atlas_u32, base_h: int, base_w: int, num_levels: int):
    """(h, 2w, 32) RGBA8 lanes per texel: for each parent-anchor offset
    (dy, dx) in row-major order, the texel's own 2x2 quad then the parent
    2x2 selected at that offset (the reference's parent-variant atlas)."""
    h, w2 = atlas_u32.shape
    pvar = torch.zeros((h, w2, 32), dtype=atlas_u32.dtype,
                       device=atlas_u32.device)
    for level in range(num_levels):
        region, off = _level_region(atlas_u32, base_h, base_w, level)
        lh, lw = region.shape
        own = _own_quad(region)
        taps = _parent_taps(atlas_u32, base_h, base_w, num_levels, level,
                            lh, lw)
        lanes = []
        for dy in range(2):
            for dx in range(2):
                lanes += own + [
                    taps[(dy + jj) * 3 + (dx + ii)]
                    for jj, ii in ((0, 0), (0, 1), (1, 0), (1, 1))
                ]
        pvar[0:lh, off:off + lw] = torch.stack(lanes, dim=-1)
    return pvar


def _fine_coords(base_h: int, base_w: int, uv, level, layer):
    """The fine level's wrapped texel (iy + layer row, ix + off_x), its
    unwrapped (x0, y0) and its bilinear fractions."""
    lh, lw, off_x = _mip_geometry(base_h, base_w, level)
    x = uv[..., 0] * lw.to(F32) - 0.5
    y = uv[..., 1] * lh.to(F32) - 0.5
    x0 = torch.floor(x).to(I32)
    y0 = torch.floor(y).to(I32)
    fx = (x - x0.to(F32))[..., None]
    fy = (y - y0.to(F32))[..., None]
    row0 = 0 if layer is None else layer * base_h
    return _wrap(y0, lh) + row0, _wrap(x0, lw) + off_x, x0, y0, fx, fy


def _parent_coords(base_h: int, base_w: int, uv, level, x0, y0):
    """The parent level's fractions and the clamped anchor offsets
    (dx, dy) of its 2x2 in the fine texel's stored 3x3."""
    ph, pw, _ = _mip_geometry(base_h, base_w, level)
    xp = uv[..., 0] * pw.to(F32) - 0.5
    yp = uv[..., 1] * ph.to(F32) - 0.5
    qx = torch.floor(xp).to(I32)
    qy = torch.floor(yp).to(I32)
    fxp = (xp - qx.to(F32))[..., None]
    fyp = (yp - qy.to(F32))[..., None]
    dx = torch.clamp(qx - ((x0 - 1) >> 1), 0, 1)
    dy = torch.clamp(qy - ((y0 - 1) >> 1), 0, 1)
    return fxp, fyp, dx, dy


def _bilerp(c00, c10, c01, c11, fx, fy):
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _levels(lod, num_levels: int):
    l0 = torch.floor(lod).to(I32)
    l1 = torch.clamp_max(l0 + 1, num_levels - 1)
    return l0, l1, (lod - l0.to(F32))[..., None]


def sample_bilinear_level_quad(quad_atlas, base_h: int, base_w: int, uv,
                               level, layer=None):
    """Bilinear at integer mip ``level`` from one 4-lane row of the quad
    atlas (``build_quad_atlas``); the bits of ``sample_bilinear_level``."""
    level = _level_i32(level, quad_atlas)
    w2 = quad_atlas.shape[1]
    iy, ix, _, _, fx, fy = _fine_coords(base_h, base_w, uv, level, layer)
    rows = quad_atlas.reshape(-1, 4)[(iy * w2 + ix).long()]
    return _bilerp(*(_unpack_u32(rows[..., k]) for k in range(4)), fx, fy)


def sample_trilinear_quad(quad_atlas, base_h: int, base_w: int,
                          num_levels: int, uv, lod, layer=None):
    """Trilinear from the quad atlas: one row per level, two in all."""
    l0, l1, f = _levels(lod, num_levels)
    c0 = sample_bilinear_level_quad(quad_atlas, base_h, base_w, uv, l0,
                                    layer=layer)
    c1 = sample_bilinear_level_quad(quad_atlas, base_h, base_w, uv, l1,
                                    layer=layer)
    return c0 * (1 - f) + c1 * f


def sample_trilinear_oct(oct_atlas, base_h: int, base_w: int,
                         num_levels: int, uv, lod, layer=None):
    """Trilinear from one 16-lane row of the oct atlas
    (``build_oct_atlas``): the fine quad, then the parent 2x2 selected
    from the stored 3x3 by the anchor offsets."""
    l0, l1, f = _levels(lod, num_levels)
    w2 = oct_atlas.shape[1]
    iy, ix, x0, y0, fx, fy = _fine_coords(base_h, base_w, uv, l0, layer)
    rows = oct_atlas.reshape(-1, 16)[(iy * w2 + ix).long()]
    c0 = _bilerp(*(_unpack_u32(rows[..., k]) for k in range(4)), fx, fy)
    fxp, fyp, dx, dy = _parent_coords(base_h, base_w, uv, l1, x0, y0)

    def ptap(jj, ii):
        # lane 4 + (dy + jj) * 3 + (dx + ii)
        a = torch.where(dx == 0, rows[..., 4 + jj * 3 + ii],
                        rows[..., 4 + jj * 3 + ii + 1])
        b = torch.where(dx == 0, rows[..., 4 + (jj + 1) * 3 + ii],
                        rows[..., 4 + (jj + 1) * 3 + ii + 1])
        return _unpack_u32(torch.where(dy == 0, a, b))

    c1 = _bilerp(ptap(0, 0), ptap(0, 1), ptap(1, 0), ptap(1, 1), fxp, fyp)
    return c0 * (1 - f) + c1 * f


def sample_trilinear_pvar(pvar_atlas, base_h: int, base_w: int,
                          num_levels: int, uv, lod, layer=None):
    """Trilinear from one 8-lane row of the parent-variant atlas
    (``build_pvar_atlas``): the anchor offsets pick the row."""
    l0, l1, f = _levels(lod, num_levels)
    w2 = pvar_atlas.shape[1]
    iy, ix, x0, y0, fx, fy = _fine_coords(base_h, base_w, uv, l0, layer)
    fxp, fyp, dx, dy = _parent_coords(base_h, base_w, uv, l1, x0, y0)
    rows = pvar_atlas.reshape(-1, 8)[
        ((iy * w2 + ix) * 4 + dy * 2 + dx).long()]
    c0 = _bilerp(*(_unpack_u32(rows[..., k]) for k in range(4)), fx, fy)
    c1 = _bilerp(*(_unpack_u32(rows[..., k]) for k in range(4, 8)),
                 fxp, fyp)
    return c0 * (1 - f) + c1 * f
