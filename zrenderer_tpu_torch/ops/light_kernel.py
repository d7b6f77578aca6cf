"""Tiled deferred lighting, K7 (counterpart of
``zrenderer_tpu/ops/light_kernel.py``).

BASELINE config 3 lights the G-buffer with L point lights (256 in its
cells) under merged Cook-Torrance GGX.  The frame is cut into 32x128
tiles; each light gets a conservative screen bounding box from its
influence radius (``light_screen_bounds``: radiance below 1/512 is cut),
and each tile visits only the lights whose box touches it, in light-id
order (``tile_light_lists``: the reference's XLA prepass).

* ``tiled_deferred_lighting`` keeps the reference's signature: albedo,
  normal and world (H, W, 3), the coverage mask, the camera, the lights
  and the view-projection; roughness and metallic as scalars or (H, W)
  planes; ``plane_dtype`` float32 or bfloat16 for the 11 G-buffer planes;
  ``row_offset``/``full_height`` for a band of a taller frame.
  ``light_inputs`` stacks the planes and computes the bounds, then
  ``tiled_light`` lights them.
* ``tiled_light`` takes CUDA tensors to the kernel (``csrc/light_tiled.cu``,
  one wrapper per plane type; each tile's covered pixels in work items of
  ITEM_PIXELS, ``light_work_items``) and CPU tensors to
  ``tiled_light_plain``, the plain torch version, which follows
  ``_tiled_light_kernel`` expression for expression.

Two numerics are fixed on both sides of the port, so that the plain
version's CPU and CUDA bits and the kernel's agree by construction:

* ``rsqrt(x)`` is ``1 / sqrt(x)``, both IEEE-rounded (``torch.rsqrt`` on
  CUDA and ``rsqrtf`` are approximate);
* ``pl.reciprocal(denom, approx=True)`` is ``1 / bf16_rn(denom)``: the
  form the reference's interpret mode lowers it to on the CPU, whose
  frames the goldens hold.  On its TPU the reciprocal is the hardware's
  approximation instead.

``jnp.maximum(x, c)`` is ``where(x < c, c, x)`` (NaN stays), in the plain
version and the kernel alike.  The bounds are cast to int32 after a float
clamp: XLA's convert saturates (NaN to 0), torch's out-of-range cast does
not.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops.raster import (
    TILE_H,
    TILE_W,
    _launch,
    _on_cpu,
    _ptr,
)

F32 = torch.float32
I32 = torch.int32
BF16 = torch.bfloat16

# The G-buffer planes K7 reads, in this order: albedo r/g/b, normal x/y/z,
# world x/y/z, metallic, roughness.  The coverage mask is a separate int32
# plane.
NUM_PLANES = 11
# Lights a block stages in shared memory at a time (csrc/light_tiled.cu
# MAX_LIGHTS): 1024 x 6 floats, 24 KB.  More lights go in chunks of this
# many, in id order.  BASELINE config 3 has 256.
MAX_LIGHTS = 1024
# K7 cuts each tile's covered pixels into work items of at most this many,
# one CUDA block each: a mirror of csrc/light_tiled.cu's ITEM_PIXELS, which
# the kernel is compiled with.  On the H100 at 1080p, 512 ran the 256 wide lights in 1.34 ms
# (256: 1.34, 1024: 1.43, 4096: 2.22) and the r2 lights in 0.21 (256:
# 0.27, 1024: 0.18) (PERF.md §6).
ITEM_PIXELS = 512
TILE_PIX = TILE_H * TILE_W
PLANE_DTYPES = (F32, BF16)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _max(x, c: float):
    """jnp.maximum(x, c) for a constant c, with a NaN x staying NaN."""
    return torch.where(x < c, _f32(c), x)


def _min(x, c: float):
    return torch.where(x > c, _f32(c), x)


def _rsqrt(x):
    """1 / sqrt(x), both IEEE-rounded."""
    return torch.ones((), dtype=F32, device=x.device) / torch.sqrt(x)


def _recip_bf16(x):
    """pl.reciprocal(x, approx=True) in its CPU form: 1 / bf16_rn(x)."""
    return (torch.ones((), dtype=F32, device=x.device)
            / x.to(BF16).to(F32))


# ---------------------------------------------------------------------------
# Culling: light bounds and per-tile lists
# ---------------------------------------------------------------------------


def light_screen_bounds(light_pos, light_color, view_proj, width: int,
                        height: int, cutoff: float = 1.0 / 512.0):
    """Conservative per-light screen box from the influence radius, as
    (L, 4) int32 (jmin, jmax, imin, imax) clamped to the frame; a light
    behind or near the camera plane (w < 1e-3) gets the whole frame.

    Explicit multiply-adds in the reference's association (not a matmul),
    int32-equal to the reference's on the same inputs."""
    intensity = light_color.amax(dim=-1)
    radius = torch.sqrt(torch.clamp_min(
        intensity / torch.tensor(_f32(cutoff), dtype=F32,
                                 device=intensity.device),
        _f32(1e-6)))
    px, py, pz = light_pos[:, 0], light_pos[:, 1], light_pos[:, 2]
    m = view_proj
    clip = [((px * m[0, j] + py * m[1, j]) + pz * m[2, j]) + m[3, j]
            for j in range(4)]
    w = clip[3]
    safe_w = torch.where(torch.abs(w) > _f32(1e-6), w, _f32(1e-6))
    sx = (clip[0] / safe_w + 1.0) * (width * 0.5)
    sy = (1.0 - clip[1] / safe_w) * (height * 0.5)
    scale = (torch.abs(m[0, 0]) * (width * 0.5)
             / torch.clamp_min(w, _f32(1e-3)))
    sr = radius * scale + 1.0
    full = w < _f32(1e-3)

    def clamp(x, hi: int, whole: int):
        x = torch.clamp(torch.nan_to_num(x, nan=0.0), 0, hi).to(I32)
        return torch.where(full, whole, x)

    return torch.stack([
        clamp(torch.floor(sx - sr), width - 1, 0),
        clamp(torch.ceil(sx + sr), width - 1, width - 1),
        clamp(torch.floor(sy - sr), height - 1, 0),
        clamp(torch.ceil(sy + sr), height - 1, height - 1),
    ], dim=1)


def tile_light_hits(bounds, tiles_y: int, tiles_x: int, row_offset: int = 0):
    """(tiles_y * tiles_x, L) bool: does light l's box touch the tile?  A
    tile's first row is tile_i * 32 + ``row_offset`` (global rows for a
    band)."""
    dev = bounds.device
    row0 = (torch.arange(tiles_y, dtype=I32, device=dev) * TILE_H
            + row_offset)[:, None, None]
    col0 = (torch.arange(tiles_x, dtype=I32, device=dev) * TILE_W)[None, :,
                                                                    None]
    jmin, jmax, imin, imax = bounds.unbind(1)
    hit = ((jmax >= col0) & (jmin < col0 + TILE_W)
           & (imax >= row0) & (imin < row0 + TILE_H))
    return hit.reshape(tiles_y * tiles_x, bounds.shape[0])


def tile_light_lists(bounds, tiles_y: int, tiles_x: int, row_offset: int = 0):
    """The reference's prepass: per-tile counts (T,) int32 and lists
    (T, L) int32, each tile's listed lights first in light-id order."""
    hit = tile_light_hits(bounds, tiles_y, tiles_x, row_offset)
    counts = hit.sum(dim=1, dtype=I32)
    lists = torch.sort((~hit).to(torch.uint8), dim=1, stable=True).indices
    return counts, lists.to(I32)


# ---------------------------------------------------------------------------
# K7's plain version
# ---------------------------------------------------------------------------


def tiled_light_plain(planes, mask, bounds, lights, consts,
                      row_offset: int = 0):
    """The plain torch version of K7: ``planes`` (11, H, W) f32 or bf16,
    ``mask`` (H, W) int32, ``bounds`` (L, 4) int32, ``lights`` (L, 6) f32
    (x, y, z, r, g, b), ``consts`` (4,) f32 (camera x, y, z, ambient).
    Returns (3, H, W) f32: ``where(mask > 0, acc, 0)`` per channel.

    Each light is evaluated over the whole frame and added only where its
    tile lists it, lights in id order: every pixel sees the adds of its
    tile's list in the kernel's order."""
    h, w = mask.shape
    ar, ag, ab, nx, ny, nz, wx, wy, wz, mv, rv = (p.to(F32) for p in planes)
    cam_x, cam_y, cam_z, ambient = consts[0], consts[1], consts[2], consts[3]

    inv_nlen = _rsqrt(_max((nx * nx + ny * ny) + nz * nz, 1e-12))
    nx, ny, nz = nx * inv_nlen, ny * inv_nlen, nz * inv_nlen
    vx, vy, vz = cam_x - wx, cam_y - wy, cam_z - wz
    inv_vlen = _rsqrt(_max((vx * vx + vy * vy) + vz * vz, 1e-12))
    vx, vy, vz = vx * inv_vlen, vy * inv_vlen, vz * inv_vlen
    nv_raw = (nx * vx + ny * vy) + nz * vz
    ndotv = _max(nv_raw, 1e-4)

    one_minus_m = 1.0 - mv
    f0 = [_f32(0.04) * one_minus_m + a * mv for a in (ar, ag, ab)]
    omf0 = [1.0 - f for f in f0]
    a = rv * rv
    a2 = a * a
    k = ((rv + 1.0) * (rv + 1.0)) * 0.125
    one_minus_k = 1.0 - k
    gv = ndotv / (ndotv * one_minus_k + k)
    cs = ((a2 * gv) * 0.25) / ndotv
    a2m1 = a2 - 1.0
    db = [(one_minus_m * a) * _f32(1.0 / np.pi) for a in (ar, ag, ab)]
    acc = [a * ambient for a in (ar, ag, ab)]

    tiles_y, tiles_x = h // TILE_H, w // TILE_W
    hits = tile_light_hits(bounds, tiles_y, tiles_x, row_offset).T.reshape(
        -1, tiles_y, tiles_x)
    rows = torch.arange(h, device=mask.device) // TILE_H
    cols = torch.arange(w, device=mask.device) // TILE_W
    listed = hits.any(dim=2).any(dim=1).cpu()
    for light in range(bounds.shape[0]):
        if not bool(listed[light]):
            continue
        lx, ly, lz, cr, cg, cb = lights[light].unbind(0)
        dx, dy, dz = lx - wx, ly - wy, lz - wz
        d2 = (dx * dx + dy * dy) + dz * dz
        inv_d = _rsqrt(_max(d2, 1e-12))
        lxn, lyn, lzn = dx * inv_d, dy * inv_d, dz * inv_d
        nl_raw = (nx * lxn + ny * lyn) + nz * lzn
        ndotl = _max(nl_raw, 0.0)
        ldotv = (lxn * vx + lyn * vy) + lzn * vz
        inv_h = _rsqrt(_max(2.0 + 2.0 * ldotv, 1e-12))
        ndoth = _max((nl_raw + nv_raw) * inv_h, 0.0)
        vdoth = _max((1.0 + ldotv) * inv_h, 0.0)
        dterm = (ndoth * ndoth) * a2m1 + 1.0
        denom = (_max((_f32(np.pi) * dterm) * dterm, 1e-8)
                 * (ndotl * one_minus_k + k))
        spec = cs * _recip_bf16(denom)
        t = _min(_max(1.0 - vdoth, 0.0), 1.0)
        t2 = t * t
        t5 = (t2 * t2) * t
        rad = ndotl * (inv_d * inv_d)
        here = hits[light][rows[:, None], cols[None, :]]
        for ch, c in enumerate((cr, cg, cb)):
            fres = f0[ch] + omf0[ch] * t5
            add = acc[ch] + (db[ch] + fres * (spec - db[ch])) * (c * rad)
            acc[ch] = torch.where(here, add, acc[ch])
    covered = mask > 0
    return torch.stack([torch.where(covered, x, 0.0) for x in acc])


def light_work_items(mask, item_pixels: int):
    """K7's work items (csrc/light_tiled.cu), for the tests and the
    chip check: each tile's covered pixels in row-major order, cut into
    items of at most ``item_pixels``.  Returns (B, 3) i64 rows (tile, item
    index, flat frame index) for the B covered pixels, tile by tile and in
    each tile in the kernel's order, and the kernel's launch grid, tiles x
    ceil(TILE_PIX / item_pixels) blocks (block tile * that + item)."""
    h, w = mask.shape
    ty, tx = h // TILE_H, w // TILE_W
    idx = torch.arange(h * w).reshape(ty, TILE_H, tx, TILE_W)
    idx = idx.permute(0, 2, 1, 3).reshape(ty * tx, TILE_PIX)
    cov = (mask.cpu() > 0).reshape(-1)[idx]
    rank = torch.cumsum(cov.to(torch.int64), 1) - 1
    tile, pix = torch.nonzero(cov, as_tuple=True)
    items = torch.stack([tile, rank[tile, pix] // item_pixels,
                         idx[tile, pix]], dim=1)
    return items, ty * tx * -(-TILE_PIX // item_pixels)


# ---------------------------------------------------------------------------
# K7 on the card (csrc/light_tiled.cu)
# ---------------------------------------------------------------------------


def _check_light_inputs(planes, mask, bounds, lights, consts):
    """K7's input contract; raises on anything else."""
    dev = planes.device
    for name, t, dtypes in (("planes", planes, PLANE_DTYPES),
                            ("mask", mask, (I32,)), ("bounds", bounds, (I32,)),
                            ("lights", lights, (F32,)),
                            ("consts", consts, (F32,))):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensor on {dev} expected, got "
                             f"{t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: one of {dtypes} expected, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor expected")
    h, w = mask.shape
    if h % TILE_H or w % TILE_W or h <= 0 or w <= 0:
        raise ValueError(f"frame {w}x{h}: a multiple of {TILE_W}x{TILE_H}")
    if tuple(planes.shape) != (NUM_PLANES, h, w):
        raise ValueError(f"planes: ({NUM_PLANES}, {h}, {w}) expected, got "
                         f"{tuple(planes.shape)}")
    num = bounds.shape[0]
    if (bounds.ndim != 2 or bounds.shape[1] != 4
            or tuple(lights.shape) != (num, 6)):
        raise ValueError("bounds (L, 4) and lights (L, 6) expected, got "
                         f"{tuple(bounds.shape)} and {tuple(lights.shape)}")
    if consts.numel() < 4:
        raise ValueError("consts: camera x, y, z and ambient expected")


def _launch_light(planes, mask, bounds, lights, consts, row_offset: int):
    _check_light_inputs(planes, mask, bounds, lights, consts)
    h, w = mask.shape
    out = torch.empty((3, h, w), dtype=F32, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        _launch(_build.load_library().zr_light_tiled, _ptr(planes),
                int(planes.dtype == BF16), _ptr(mask), _ptr(bounds),
                _ptr(lights), bounds.shape[0], _ptr(consts), int(row_offset),
                _ptr(out), h, w, ctypes.c_void_p(stream))
    return out


def tiled_light_kernel(planes, mask, bounds, lights, consts,
                       row_offset: int = 0):
    """Launch K7 on f32 planes (``csrc/light_tiled.cu``) on the current
    stream; returns (3, H, W) f32."""
    if planes.dtype != F32:
        raise TypeError(f"planes: float32 expected, got {planes.dtype}")
    out = _launch_light(planes, mask, bounds, lights, consts, row_offset)
    tiled_light_kernel.launches += 1
    return out


def tiled_light_bf16_kernel(planes, mask, bounds, lights, consts,
                            row_offset: int = 0):
    """Launch K7's bf16-plane instantiation (``lighting_planes="bf16"``)."""
    if planes.dtype != BF16:
        raise TypeError(f"planes: bfloat16 expected, got {planes.dtype}")
    out = _launch_light(planes, mask, bounds, lights, consts, row_offset)
    tiled_light_bf16_kernel.launches += 1
    return out


LIGHT_KERNELS = (tiled_light_kernel, tiled_light_bf16_kernel)
for _kernel in LIGHT_KERNELS:
    _kernel.launches = 0
del _kernel


def tiled_light(planes, mask, bounds, lights, consts, row_offset: int = 0):
    """K7 for CUDA tensors (by plane type), its plain version for CPU
    tensors."""
    if _on_cpu(planes):
        return tiled_light_plain(planes, mask, bounds, lights, consts,
                                 row_offset)
    kernel = tiled_light_bf16_kernel if planes.dtype == BF16 \
        else tiled_light_kernel
    return kernel(planes, mask, bounds, lights, consts, row_offset)


def light_inputs(albedo, normal, world, covered, cam_pos, light_pos,
                 light_color, view_proj, ambient=0.03, roughness=0.4,
                 metallic=0.0, plane_dtype=F32,
                 full_height: int | None = None):
    """K7's inputs from a frame's planes: (planes (11, H, W) of
    ``plane_dtype``, mask (H, W) int32, bounds (L, 4) int32, lights (L, 6)
    f32, consts (4,) f32).  The bounds use (W, H), or (W, ``full_height``)
    for a band, as the reference's do."""
    h, w = covered.shape
    if h % TILE_H or w % TILE_W:
        raise ValueError(f"frame {w}x{h}: a multiple of {TILE_W}x{TILE_H}")
    if plane_dtype not in PLANE_DTYPES:
        raise ValueError(f"plane_dtype {plane_dtype}: float32 or bfloat16")
    dev = covered.device

    def f32(x):
        return torch.as_tensor(x, dtype=F32, device=dev)

    light_pos, light_color = f32(light_pos), f32(light_color)
    bounds = light_screen_bounds(light_pos, light_color, f32(view_proj), w,
                                 h if full_height is None else full_height)
    planes = torch.stack(
        list(albedo.unbind(-1)) + list(normal.unbind(-1))
        + list(world.unbind(-1))
        + [f32(metallic).expand(h, w), f32(roughness).expand(h, w)]
    ).to(plane_dtype)
    lights = torch.cat([light_pos, light_color], dim=1).contiguous()
    consts = torch.cat([f32(cam_pos).reshape(3), f32([_f32(ambient)])])
    return planes, covered.to(I32), bounds, lights, consts


def tiled_deferred_lighting(albedo, normal, world, covered, cam_pos,
                            light_pos, light_color, view_proj, ambient=0.03,
                            roughness=0.4, metallic=0.0, plane_dtype=F32,
                            row_offset: int = 0,
                            full_height: int | None = None):
    """Light a frame with K7.  albedo/normal/world (H, W, 3) f32, covered
    (H, W) bool, H and W tile multiples; roughness/metallic scalars or
    (H, W) planes; light_pos/light_color (L, 3); view_proj (4, 4)
    row-vector.  Returns (H, W, 3) f32 linear RGB.

    The bounds use (W, H), or (W, ``full_height``) for a band whose first
    row is global row ``row_offset``, as the reference does: the padded
    frame's size when the caller pads."""
    inputs = light_inputs(albedo, normal, world, covered, cam_pos, light_pos,
                          light_color, view_proj, ambient, roughness,
                          metallic, plane_dtype, full_height)
    return tiled_light(*inputs, row_offset).permute(1, 2, 0)
