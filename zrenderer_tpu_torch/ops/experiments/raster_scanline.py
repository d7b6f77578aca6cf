"""Scanline-grouped two-class raster (K10scan): the prepare, the CUDA
kernel's wrapper and its plain torch version.

Counterpart of ``zrenderer_tpu/ops/experiments/raster_scanline.py``
(``rasterize_setup_pallas_scanline``).  ``prepare_scanline_inputs`` pads
the setup rows as the reference does (padding rows with JMIN = IMIN = 1
and dead biases) and splits them into K10hbm2's short and tall views
(``raster_hbm2.split_classes``).  Each row of the short view becomes a
wide record (WIDE_LANES lanes, the map below): its edge functions in the
form A + S*dh - D*x (A at row imin and column 0, int32 bits), the
biases, imin, its row span h (-1 for a row that is not short), its
columns and its id + 1 as f32, and the 15 z, 1/w and colour
coefficients.  The records are sorted stably by
``block << 12 | clip(imin, 0, 4095)``, so they stay inside their
RASTER_BLOCK block and the short view's block tables still hold; lanes
4-7 of the short block table carry the pass count of each of the block's
four 32-record groups, min(max h + 1, SHORT_ROWS) (0: the group never
runs).

Over each 32x128 tile the kernel runs the tall view as K10hbm2 does,
then walks the short view's hierarchy and, per group with a pass count
P > 0, each record at the pixels of rows imin + dh, 0 <= dh <= min(h,
P - 1), and columns [jmin, jmax].  The depth test is (z, row id) against
(1.0, INT32_MAX), the id the record's original row; a short row's z is
stored plus 0.0 (a -0.0 as +0.0), which is what the reference's one-hot
sum does to a winner.  The reference evaluates 32 records as one (32,
128) vector per row offset, takes each same-row run's (z, id) minimum
with a sublane roll-min and scatters it with an exact one-hot matmul;
that gives the per-pixel (z, id) minimum of the same fragments, which is
what the CUDA kernel and the plain version compute.  Its 128-lane records,
f32 id carry and 12-bit sort key exist for the TPU's DMAs and Mosaic's
casts: the records here hold the 32 lanes in use.  CUDA:
``csrc/raster_twoclass.cu``, on K10hbm2's keyed body: the short records
and the tall rows of a tile's work item in one batch list, a record over
its rectangle in the tile, one key plane whose tag carries each row's
class, so that the resolve, which re-evaluates every winner from the tall
view's row, adds 0.0 to a short winner's z.

Against K5 the visible rows are equal bit for bit except where a pixel's
least z is exactly 1.0 (latched here) or its winner's z is -0.0 (stored
+0.0 here).  Below the geometry's frame a short row draws only inside its
bbox rows and columns.
"""

from __future__ import annotations

import torch

from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as h2
from zrenderer_tpu_torch.ops.geometry import (
    F_CB2,
    F_ZA0,
    I_BIAS0,
    I_BIAS2,
    I_IMAX,
    I_IMIN,
    I_JMAX,
    I_JMIN,
    NF32,
    NI32,
    RASTER_BLOCK,
    SUBPIXEL,
)

GROUP = 32  # records per pass-count group; 4 a block (lanes 4-7)
# Wide-record lanes: 0-11 int32 bits, 12 on f32.
WL_A0, WL_A1, WL_A2 = 0, 1, 2        # edge value at (row imin, column 0)
WL_D0, WL_D1, WL_D2 = 3, 4, 5        # per-column edge step (8*dy)
WL_S0, WL_S1, WL_S2 = 6, 7, 8        # per-row edge step (8*dx)
WL_B0, WL_B1, WL_B2 = 9, 10, 11      # coverage biases
WL_IMIN, WL_H = 12, 13               # first row, row span (-1: not short)
WL_JMINF, WL_JMAXF = 14, 15          # column bbox
WL_IDF = 16                          # original row id + 1
WL_ZA0 = 17                          # 17-19 z, 20-22 1/w,
WL_RW0 = 20                          # 23-31 r, g, b coefficients
WL_CR0, WL_CG0, WL_CB0 = 23, 26, 29
WIDE_LANES = 32
# The reference's limits: the sort key packs imin into 12 bits, and the
# TPU carried id + 1 in f32.
MAX_HEIGHT = 4096
MAX_ROWS = 1 << 23

I32, I64, F32 = torch.int32, torch.int64, torch.float32


def prepare_scanline_inputs(tri_i32, tri_f32, height: int | None = None):
    """K10scan prepare: (supers_s, blocks8_s, wide_p, supers_t, blocks_t,
    ti_tall, tf).  ``blocks8_s``: the short view's block table with the
    group pass counts in lanes 4-7; ``wide_p``: (T, WIDE_LANES) f32
    records in sorted order.  Raises ValueError where the reference
    asserts: ``height`` (when given) above MAX_HEIGHT, MAX_ROWS or more
    padded rows."""
    if height is not None and height > MAX_HEIGHT:
        raise ValueError(f"height {height} > {MAX_HEIGHT}: the row sort key "
                         "packs imin into 12 bits")
    t = tri_i32.shape[0]
    pad = (-t) % RASTER_BLOCK
    if t + pad >= MAX_ROWS:
        raise ValueError(f"{t + pad} rows: the ids need fewer than "
                         f"{MAX_ROWS}")
    if pad:
        dead = torch.zeros((pad, NI32), dtype=I32, device=tri_i32.device)
        dead[:, I_JMIN] = 1
        dead[:, I_IMIN] = 1
        dead[:, I_BIAS0:I_BIAS2 + 1] = tr._INT_MAX
        tri_i32 = torch.cat([tri_i32, dead])
        tri_f32 = torch.cat([tri_f32, torch.zeros((pad, NF32), dtype=F32,
                                                  device=tri_f32.device)])
    t += pad
    (short, supers_s, blocks_s, ti_short, supers_t, blocks_t,
     ti_tall) = h2.split_classes(tri_i32)

    def c(k):
        return ti_short[:, k]

    imin = c(I_IMIN)
    h = torch.where(short, c(I_IMAX) - imin, -1)
    half = SUBPIXEL // 2
    py0 = imin * SUBPIXEL + half
    edges = []
    for dxk, dyk, xk, yk in h2.EDGES:
        dx, dy = c(dxk), c(dyk)
        # e(imin + dh, x) = dx*(py0 + 8*dh - y) - dy*(8*x + half - x_k)
        edges.append((dx * (py0 - c(yk)) - dy * (half - c(xk)),
                      dy * SUBPIXEL, dx * SUBPIXEL))
    ints = torch.stack([a for a, _, _ in edges] + [d for _, d, _ in edges]
                       + [s for _, _, s in edges]
                       + [c(I_BIAS0 + k) for k in range(3)], dim=1)
    flts = torch.stack([imin.to(F32), h.to(F32), c(I_JMIN).to(F32),
                        c(I_JMAX).to(F32),
                        torch.arange(1, t + 1, dtype=F32,
                                     device=tri_i32.device)], dim=1)
    wide = torch.cat([ints.view(F32), flts, tri_f32[:, F_ZA0:F_CB2 + 1]],
                     dim=1)
    key = ((torch.arange(t, dtype=I32, device=tri_i32.device)
            // RASTER_BLOCK) << 12) | imin.clamp(0, MAX_HEIGHT - 1)
    wide_p = wide[torch.argsort(key, stable=True)]
    passes = (wide_p[:, WL_H].to(I32) + 1).clamp(0, tr.SHORT_ROWS)
    blocks8_s = blocks_s.clone()
    groups = RASTER_BLOCK // GROUP
    blocks8_s[:, 4:4 + groups] = 0
    blocks8_s[:t // RASTER_BLOCK, 4:4 + groups] = passes.reshape(
        -1, groups, GROUP).amax(dim=2)
    return supers_s, blocks8_s, wide_p, supers_t, blocks_t, ti_tall, tri_f32


# ---------------------------------------------------------------------------
# Plain torch version
# ---------------------------------------------------------------------------


def _wide_ints(wide, lane):
    return wide[:, lane:lane + 3].contiguous().view(I32)


def record_rects(blocks8_s, wide_p):
    """(T, 4) int64 [jmin, jmax, imin, last] of each sorted record: the
    rows imin..last = imin + min(h, P - 1), P its group's pass count, and
    the columns the kernel evaluates it at (empty where h < 0 or P == 0)."""
    slot = torch.arange(wide_p.shape[0], device=wide_p.device)
    passes = blocks8_s[slot // RASTER_BLOCK,
                       4 + (slot % RASTER_BLOCK) // GROUP].to(I64)
    imin = wide_p[:, WL_IMIN].to(I64)
    last = imin + torch.minimum(wide_p[:, WL_H].to(I64), passes - 1)
    return torch.stack([wide_p[:, WL_JMINF].to(I64),
                        wide_p[:, WL_JMAXF].to(I64), imin, last], 1)


def scanline_keys(supers_s, blocks8_s, wide_p, supers_t, blocks_t, ti_tall,
                  tf, width: int, height: int):
    """K10scan's (H*W,) int64 (z, row id) key plane: each pixel's least
    fragment of the tall pass and the short records."""
    tr._check_frame(width, height)
    keys = torch.full((height * width,), h2.KEY_CLEAR, dtype=I64,
                      device=tf.device)
    h2.view_min(keys, ti_tall, tf, blocks_t, supers_t, width, height, False)
    # Short records: the fragments inside each record's rect.
    rect = record_rects(blocks8_s, wide_p)
    rec, tile_y, tile_x = h2.rect_pairs(rect, blocks8_s, supers_s, width,
                                        height)
    w, r = wide_p[rec], rect[rec]
    imin = r[:, 2]
    y0 = tile_y * tr.TILE_H
    y0 = y0 + (imin - y0).clamp(0, tr.TILE_H - tr.SHORT_ROWS)
    x0 = tile_x * tr.TILE_W
    a, d, s = (_wide_ints(w, lane) for lane in (WL_A0, WL_D0, WL_S0))
    # The window origin's edge values: A + S*(y0 - imin) - D*x0.
    base = a + s * (y0 - imin).to(I32)[:, None] - d * x0.to(I32)[:, None]
    h2.window_min(keys, width, y0, x0, tr.SHORT_ROWS, base, s, d,
                  _wide_ints(w, WL_B0), w[:, WL_ZA0:WL_ZA0 + 3],
                  w[:, WL_IDF].to(I64) - 1, rows=r[:, 2:], cols=r[:, :2])
    return keys


def raster_scanline_plain(supers_s, blocks8_s, wide_p, supers_t, blocks_t,
                          ti_tall, tf, width: int, height: int):
    """Plain torch K10scan over ``prepare_scanline_inputs``' outputs:
    (packed i32, depth f32)."""
    tr._check_frame(width, height)
    dev = tf.device
    keys = scanline_keys(supers_s, blocks8_s, wide_p, supers_t, blocks_t,
                         ti_tall, tf, width, height)
    won, wid = h2.winners(keys)
    # Each pixel's winner: a short row (h >= 0 in its record) from its
    # record, its z plus 0.0; a tall row from the tall view.
    pos = torch.empty(wide_p.shape[0], dtype=I64, device=dev)
    pos[wide_p[:, WL_IDF].to(I64) - 1] = torch.arange(wide_p.shape[0],
                                                      device=dev)
    wrec = wide_p[pos[wid]]
    is_short = won & (wrec[:, WL_H] >= 0)
    e_tall = h2.pixel_edges(ti_tall[wid], width, height)
    row = torch.arange(height, dtype=I32, device=dev)[:, None].expand(
        height, width).reshape(-1)
    col = torch.arange(width, dtype=I32, device=dev)[None, :].expand(
        height, width).reshape(-1)
    dh = row - wrec[:, WL_IMIN].to(I32)
    e_short = [a_k + s_k * dh - d_k * col for a_k, d_k, s_k in zip(
        _wide_ints(wrec, WL_A0).unbind(1), _wide_ints(wrec, WL_D0).unbind(1),
        _wide_ints(wrec, WL_S0).unbind(1))]
    edges = [torch.where(is_short, es, et) for es, et in zip(e_short, e_tall)]
    coefs = torch.where(is_short[:, None],
                        wrec[:, WL_ZA0:WL_ZA0 + h2.COEFS],
                        tf[wid, F_ZA0:F_CB2 + 1])
    color, depth = h2.resolve(won, edges, coefs, width, height)
    depth = torch.where(is_short.reshape(height, width), depth + 0.0, depth)
    return color, depth


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/raster_twoclass.cu)
# ---------------------------------------------------------------------------


def raster_scanline_kernel(supers_s, blocks8_s, wide_p, supers_t, blocks_t,
                           ti_tall, tf, width: int, height: int):
    """Launch K10scan (``csrc/raster_twoclass.cu``) on the current stream
    -> (packed i32, depth f32)."""
    tr._check_frame(width, height)
    args = (supers_s, blocks8_s, wide_p, supers_t, blocks_t, ti_tall, tf)
    h2.require_views(*args, WIDE_LANES, F32)
    out = h2.launch_views(_build.load_library().zr_raster_scan, width,
                          height, *args)
    raster_scanline_kernel.launches += 1
    return out


KERNELS = (raster_scanline_kernel,)
raster_scanline_kernel.launches = 0


def rasterize_setup_scanline(tri_i32, tri_f32, width: int, height: int):
    """K10scan: the prepare, then the kernel (CUDA tensors) or its plain
    version (CPU tensors) -> (packed i32, depth f32)."""
    tr._check_frame(width, height)
    prepared = prepare_scanline_inputs(tri_i32, tri_f32, height)
    if tr._on_cpu(tri_i32):
        return raster_scanline_plain(*prepared, width, height)
    return raster_scanline_kernel(*prepared, width, height)
