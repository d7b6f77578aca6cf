"""Two-class windowed raster (K10hbm2): the two-class prepare, the CUDA
kernel's wrapper and its plain torch version.

Counterpart of ``zrenderer_tpu/ops/experiments/raster_hbm2.py``
(``rasterize_setup_pallas_hbm2``).  ``prepare_raster_inputs_2class`` pads
the setup rows to RASTER_BLOCK (not compacted: the row ids are the padded
rows' indices) and splits them into two views of the same rows: the short
view, where every row but the short ones (live, bbox spanning at most
SHORT_ROWS pixel rows) is killed (empty bbox, valid 0), and the tall view,
where the short rows are; each view has its own block and superblock
tables.  Over each 32x128 tile the kernel walks the short view's
hierarchy and evaluates each hit row on the 8 tile rows from
``clamp(imin - row0, 0, 24)``, all 128 columns, then the tall view's,
each hit row over the whole tile.  The depth test is (z, row id) against
the clear values (1.0, INT32_MAX), so the passes' order does not matter.

Against K5 (sequential strict less from z = 1.0): the visible rows are
equal bit for bit except where a pixel's least z is exactly 1.0, which
this kernel latches and K5 leaves clear (the reference's docstring calls
the two bit-identical).  Below the geometry's frame each kernel draws by
its own extent: a short row only on its 8-row window, a tall row over the
whole tile.

The reference's kernel does not run: ``_hbm2_kernel`` reads ``_INT_MAX``,
``I32_LANES``, ``F32_LANES`` and ``_tri_unroll``, which its module never
imports, and raises ``NameError``.  Its 4-records-a-row packing
(``_hbm_flat_inputs``) is TPU DMA layout: the views here stay (T, NI32)
and (T, NF32).  CUDA: ``csrc/raster_twoclass.cu``, on K5's keyed
hierarchy body: both views' hit words, each tile's hit blocks of both
views cut into TWOCLASS_ITEMS work items, each row evaluated over its
window (its vertices' pixel bbox in the tile, within the kernel's extent:
``window_rects``) into one key plane, one resolve.

The plain versions here and in ``raster_scanline`` share one form: every
fragment the kernel evaluates becomes an int64 key (z bits << 32 | row
id), -0.0 keyed as +0.0, and a scatter-min over the frame keeps each
pixel's lexicographic (z, id) minimum, the same winner the sequential
(z, id) test keeps in any order; the winner's planes are then recomputed
at its pixel with the kernels' arithmetic.
"""

from __future__ import annotations

import torch

from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.geometry import (
    F_CB2,
    F_ZA0,
    I_BIAS0,
    I_DX0,
    I_DX1,
    I_DX2,
    I_DY0,
    I_DY1,
    I_DY2,
    I_IMAX,
    I_IMIN,
    I_JMAX,
    I_JMIN,
    I_X0,
    I_X1,
    I_X2,
    I_Y0,
    I_Y1,
    I_Y2,
    NF32,
    NI32,
    RASTER_BLOCK,
    SUBPIXEL,
    SUPER_BLOCK,
)

I32, I64, F32 = torch.int32, torch.int64, torch.float32
# (z, id) key of the clear pixel: z = 1.0 (bits 0x3F800000), id INT32_MAX.
KEY_CLEAR = (0x3F800000 << 32) | tr._INT_MAX
# Pixels a chunk of the plain versions' window evaluations holds.
CHUNK_PIXELS = 1 << 22
# (dx, dy, x, y) columns of edge k, as the kernels pair them.
EDGES = ((I_DX0, I_DY0, I_X1, I_Y1), (I_DX1, I_DY1, I_X2, I_Y2),
         (I_DX2, I_DY2, I_X0, I_Y0))
COEFS = F_CB2 + 1 - F_ZA0  # z, 1/w, r, g, b: three coefficients each
# K10hbm2 and K10scan on the card: each tile's hit blocks of the two views
# are cut into this many work items, one CUDA block each, merged through
# the output's key plane (csrc/raster_twoclass.cu); one item a tile
# resolves in place.  The wrappers read it at call time.  On the H100 at
# lattice1M, 1/4/8/16/32 items took 1.78/0.96/0.67/0.60/0.59 ms a call
# (K10hbm2) and 1.84/0.96/0.71/0.64/0.63 (K10scan; PERF.md §6).
TWOCLASS_ITEMS = 32


# ---------------------------------------------------------------------------
# Prepare
# ---------------------------------------------------------------------------


def split_classes(tri_i32):
    """The two views of padded rows: (short, supers_s, blocks_s, ti_short,
    supers_t, blocks_t, ti_tall), ``short`` the (T,) class mask
    (``raster.classify_short``)."""
    short = tr.classify_short(tri_i32)
    ti_short = tr.kill_rows(tri_i32, ~short)
    ti_tall = tr.kill_rows(tri_i32, short)
    blocks_s, supers_s = tg.super_bounds(tg.block_bounds(ti_short))
    blocks_t, supers_t = tg.super_bounds(tg.block_bounds(ti_tall))
    return short, supers_s, blocks_s, ti_short, supers_t, blocks_t, ti_tall


def prepare_raster_inputs_2class(tri_i32, tri_f32):
    """Pad (``raster._pad_rows``), split the classes and build each
    view's tables: (supers_s, blocks_s, ti_short, supers_t, blocks_t,
    ti_tall, tri_f32)."""
    tri_i32, tri_f32 = tr._pad_rows(tri_i32, tri_f32)
    return (*split_classes(tri_i32)[1:], tri_f32)


# ---------------------------------------------------------------------------
# Plain torch version (shared with raster_scanline)
# ---------------------------------------------------------------------------


def _floor_div(x, d: int):
    return torch.div(x, d, rounding_mode="floor")


def rect_pairs(rect, blocks, supers, width: int, height: int):
    """(item, tile y, tile x) of every tile that rectangle ``rect`` (n, 4)
    [jmin, jmax, imin, imax] of item i meets (the kernels' tile_overlap),
    kept where item i's block (i // RASTER_BLOCK) and superblock meet the
    tile too (the kernels' hierarchy skips).  int64 tensors."""
    ty, tx = height // tr.TILE_H, width // tr.TILE_W
    dev = rect.device
    jmin, jmax, imin, imax = rect.to(I64).unbind(1)
    live = (jmin <= jmax) & (imin <= imax)
    x0 = _floor_div(jmin, tr.TILE_W).clamp(min=0)
    x1 = _floor_div(jmax, tr.TILE_W).clamp(max=tx - 1)
    y0 = _floor_div(imin, tr.TILE_H).clamp(min=0)
    y1 = _floor_div(imax, tr.TILE_H).clamp(max=ty - 1)
    nx = (x1 - x0 + 1).clamp(min=0)
    n = torch.where(live, nx * (y1 - y0 + 1).clamp(min=0), 0)
    item = torch.repeat_interleave(torch.arange(rect.shape[0], device=dev), n)
    k = torch.arange(item.numel(), device=dev) - (torch.cumsum(n, 0) - n)[item]
    nxi = nx[item]  # >= 1 for every listed item
    tile_y = y0[item] + _floor_div(k, nxi)
    tile_x = x0[item] + k % nxi
    tile = tile_y * tx + tile_x
    block = item // RASTER_BLOCK
    keep = (tr._tile_hits(blocks, ty, tx)[tile, block]
            & tr._tile_hits(supers, ty, tx)[tile, block // SUPER_BLOCK])
    return item[keep], tile_y[keep], tile_x[keep]


def zid_key(z, ids):
    """The (z, id) int64 key of fragments at depth ``z`` of rows ``ids``:
    z's bits over the id, -0.0 keyed as +0.0."""
    zbits = torch.where(z == 0.0, 0.0, z).view(I32).to(I64)
    return (zbits << 32) | ids.to(I64)


def window_min(keys, width: int, y0, x0, win_h: int, base, sy, sx, bias,
               za, ids, rows=None, cols=None, key_of=zid_key,
               clear=KEY_CLEAR):
    """Scatter-min the keys of the fragments of P window evaluations into
    ``keys`` (H * W int64, in place).  Evaluation p covers the win_h x
    TILE_W pixels from global (row y0[p], column x0[p]); its edge function
    k at window pixel (i, j) is base[p, k] + sy[p, k] * i - sx[p, k] * j
    (int32, wrapping), its coverage biases bias[p], z plane za[p] ((e0*za0
    + e1*za1) + e2*za2) and id ids[p].  ``rows``/``cols``: (P, 2) inclusive
    global ranges a fragment must lie in, or None.  A fragment's key is
    ``key_of(z, id)`` (the (z, id) key by default), a pixel outside the
    fragments ``clear``."""
    total = y0.shape[0]
    step = max(1, CHUNK_PIXELS // (win_h * tr.TILE_W))
    dev = keys.device
    i = torch.arange(win_h, dtype=I32, device=dev)[:, None]
    j = torch.arange(tr.TILE_W, dtype=I32, device=dev)[None, :]
    for s in range(0, total, step):
        c = slice(s, min(s + step, total))

        def per(a, k):
            return a[c, k, None, None]

        e = [per(base, k) + per(sy, k) * i - per(sx, k) * j
             for k in range(3)]
        ok = ((e[0] >= per(bias, 0)) & (e[1] >= per(bias, 1))
              & (e[2] >= per(bias, 2)))
        ef = [ek.to(F32) for ek in e]
        z = (ef[0] * per(za, 0) + ef[1] * per(za, 1)) + ef[2] * per(za, 2)
        ok &= z >= 0.0
        y = y0[c, None, None] + i
        x = x0[c, None, None] + j
        if rows is not None:
            ok &= (y >= rows[c, 0, None, None]) & (y <= rows[c, 1, None, None])
        if cols is not None:
            ok &= (x >= cols[c, 0, None, None]) & (x <= cols[c, 1, None, None])
        key = torch.where(ok, key_of(z, ids[c, None, None]), clear)
        keys.scatter_reduce_(0, (y.to(I64) * width + x).reshape(-1),
                             key.reshape(-1), reduce="amin")


def edge_windows(ti, y0, x0):
    """(base, sy, sx) of ``window_min`` for setup rows ``ti`` (P, NI32) at
    window origins (y0, x0): edge_fn at the origin's pixel centre and its
    per-row and per-column steps 8*dx and 8*dy."""
    half = SUBPIXEL // 2
    py = (y0 * SUBPIXEL + half).to(I32)
    px = (x0 * SUBPIXEL + half).to(I32)
    base, sy, sx = [], [], []
    for dxc, dyc, xc, yc in EDGES:
        dx, dy = ti[:, dxc], ti[:, dyc]
        base.append(dx * (py - ti[:, yc]) - dy * (px - ti[:, xc]))
        sy.append(dx * SUBPIXEL)
        sx.append(dy * SUBPIXEL)
    return (torch.stack(base, 1), torch.stack(sy, 1), torch.stack(sx, 1))


def view_min(keys, ti, tf, blocks, supers, width: int, height: int,
             short: bool):
    """Fragments of one view's hierarchy walk into ``keys``: each row
    whose bbox meets a tile, over the whole tile, or with ``short`` over
    the SHORT_ROWS tile rows from clamp(imin - row0, 0, TILE_H -
    SHORT_ROWS), all columns (K10hbm2's short pass)."""
    rows, tile_y, tile_x = rect_pairs(ti[:, [I_JMIN, I_JMAX, I_IMIN, I_IMAX]],
                                      blocks, supers, width, height)
    r = ti[rows]
    y0 = tile_y * tr.TILE_H
    x0 = tile_x * tr.TILE_W
    win_h = tr.TILE_H
    if short:
        win_h = tr.SHORT_ROWS
        y0 = y0 + (r[:, I_IMIN].to(I64) - y0).clamp(0, tr.TILE_H - win_h)
    base, sy, sx = edge_windows(r, y0, x0)
    window_min(keys, width, y0, x0, win_h, base, sy, sx,
               r[:, I_BIAS0:I_BIAS0 + 3], tf[rows, F_ZA0:F_ZA0 + 3], rows)


def window_rects(ti, rows, tile_y, tile_x, short: bool):
    """The CUDA kernels' window of each (tile, row) pair of a view: (P, 4)
    int64 [jmin, jmax, imin, imax], row ``rows``'s vertices' pixel bbox
    (``raster.vertex_bbox``) in tile (tile_y, tile_x), with ``short``
    within K10hbm2's short extent (the SHORT_ROWS tile rows from
    clamp(imin - row0, 0, TILE_H - SHORT_ROWS)); empty where jmin > jmax or
    imin > imax."""
    jmin, jmax, imin, imax = tr.vertex_bbox(ti[rows].to(I64)).unbind(1)
    r0, c0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    lo, hi = r0, r0 + tr.TILE_H - 1
    if short:
        lo = r0 + (ti[rows, I_IMIN].to(I64) - r0).clamp(
            0, tr.TILE_H - tr.SHORT_ROWS)
        hi = lo + tr.SHORT_ROWS - 1
    return torch.stack([torch.maximum(jmin, c0),
                        torch.minimum(jmax, c0 + tr.TILE_W - 1),
                        torch.maximum(imin, lo), torch.minimum(imax, hi)],
                       1)


def winners(keys):
    """(won (H*W,) bool, winning row id (H*W,) int64, 0 where nothing
    won) of a key plane."""
    won = keys != KEY_CLEAR
    return won, torch.where(won, keys & tr._INT_MAX, 0)


def pixel_edges(ti, width: int, height: int):
    """The edge functions of setup rows ``ti`` (H*W, NI32), one a pixel,
    at their pixel's centre: three (H*W,) int32 tensors."""
    dev = ti.device
    half = SUBPIXEL // 2
    py = (torch.arange(height, dtype=I32, device=dev)[:, None] * SUBPIXEL
          + half).expand(height, width).reshape(-1)
    px = (torch.arange(width, dtype=I32, device=dev)[None, :] * SUBPIXEL
          + half).expand(height, width).reshape(-1)
    return [ti[:, dx] * (py - ti[:, y]) - ti[:, dy] * (px - ti[:, x])
            for dx, dy, x, y in EDGES]


def resolve(won, edges, coefs, width: int, height: int,
            masked_inv: bool | None = None):
    """The winners' planes and K5's epilogue: z, 1/w and colour numerators
    ((e0*c0 + e1*c1) + e2*c2) from each pixel's winner's edge functions
    ``edges`` and setup floats ``coefs`` (H*W, COEFS or more) (z, 1/w, r,
    g, b, ...), the clear values where nothing ``won``; one divide a
    pixel.  Returns (packed i32, depth f32), (height, width).  With
    ``masked_inv`` a bool, ``coefs`` holds each winner's NF32 setup floats
    and the GBUFFER_PLANES planes are returned, the uv and normal
    numerators interpolated and the constants read from the winner, in
    ``raster._resolve_gbuffer``'s epilogue form (``masked_inv``: buf *
    (covered ? inv : 0); else covered ? buf * inv : 0)."""
    ef = [e.to(F32) for e in edges]
    shape = (1, 1, height, width)

    def interp(c):
        v = (ef[0] * coefs[:, c] + ef[1] * coefs[:, c + 1]) \
            + ef[2] * coefs[:, c + 2]
        return v.reshape(shape)

    clear = won.logical_not().reshape(shape)
    gbuffer = masked_inv is not None
    latches = tr._LATCHES + (tr._GBUF_LATCHES if gbuffer else ())
    planes = {name: torch.where(clear, 1.0 if name == "z" else 0.0,
                                interp(c - F_ZA0))
              for name, c in (("z", F_ZA0),) + latches}
    if not gbuffer:
        return tr._resolve_planes(planes)
    for name, c in tr._CONSTS:
        planes[name] = torch.where(clear, 0.0,
                                   coefs[:, c - F_ZA0].reshape(shape))
    return tr._resolve_gbuffer(planes, masked_inv)


def hbm2_keys(supers_s, blocks_s, ti_short, supers_t, blocks_t, ti_tall, tf,
              width: int, height: int):
    """K10hbm2's (H*W,) int64 (z, row id) key plane: each pixel's least
    fragment of both passes."""
    keys = torch.full((height * width,), KEY_CLEAR, dtype=I64,
                      device=tf.device)
    view_min(keys, ti_short, tf, blocks_s, supers_s, width, height, True)
    view_min(keys, ti_tall, tf, blocks_t, supers_t, width, height, False)
    return keys


def raster_hbm2_plain(supers_s, blocks_s, ti_short, supers_t, blocks_t,
                      ti_tall, tf, width: int, height: int):
    """Plain torch K10hbm2 over ``prepare_raster_inputs_2class``'s
    outputs: (packed i32, depth f32)."""
    tr._check_frame(width, height)
    won, wid = winners(hbm2_keys(supers_s, blocks_s, ti_short, supers_t,
                                 blocks_t, ti_tall, tf, width, height))
    # kill_rows keeps a row's edge columns: either view serves the winner.
    return resolve(won, pixel_edges(ti_tall[wid], width, height),
                   tf[wid, F_ZA0:F_CB2 + 1], width, height)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/raster_twoclass.cu)
# ---------------------------------------------------------------------------


def require_views(supers_s, blocks_s, rec_s, supers_t, blocks_t, ti_t, tf,
                  rec_lanes: int, rec_dtype):
    """Check the two-class kernels' inputs: CUDA, contiguous, the tables
    (S, 8) and (S * SUPER_BLOCK, 8) covering the rows, the short records
    (T, rec_lanes) of ``rec_dtype``, the tall view (T, NI32), tf (T,
    NF32)."""
    dev = tf.device
    rows = tf.shape[0]
    want = {"supers_s": (supers_s, I32, 8), "blocks_s": (blocks_s, I32, 8),
            "short rows": (rec_s, rec_dtype, rec_lanes),
            "supers_t": (supers_t, I32, 8), "blocks_t": (blocks_t, I32, 8),
            "ti_tall": (ti_t, I32, NI32), "tf": (tf, F32, NF32)}
    for name, (t, dtype, lanes) in want.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensor on {dev} expected, got "
                             f"{t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {dtype} expected, got {t.dtype}")
        if not t.is_contiguous() or t.ndim != 2 or t.shape[1] != lanes:
            raise ValueError(f"{name}: contiguous (n, {lanes}) expected, got "
                             f"{tuple(t.shape)}")
    if rows % RASTER_BLOCK or rec_s.shape[0] != rows or ti_t.shape[0] != rows:
        raise ValueError(f"{rows} rows in every view, a multiple of "
                         f"{RASTER_BLOCK}, expected")
    for sup, blk in ((supers_s, blocks_s), (supers_t, blocks_t)):
        if (blk.shape[0] != sup.shape[0] * SUPER_BLOCK
                or blk.shape[0] * RASTER_BLOCK < rows):
            raise ValueError("blocks/supers do not match the rows")


def launch_views(fn, width: int, height: int, supers_s, blocks_s, rec_s,
                 supers_t, blocks_t, ti_t, tf):
    """Launch a two-class kernel on the current stream in TWOCLASS_ITEMS
    work items a tile -> (packed i32, depth f32).  Its scratch: both
    views' hit words (tiles * (2 S + 1) ints each) and, with more than one
    item, the key plane of the output's size."""
    items = TWOCLASS_ITEMS
    if items < 1:
        raise ValueError(f"TWOCLASS_ITEMS must be positive, got {items}")
    dev = tf.device
    tiles = (height // tr.TILE_H) * (width // tr.TILE_W)
    n_s, n_t = supers_s.shape[0], supers_t.shape[0]
    buf = torch.empty(tiles * (2 * n_s + 1) + tiles * (2 * n_t + 1),
                      dtype=I32, device=dev)
    plane = (torch.empty(height * width, dtype=I64, device=dev)
             if items > 1 else None)
    p = tr._ptr
    return tr._run(fn, dev, width, height, p(supers_s), n_s, p(blocks_s),
                   p(rec_s), p(supers_t), n_t, p(blocks_t), p(ti_t), p(tf),
                   items, p(buf), None if plane is None else p(plane))


def raster_hbm2_kernel(supers_s, blocks_s, ti_short, supers_t, blocks_t,
                       ti_tall, tf, width: int, height: int):
    """Launch K10hbm2 (``csrc/raster_twoclass.cu``) on the current stream
    -> (packed i32, depth f32)."""
    tr._check_frame(width, height)
    args = (supers_s, blocks_s, ti_short, supers_t, blocks_t, ti_tall, tf)
    require_views(*args, NI32, I32)
    out = launch_views(_build.load_library().zr_raster_hbm2, width, height,
                       *args)
    raster_hbm2_kernel.launches += 1
    return out


KERNELS = (raster_hbm2_kernel,)
raster_hbm2_kernel.launches = 0


def rasterize_setup_hbm2(tri_i32, tri_f32, width: int, height: int):
    """K10hbm2: the two-class prepare, then the kernel (CUDA tensors) or its
    plain version (CPU tensors) -> (packed i32, depth f32) over the
    (height, width) padded frame."""
    tr._check_frame(width, height)
    prepared = prepare_raster_inputs_2class(tri_i32, tri_f32)
    if tr._on_cpu(tri_i32):
        return raster_hbm2_plain(*prepared, width, height)
    return raster_hbm2_kernel(*prepared, width, height)
