"""Lane-parallel block-grouped raster (K10vec, K10vecg): prepare, the CUDA
kernels' wrappers and their plain torch versions.

Counterpart of ``zrenderer_tpu/ops/experiments/raster_vec.py``
(``rasterize_setup_pallas_vec``, ``rasterize_gbuffer_pallas_vec``):

* ``prepare_vec_inputs`` pads the setup rows to RASTER_BLOCK (padding rows
  with JMIN = 1, everything else 0) and packs one record per row: the
  setup ints in lanes [0, 20), the folded edge constants
  a_k = dy_k*x_ref - dx_k*y_ref in lanes [20, 23), the union bbox of the
  valid rows of each 32-row subgroup in lanes [24, 28) of its first row,
  and the setup floats bitcast to int32 in lanes [32, 72), with the
  block and superblock union-bbox tables;
* over each 32x128 tile the kernel walks the superblocks and blocks whose
  bbox meets the tile; per 32-row subgroup whose bbox meets an 8-row
  chunk of the tile, every live record (valid, non-empty bbox) is
  evaluated at the chunk's pixels with e_k = (a_k + dx_k*py) - dy_k*px
  (int32, wrapping);
* the subgroup's winner is its (z, row id) minimum, merged into the tile
  by the strict-less test, so exact ties go to the first row; colour and
  depth as the production kernels, the G-buffer interpolants as
  ``where(covered, buf*inv, 0)`` (K3g's form), the constants as latched.

The TPU kernel's 128-lane records exist for its DMAs, and its one-hot
matrix product only gathers the winner's coefficients: records here keep
the REC_LANES lanes in use, and the winner's attributes are read from its
record.  CUDA: ``csrc/raster_vec.cu``.  K10vec runs the keyed hierarchy
body: each tile's hit blocks (``raster.hier_block_hits``) are cut into
VEC_ITEMS work items; an item pends the live rows of each hit subgroup
(``admitted_rows``) and evaluates each over its window (``window_rects``:
the row's vertices' pixel bbox in the tile, within its subgroup's hit
chunks) into one key a pixel, (order bits of z, row id) from the strict
clear key (``KEY_CLEAR``); the items merge through a key plane and the
planes are resolved from the winners' records (``key_planes``).  K10vecg
runs the same body with the 13 planes under K3g's epilogue
(``key_planes(..., gbuffer=True)``).
"""

from __future__ import annotations

import torch

from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as h2
from zrenderer_tpu_torch.ops.geometry import (
    F_CB0,
    F_CG0,
    F_CR0,
    F_MET,
    F_NX0,
    F_NY0,
    F_NZ0,
    F_RW0,
    F_U0,
    F_V0,
    F_ZA0,
    I_BIAS0,
    I_BIAS1,
    I_BIAS2,
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
    I_VALID,
    I_X0,
    I_X1,
    I_X2,
    I_Y0,
    I_Y1,
    I_Y2,
    NF32,
    NI32,
    RASTER_BLOCK,
)

SUBGROUP = 32  # rows per subgroup (one union bbox)
CHUNK_H = 8    # pixel rows per chunk (the subgroup gate's granularity)
_A_BASE = 20   # lanes of the folded edge constants a_0..a_2
_SG_BBOX = 24  # lanes of the subgroup bbox (rows 0 mod SUBGROUP)
_F_BASE = 32   # lanes of the bitcast setup floats
REC_LANES = _F_BASE + NF32  # 72 lanes in use of the reference's 128
BIG_Z = 2.0    # beyond any passing depth
# K10vec's work items a tile, read at call time (a sweep may set it).
VEC_ITEMS = 32
# K10vec's clear key: z 1.0 over row 0, which no row at z >= 1.0 goes
# below (the strict-less merge from 1.0).
KEY_CLEAR = 0x3F800000 << 32

_LATCHES = (("den", F_RW0), ("nr", F_CR0), ("ng", F_CG0), ("nb", F_CB0))
_GBUF_LATCHES = (("u", F_U0), ("v", F_V0), ("nx", F_NX0), ("ny", F_NY0),
                 ("nz", F_NZ0))
_CONSTS = tuple((name, F_MET + k) for k, name in enumerate(
    ("met", "rgh", "emr", "emg", "emb", "tex")))

I32, F32 = torch.int32, torch.float32


def prepare_vec_inputs(tri_i32, tri_f32):
    """(supers, blocks, rec) of the reference's ``prepare_vec_inputs``;
    rec is (T, REC_LANES) i32 (its lanes [0, REC_LANES))."""
    dev = tri_i32.device
    pad = (-tri_i32.shape[0]) % RASTER_BLOCK
    if pad:
        dead = torch.zeros((pad, NI32), dtype=I32, device=dev)
        dead[:, I_JMIN] = 1
        tri_i32 = torch.cat([tri_i32, dead])
        tri_f32 = torch.cat([tri_f32, torch.zeros((pad, NF32), dtype=F32,
                                                  device=dev)])
    t = tri_i32.shape[0]
    blocks, supers = tg.super_bounds(tg.block_bounds(tri_i32))

    def c(k):
        return tri_i32[:, k]

    ns = t // SUBGROUP
    valid = (c(I_VALID) > 0).view(ns, SUBGROUP)

    def seg(col, empty, red):
        return red(torch.where(valid, col.view(ns, SUBGROUP), empty), dim=1)

    rec = torch.zeros((t, REC_LANES), dtype=I32, device=dev)
    rec[:, :NI32] = tri_i32
    rec[:, _A_BASE] = c(I_DY0) * c(I_X1) - c(I_DX0) * c(I_Y1)
    rec[:, _A_BASE + 1] = c(I_DY1) * c(I_X2) - c(I_DX1) * c(I_Y2)
    rec[:, _A_BASE + 2] = c(I_DY2) * c(I_X0) - c(I_DX2) * c(I_Y0)
    rec[:, _F_BASE:] = tri_f32.contiguous().view(I32)
    imax = tr._INT_MAX
    rec[::SUBGROUP, _SG_BBOX] = seg(c(I_JMIN), imax, torch.amin)
    rec[::SUBGROUP, _SG_BBOX + 1] = seg(c(I_JMAX), -imax, torch.amax)
    rec[::SUBGROUP, _SG_BBOX + 2] = seg(c(I_IMIN), imax, torch.amin)
    rec[::SUBGROUP, _SG_BBOX + 3] = seg(c(I_IMAX), -imax, torch.amax)
    return supers, blocks, rec


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------


def _vec_planes(rec, width: int, height: int, gbuffer: bool):
    """Frame planes (one tile of the whole frame) after every subgroup, in
    order: its live records evaluated over the 8-row chunks and 128-column
    tiles its bbox meets (the rectangle the kernel's gates pass; the
    block and superblock skips drop no subgroup that meets a tile), the
    (z, row id) winner taken, then merged by strict less."""
    tr._check_frame(width, height)
    planes, py, px = tr._tile_planes(1, 1, False, rec.device, gbuffer,
                                     tile_h=height, tile_w=width)
    sg = rec[::SUBGROUP, _SG_BBOX:_SG_BBOX + 4].cpu()
    live_sg = (sg[:, 0] <= sg[:, 1]) & (sg[:, 2] <= sg[:, 3])
    rf = rec[:, _F_BASE:].contiguous().view(F32)
    for s in torch.nonzero(live_sg).flatten().tolist():
        sj0, sj1, si0, si1 = sg[s].tolist()
        c0 = max(sj0 // tr.TILE_W, 0) * tr.TILE_W
        c1 = (min(sj1 // tr.TILE_W, width // tr.TILE_W - 1) + 1) * tr.TILE_W
        r0 = max(si0 // CHUNK_H, 0) * CHUNK_H
        r1 = (min(si1 // CHUNK_H, height // CHUNK_H - 1) + 1) * CHUNK_H
        if c0 >= c1 or r0 >= r1:
            continue
        rows = slice(s * SUBGROUP, (s + 1) * SUBGROUP)
        ri, f = rec[rows], rf[rows]

        def ic(k):
            return ri[:, k, None, None]

        def fc(k):
            return f[:, k, None, None]

        pys = py[0, 0, r0:r1][None]       # (1, h, 1)
        pxs = px[0, 0, :, c0:c1][None]    # (1, 1, w)
        e = [(ic(_A_BASE + k) + ic(dx) * pys) - ic(dy) * pxs
             for k, (dx, dy) in enumerate(((I_DX0, I_DY0), (I_DX1, I_DY1),
                                           (I_DX2, I_DY2)))]
        cov = ((e[0] >= ic(I_BIAS0)) & (e[1] >= ic(I_BIAS1))
               & (e[2] >= ic(I_BIAS2)))
        alive = ((ic(I_JMIN) <= ic(I_JMAX)) & (ic(I_IMIN) <= ic(I_IMAX))
                 & (ic(I_VALID) > 0))
        ef = [x.to(F32) for x in e]

        def interp(k):
            return (ef[0] * fc(k) + ef[1] * fc(k + 1)) + ef[2] * fc(k + 2)

        z = interp(F_ZA0)
        zsel = torch.where(cov & alive & (z >= 0.0), z, BIG_Z)
        win = torch.argmin(zsel, dim=0, keepdim=True)  # first of equal z
        zw = zsel.gather(0, win)[0]
        zb = planes["z"][0, 0, r0:r1, c0:c1]
        upd = zw < zb
        zb.copy_(torch.where(upd, zw, zb))
        for name, k in _LATCHES + (_GBUF_LATCHES if gbuffer else ()):
            buf = planes[name][0, 0, r0:r1, c0:c1]
            buf.copy_(torch.where(upd, interp(k).gather(0, win)[0], buf))
        if gbuffer:
            for name, k in _CONSTS:
                buf = planes[name][0, 0, r0:r1, c0:c1]
                buf.copy_(torch.where(upd, f[:, k][win[0]], buf))
    return planes


def raster_vec_plain(supers, blocks, rec, width: int, height: int):
    """Plain torch K10vec: (packed i32, depth f32)."""
    del supers, blocks  # skip tables only
    return tr._resolve_planes(_vec_planes(rec, width, height, False))


def gbuffer_vec_plain(supers, blocks, rec, width: int, height: int):
    """Plain torch K10vecg: the 13 G-buffer planes, interpolants as
    where(covered, buf*inv, 0)."""
    del supers, blocks
    return tr._resolve_gbuffer(_vec_planes(rec, width, height, True),
                               masked_inv=False)


# ---------------------------------------------------------------------------
# K10vec's rules (csrc/raster_vec.cu), in torch
# ---------------------------------------------------------------------------


def hit_chunk_rows(rec, rows, tile_y, tile_x):
    """(lo, hi) int64 global rows of the 8-row chunks of tile (tile_y,
    tile_x) that the bbox of row ``rows``'s subgroup meets (``rec``: the
    prepare's records), hi < lo where its bbox misses the tile's columns or
    every chunk."""
    sg = rec[rows - rows % SUBGROUP, _SG_BBOX:_SG_BBOX + 4].to(torch.int64)
    sj0, sj1, si0, si1 = sg.unbind(1)
    r0, c0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    hit = ((sj1 >= c0) & (sj0 < c0 + tr.TILE_W) & (si1 >= r0)
           & (si0 < r0 + tr.TILE_H) & (sj0 <= sj1) & (si0 <= si1))
    lo = r0 + (si0 - r0).clamp(min=0) // CHUNK_H * CHUNK_H
    hi = r0 + ((si1 - r0).clamp(max=tr.TILE_H - 1) // CHUNK_H + 1) * CHUNK_H
    return lo, torch.where(hit, hi - 1, lo - 1)


def admitted_rows(block_hits, rec, width: int):
    """The (tile, row) pairs K10vec pends: (rows, tile y, tile x), int64.
    Each hit block's (``block_hits`` (tiles, B)) rows that are live
    (valid, with a non-empty bbox) in a subgroup with a hit chunk, with no
    per-row bbox test."""
    tx = width // tr.TILE_W
    tile, blk = torch.nonzero(block_hits, as_tuple=True)
    rows = (blk[:, None] * RASTER_BLOCK + torch.arange(
        RASTER_BLOCK, device=blk.device)).reshape(-1)
    tile = tile.repeat_interleave(RASTER_BLOCK)
    lo, hi = hit_chunk_rows(rec, rows, tile // tx, tile % tx)
    r = rec[rows]
    keep = ((hi >= lo) & (r[:, I_JMIN] <= r[:, I_JMAX])
            & (r[:, I_IMIN] <= r[:, I_IMAX]) & (r[:, I_VALID] > 0))
    tile = tile[keep]
    return rows[keep], tile // tx, tile % tx


def window_rects(rec, rows, tile_y, tile_x, chunks: bool = True):
    """The window of each (tile, row) pair: (P, 4) int64 [jmin, jmax, imin,
    imax], row ``rows``'s vertices' pixel bbox (``raster.vertex_bbox``) in
    tile (tile_y, tile_x), with ``chunks`` within its subgroup's hit chunks
    (``hit_chunk_rows``).  Empty where jmin > jmax or imin > imax."""
    jmin, jmax, imin, imax = tr.vertex_bbox(
        rec[rows, :NI32].to(torch.int64)).unbind(1)
    r0, c0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    lo, hi = r0, r0 + tr.TILE_H - 1
    if chunks:
        lo, hi = hit_chunk_rows(rec, rows, tile_y, tile_x)
    return torch.stack([torch.maximum(jmin, c0),
                        torch.minimum(jmax, c0 + tr.TILE_W - 1),
                        torch.maximum(imin, lo), torch.minimum(imax, hi)], 1)


def window_keys(keys, rec, rows, rects, tile_y, tile_x, width: int):
    """Scatter-min into ``keys`` (H * W int64, in place) the (z, row id)
    key of each (tile, row) pair's fragments inside its window
    ``rects``."""
    r = rec[rows, :NI32]
    za = rec[rows, _F_BASE + F_ZA0:_F_BASE + F_ZA0 + 3].contiguous().view(
        F32)
    y0, x0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    base, sy, sx = h2.edge_windows(r, y0, x0)
    h2.window_min(keys, width, y0, x0, tr.TILE_H, base, sy, sx,
                  r[:, I_BIAS0:I_BIAS0 + 3], za, rows, rows=rects[:, 2:],
                  cols=rects[:, :2], clear=KEY_CLEAR)


def key_planes(keys, rec, width: int, height: int, gbuffer: bool = False):
    """K10vec's store of a key plane: each pixel's winner (its key's row
    id; none under KEY_CLEAR) re-evaluated from its record and resolved
    -> (packed i32, depth f32); with ``gbuffer`` K10vecg's, the 13 planes
    under K3g's epilogue covered ? buf * inv : 0."""
    won = keys != KEY_CLEAR
    ids = torch.where(won, keys & 0xFFFFFFFF, 0)
    r = rec[ids]
    return h2.resolve(won, h2.pixel_edges(r[:, :NI32], width, height),
                      r[:, _F_BASE:].contiguous().view(F32), width, height,
                      masked_inv=False if gbuffer else None)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster_vec.cu)
# ---------------------------------------------------------------------------


def _vec_args(supers, blocks, rec, width: int, height: int):
    """Check the kernels' input contract; returns the launch arguments
    before the outputs."""
    tr._check_frame(width, height)
    dev = rec.device
    for name, t in (("supers", supers), ("blocks", blocks), ("rec", rec)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensor on {dev} expected, got "
                             f"{t.device}")
        if t.dtype != I32:
            raise TypeError(f"{name}: int32 expected, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor expected")
    t = rec.shape[0]
    if rec.ndim != 2 or rec.shape[1] != REC_LANES or t % RASTER_BLOCK:
        raise ValueError(f"rec: (T, {REC_LANES}), T a multiple of "
                         f"{RASTER_BLOCK}, expected")
    if (blocks.shape[1:] != (8,) or supers.shape[1:] != (8,)
            or blocks.shape[0] != supers.shape[0] * tg.SUPER_BLOCK
            or blocks.shape[0] * RASTER_BLOCK < t):
        raise ValueError("blocks/supers do not match the records")
    p = tr._ptr
    return p(supers), supers.shape[0], p(blocks), p(rec)


def _launch_keyed(entry, run, supers, blocks, rec, width: int,
                  height: int):
    """Launch K10vec or K10vecg (the C entry named ``entry``, through
    ``run``: ``raster._run`` or ``raster._run_gbuffer``) on the current
    stream in VEC_ITEMS work items a tile.  Its scratch: the hit words
    (tiles * (2 S + 1) ints) and, with more than one item, the key plane of
    the output's size."""
    args = _vec_args(supers, blocks, rec, width, height)
    items = VEC_ITEMS
    if items < 1:
        raise ValueError(f"VEC_ITEMS must be positive, got {items}")
    tiles = (height // tr.TILE_H) * (width // tr.TILE_W)
    buf = torch.empty(tiles * (2 * supers.shape[0] + 1), dtype=I32,
                      device=rec.device)
    plane = (torch.empty(height * width, dtype=torch.int64,
                         device=rec.device) if items > 1 else None)
    return run(getattr(_build.load_library(), entry), rec.device, width,
               height, *args, items, tr._ptr(buf),
               None if plane is None else tr._ptr(plane))


def raster_vec_kernel(supers, blocks, rec, width: int, height: int):
    """Launch K10vec (``csrc/raster_vec.cu``) -> (packed i32, depth
    f32)."""
    out = _launch_keyed("zr_raster_vec", tr._run, supers, blocks, rec,
                        width, height)
    raster_vec_kernel.launches += 1
    return out


def gbuffer_vec_kernel(supers, blocks, rec, width: int, height: int):
    """Launch K10vecg, K10vec's body with the G-buffer key: the 13
    G-buffer planes."""
    out = _launch_keyed("zr_gbuffer_vec", tr._run_gbuffer, supers, blocks,
                        rec, width, height)
    gbuffer_vec_kernel.launches += 1
    return out


KERNELS = (raster_vec_kernel, gbuffer_vec_kernel)
for _kernel in KERNELS:
    _kernel.launches = 0
del _kernel


def rasterize_setup_vec(tri_i32, tri_f32, width: int, height: int):
    """K10vec: the prepare, then the kernel (CUDA tensors) or its plain
    version (CPU tensors) -> (packed i32, depth f32)."""
    tr._check_frame(width, height)
    prepared = prepare_vec_inputs(tri_i32, tri_f32)
    if tr._on_cpu(tri_i32):
        return raster_vec_plain(*prepared, width, height)
    return raster_vec_kernel(*prepared, width, height)


def rasterize_gbuffer_vec(tri_i32, tri_f32, width: int, height: int):
    """K10vecg: the 13 planes of ``raster.rasterize_gbuffer_hbm``."""
    tr._check_frame(width, height)
    prepared = prepare_vec_inputs(tri_i32, tri_f32)
    if tr._on_cpu(tri_i32):
        return gbuffer_vec_plain(*prepared, width, height)
    return gbuffer_vec_kernel(*prepared, width, height)
