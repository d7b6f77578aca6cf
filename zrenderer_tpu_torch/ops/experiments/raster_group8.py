"""Group-tile binned raster (K10g8, K10g8g, K10g8d): prepare, the CUDA
kernels' wrappers and their plain torch versions.

Counterpart of ``zrenderer_tpu/ops/experiments/raster_group8.py``
(``rasterize_setup_pallas_group8``, ``rasterize_gbuffer_pallas_group8``,
``rasterize_depth_pallas_group8``):

* screen tiles are 8x128 pixels (GT_H x GT_W);
* ``prepare_group8_inputs`` lists every valid head row whose bbox spans at
  most ``pair_cap`` tiles once per tile it touches, within a static list
  budget of L rows, sorted by (tile, row id), and gathers each listed
  row's list row: the edge functions in the form e = (dx*py + c) - dy*px
  with c = dy*x_ref - dx*y_ref (int32, wrapping), the top-left bias bits,
  the row id and the float attributes bitcast to int32;
* phase 1 evaluates a tile's list span, phase 2 the rows left in the
  three-level (mega, super, block) hierarchy whose bbox meets the tile,
  gated per tile by ``tile_any``;
* the winner is the (z, row id) lexicographic minimum over both phases
  (depth-only: the strict-less z test in visit order); colour and
  depth as the production kernels, the G-buffer interpolants as
  ``buf * where(covered, inv, 0)`` (K2g/K4g/K5g's form).

The TPU kernel's 128-lane rows and packed leftover slabs exist only for
its DMAs: list rows here keep the ROW_LANES lanes in use, and phase 2
reads the leftover setup rows as they are.  The prepare treats a valid
head row whose bbox clamps to empty as dead (it covers no pixel centre):
the reference lists it, so its footprint can overrun the budget or key a
tile its bbox misses (ROADMAP Queue 3).  CUDA: ``csrc/raster_group8.cu``.
K10g8 runs the keyed body on 32x128 key tiles, four list tiles each: a key
tile's list entries (``list_pairs``) and its hit blocks of the leftover
hierarchy (``raster.hier_block_hits`` at the key tiles), whose rows it
admits by their bbox (``leftover_pairs``), are cut into G8_ITEMS work
items; each entry is evaluated over its vertices' pixel bbox in its own
list tile, each leftover row over its vertices' pixel bbox in the gated
list tiles its bbox meets (``window_rects``), into one key a pixel, (order
bits of z, row id) from (1.0, INT_MAX) (``raster_hbm2.KEY_CLEAR``); the
items merge through a key plane and the planes are resolved from the
winners' setup rows (``key_planes``).  K10g8g runs the same body with
K4g's G-buffer key and epilogue (``key_planes(..., gbuffer=True)``),
K10g8d with K4d's depth key, (order bits of z, visit index, sign of z)
from (1.0, 0): an entry's visit index is its index in its key tile's
spans laid end to end (``list_pairs``' rank), a leftover row's that key
tile's entries plus its row id, so that the strict-less test holds in
visit order within each list tile (span order, then row order) and the
store decodes z and its sign from the key.
"""

from __future__ import annotations

from typing import NamedTuple

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
    I_X0,
    I_X1,
    I_X2,
    I_Y0,
    I_Y1,
    I_Y2,
    NF32,
    NI32,
)

GT_H = 8    # group-tile height
GT_W = 128  # group-tile width
GROUP = 8   # the TPU kernel's triangles per vector step
CHUNK = 256  # list rows per TPU slab; here it only rounds the budget
PAIR_CAP = 4  # largest bbox footprint (tiles) of a listed row
LISTS = tr.TILE_H // GT_H  # list tiles a K10g8 key tile
# K10g8's, K10g8g's and K10g8d's work items a key tile, read at call time
# (a sweep may set it).
G8_ITEMS = 16

# List-row lanes (int32; float fields bitcast).  Edge k uses reference
# vertex (k + 1) mod 3, as the setup rows' edge functions do.
C_DX0, C_DY0, C_C0 = 0, 1, 2
C_DX1, C_DY1, C_C1 = 3, 4, 5
C_DX2, C_DY2, C_C2 = 6, 7, 8
C_BIAS = 9   # bit k: edge k's top-left bias
C_ID = 10    # row id in the setup rows
C_ZA = 11    # 3 lanes each from here
C_RW = 14
C_CR, C_CG, C_CB = 17, 20, 23
C_U, C_V = 26, 29
C_NX, C_NY, C_NZ = 32, 35, 38
C_MET, C_RGH, C_EMR, C_EMG, C_EMB, C_TEX = 41, 42, 43, 44, 45, 46
ROW_LANES = 47

# Plain-version latches: (tile-plane name, list-row lane).
_LATCHES = (("den", C_RW), ("nr", C_CR), ("ng", C_CG), ("nb", C_CB))
_GBUF_LATCHES = (("u", C_U), ("v", C_V), ("nx", C_NX), ("ny", C_NY),
                 ("nz", C_NZ))
_CONSTS = (("met", C_MET), ("rgh", C_RGH), ("emr", C_EMR), ("emg", C_EMG),
           ("emb", C_EMB), ("tex", C_TEX))

I32, F32 = torch.int32, torch.float32


class Group8Inputs(NamedTuple):
    offs: torch.Tensor      # (num_tiles + 1,) i32 list spans
    tile_any: torch.Tensor  # (num_tiles,) i32 phase-2 gate
    rows: torch.Tensor      # (L, ROW_LANES) i32 list rows in span order
    megas: torch.Tensor     # (M, 8) i32 level-2 bboxes of the leftovers
    supers: torch.Tensor    # (32 M, 8) i32 level-1 bboxes
    blocks: torch.Tensor    # (B, 8) i32 level-0 bboxes
    hier: torch.Tensor      # (R, NI32) i32 setup rows, listed rows emptied
    #                         and dead rows' valid flag cleared
    hier_f: torch.Tensor    # (R, NF32) f32 setup rows


def _check_frame(width: int, height: int):
    if width <= 0 or height <= 0 or width % GT_W or height % GT_H:
        raise ValueError(f"group8 target {width}x{height} must be a positive "
                         f"multiple of {GT_W}x{GT_H}")


def list_budget_for(n_head: int, chunk: int = CHUNK) -> int:
    """The reference's static list capacity: 1.5x the head rows, at least
    4096, rounded up to ``chunk``; overflow rows ride the hierarchy."""
    base = max((3 * n_head) // 2, 4096)
    return -(-base // chunk) * chunk


def _build_table(head_i32, head_f32):
    """(n_head, ROW_LANES) i32 list-row table of the head rows."""
    i = head_i32

    def edge_c(dx, dy, x, y):
        return i[:, dy] * i[:, x] - i[:, dx] * i[:, y]

    n = i.shape[0]
    cols_i = torch.stack([
        i[:, I_DX0], i[:, I_DY0], edge_c(I_DX0, I_DY0, I_X1, I_Y1),
        i[:, I_DX1], i[:, I_DY1], edge_c(I_DX1, I_DY1, I_X2, I_Y2),
        i[:, I_DX2], i[:, I_DY2], edge_c(I_DX2, I_DY2, I_X0, I_Y0),
        (i[:, I_BIAS0] & 1) | ((i[:, I_BIAS1] & 1) << 1)
        | ((i[:, I_BIAS2] & 1) << 2),
        torch.arange(n, dtype=I32, device=i.device),
    ], dim=1)
    f = head_f32
    cols_f = torch.cat([f[:, c:c + 3] for c in (
        F_ZA0, F_RW0, F_CR0, F_CG0, F_CB0, F_U0, F_V0, F_NX0, F_NY0, F_NZ0)]
        + [f[:, F_MET:F_MET + 6]], dim=1)
    return torch.cat([cols_i, cols_f.contiguous().view(I32)], dim=1)


def prepare_group8_inputs(tri_i32, tri_f32, width: int, height: int,
                          pair_cap: int = PAIR_CAP,
                          list_budget: int | None = None,
                          chunk: int = CHUNK) -> Group8Inputs:
    """Tile lists, list rows and the leftover hierarchy on the rows'
    device (the reference's ``prepare_group8_inputs``).

    The reference sorts u32 keys (tile << id_bits) | id; one int64 sort of
    (tile, pair) values gives the same order (``raster.pair_value_sort``).
    List slots past the spans hold the rows the reference's sentinel keys
    gather (row n_head - 1, then row 0 past the pairs).

    ``chunk`` is the reference's DMA slab of list rows; here it only
    rounds the list budget L up to a multiple of it (the CUDA kernel
    stages its own 64 rows at a time)."""
    _check_frame(width, height)
    tiles_x, tiles_y = width // GT_W, height // GT_H
    num_tiles = tiles_x * tiles_y
    id_bits = 32 - max(num_tiles.bit_length(), 1)
    dev = tri_i32.device
    n_head = tg.head_count(tri_i32.shape[0])
    head = tri_i32[:n_head]
    if list_budget is None:
        list_budget = list_budget_for(n_head, chunk)
    L = -(-list_budget // chunk) * chunk

    # A valid head row whose bbox clamps to empty covers no pixel centre.
    # The reference lists it, which can overrun the budget or key a tile
    # its bbox misses (ROADMAP Queue 3); here it is dead: unlisted, and
    # its valid flag is cleared in the leftover rows.
    empty = ((head[:, tg.I_VALID] > 0)
             & ((head[:, I_JMIN] > head[:, I_JMAX])
                | (head[:, I_IMIN] > head[:, I_IMAX])))
    tri_i32 = tri_i32.clone()
    tri_i32[:n_head, tg.I_VALID] = torch.where(empty, 0, head[:, tg.I_VALID])
    head = tri_i32[:n_head]

    if n_head >= (1 << id_bits):
        # Past the reference's key-packing envelope every row rides the
        # hierarchy; the lists are empty.
        listed = torch.zeros(n_head, dtype=torch.bool, device=dev)
        offs = torch.zeros(num_tiles + 1, dtype=I32, device=dev)
        ids = torch.zeros(L, dtype=torch.int64, device=dev)
    else:
        tj0, tj1 = head[:, I_JMIN] // GT_W, head[:, I_JMAX] // GT_W
        ty0, ty1 = head[:, I_IMIN] // GT_H, head[:, I_IMAX] // GT_H
        ntx = tj1 - tj0 + 1
        foot = ntx * (ty1 - ty0 + 1)
        listed = (head[:, tg.I_VALID] > 0) & (foot <= pair_cap)
        used = torch.cumsum(torch.where(listed, foot, 0), dim=0)
        listed = listed & (used <= L)
        keys = tr._pair_keys(listed, foot, ntx, ty0, tj0, pair_cap, tiles_x,
                             num_tiles)
        sorted_tri, offs = tr.pair_value_sort(keys, pair_cap, num_tiles)
        n_pairs = sorted_tri.shape[0]
        slot = torch.arange(min(L, n_pairs), device=dev)
        ids = torch.where(slot < offs[-1], sorted_tri[:slot.shape[0]],
                          n_head - 1).long()
        if n_pairs < L:
            ids = torch.cat([ids, ids.new_zeros(L - n_pairs)])
    rows = _build_table(head, tri_f32[:n_head])[ids]

    tri_i32, hier_f = tr._pad_rows(tri_i32, tri_f32)
    supers, blocks, hier = tr._leftover_rows(tri_i32, listed)
    supers, megas = tg.super_bounds(supers)

    # Phase-2 gate: does any superblock's bbox meet the tile?
    col0 = (torch.arange(num_tiles, device=dev) % tiles_x * GT_W)[:, None]
    row0 = (torch.arange(num_tiles, device=dev) // tiles_x * GT_H)[:, None]
    sj0, sj1, si0, si1 = (supers[None, :, k] for k in range(4))
    tile_any = ((sj1 >= col0) & (sj0 < col0 + GT_W) & (si1 >= row0)
                & (si0 < row0 + GT_H) & (sj0 <= sj1)
                & (si0 <= si1)).any(dim=1).to(I32)
    return Group8Inputs(offs, tile_any, rows, megas, supers, blocks, hier,
                        hier_f)


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------


def _eval_list_rows(planes, py, px, rows, active, tie: bool):
    """Phase 1 at one span position of every tile: ``rows`` (ty, tx,
    ROW_LANES) list rows, ``active`` (ty, tx) inside the span.  The
    (z, row id) test with ``tie``, else the strict-less z test."""
    rf = rows.view(F32)

    def ic(c):
        return rows[..., c, None, None]

    def fc(c):
        return rf[..., c, None, None]

    bias = ic(C_BIAS)
    e0 = (ic(C_DX0) * py + ic(C_C0)) - ic(C_DY0) * px
    e1 = (ic(C_DX1) * py + ic(C_C1)) - ic(C_DY1) * px
    e2 = (ic(C_DX2) * py + ic(C_C2)) - ic(C_DY2) * px
    cov = (e0 >= (bias & 1)) & (e1 >= ((bias >> 1) & 1)) & (
        e2 >= ((bias >> 2) & 1))
    ef0, ef1, ef2 = e0.to(F32), e1.to(F32), e2.to(F32)

    def interp(c):
        return (ef0 * fc(c) + ef1 * fc(c + 1)) + ef2 * fc(c + 2)

    z = interp(C_ZA)
    zb = planes["z"]
    ok = cov & (z >= 0.0) & active[..., None, None]
    if tie:
        tid, tb = ic(C_ID), planes["tid"]
        ok = ok & ((z < zb) | ((z == zb) & (tid < tb)))
        planes["tid"] = torch.where(ok, tid, tb)
    else:
        ok = ok & (z < zb)
    planes["z"] = torch.where(ok, z, zb)
    for name, c in _LATCHES + _GBUF_LATCHES:
        if name in planes:
            planes[name] = torch.where(ok, interp(c), planes[name])
    for name, c in _CONSTS:
        if name in planes:
            planes[name] = torch.where(ok, fc(c), planes[name])


def _group8_planes(offs, rows, hier, hier_f, width: int, height: int,
                   gbuffer: bool, depth: bool):
    """Both phases over 8x128 tile planes: each tile's span stepped over
    all tiles at once, then the leftover rows over the tiles their bbox
    touches (the hierarchy's skips and ``tile_any`` drop no row that
    meets a tile)."""
    _check_frame(width, height)
    tiles_y, tiles_x = height // GT_H, width // GT_W
    tie = not depth
    planes, py, px = tr._tile_planes(tiles_y, tiles_x, tie, hier.device,
                                     gbuffer, depth, tile_h=GT_H,
                                     tile_w=GT_W)
    start = offs[:-1].long().view(tiles_y, tiles_x)
    count = (offs[1:] - offs[:-1]).long().view(tiles_y, tiles_x)
    for k in range(int(count.max().item())):
        active = count > k
        idx = torch.where(active, start + k, 0)
        _eval_list_rows(planes, py, px, rows[idx], active, tie)
    tr._scan_rows(planes, py, px, hier, hier_f, tie=tie)
    return planes


def raster_group8_plain(offs, tile_any, rows, megas, supers, blocks, hier,
                        hier_f, width: int, height: int):
    """Plain torch K10g8: (packed i32, depth f32)."""
    del tile_any, megas, supers, blocks  # gate and skip tables only
    return tr._resolve_planes(_group8_planes(offs, rows, hier, hier_f, width,
                                             height, False, False))


def gbuffer_group8_plain(offs, tile_any, rows, megas, supers, blocks, hier,
                         hier_f, width: int, height: int):
    """Plain torch K10g8g: the 13 G-buffer planes, interpolants as
    buf * where(covered, inv, 0)."""
    del tile_any, megas, supers, blocks
    return tr._resolve_gbuffer(_group8_planes(offs, rows, hier, hier_f,
                                              width, height, True, False),
                               masked_inv=True)


def depth_group8_plain(offs, tile_any, rows, megas, supers, blocks, hier,
                       hier_f, width: int, height: int):
    """Plain torch K10g8d: the f32 depth plane, strict-less in span order,
    then the leftovers in row order."""
    del tile_any, megas, supers, blocks
    return tr._frame(_group8_planes(offs, rows, hier, hier_f, width, height,
                                    False, True)["z"])


# ---------------------------------------------------------------------------
# K10g8's rules (csrc/raster_group8.cu), in torch
# ---------------------------------------------------------------------------


def key_height(height: int) -> int:
    """K10g8's planes' rows: the target's height rounded up to TILE_H."""
    return -(-height // tr.TILE_H) * tr.TILE_H


def list_pairs(inp: Group8Inputs, width: int, height: int):
    """K10g8's list entries: (rows, list tile y, tile x, index of the entry
    in its key tile's spans laid end to end, that key tile's entries),
    int64, in span order."""
    offs = inp.offs.to(torch.int64)
    n = offs[1:] - offs[:-1]
    dev = n.device
    lt = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    rows = inp.rows[:int(offs[-1]), C_ID].to(torch.int64)
    tiles_x = width // GT_W
    ly, tx = lt // tiles_x, lt % tiles_x
    key = ly // LISTS * tiles_x + tx
    count = torch.zeros(key_height(height) // tr.TILE_H * tiles_x,
                        dtype=torch.int64, device=dev)
    count.index_add_(0, key, torch.ones_like(key))
    # The spans in list-tile order; a key tile's lie tiles_x apart, top
    # to bottom: a stable sort by key tile ranks its entries.
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    first = torch.cumsum(count, 0) - count
    rank[order] = (torch.arange(order.numel(), device=dev)
                   - first[key[order]])
    return rows, ly, tx, rank, count[key]


def leftover_pairs(inp: Group8Inputs, width: int, height: int):
    """K10g8's hit blocks and leftover rows: (block hits (key tiles, B)
    bool, rows, key tile y, tile x) int64, each hit block's rows whose
    bbox meets the key tile."""
    tiles_x = width // GT_W
    hits = tr.hier_block_hits(
        inp.supers[:inp.blocks.shape[0] // tg.SUPER_BLOCK], inp.blocks,
        width, key_height(height))
    tile, blk = torch.nonzero(hits, as_tuple=True)
    rows = (blk[:, None] * tg.RASTER_BLOCK + torch.arange(
        tg.RASTER_BLOCK, device=blk.device)).reshape(-1)
    tile = tile.repeat_interleave(tg.RASTER_BLOCK)
    ty, tx = tile // tiles_x, tile % tiles_x
    b = inp.hier[rows].to(torch.int64)
    r0, c0 = ty * tr.TILE_H, tx * tr.TILE_W
    keep = ((b[:, I_JMAX] >= c0) & (b[:, I_JMIN] < c0 + tr.TILE_W)
            & (b[:, I_IMAX] >= r0) & (b[:, I_IMIN] < r0 + tr.TILE_H)
            & (b[:, I_JMIN] <= b[:, I_JMAX]) & (b[:, I_IMIN] <= b[:, I_IMAX]))
    return hits, rows[keep], ty[keep], tx[keep]


def window_rects(inp: Group8Inputs, rows, tile_y, tile_x, width: int,
                 height: int, list_y=None):
    """The window of each K10g8 pair in key tile (tile_y, tile_x): (P, 4)
    int64 [jmin, jmax, imin, imax], the vertices' pixel bbox
    (``raster.vertex_bbox``) of setup row ``rows`` in the key tile's
    columns, in rows: a list entry's (``list_y``: its list tile row) its
    list tile's; a leftover row's (``list_y`` None) the list tiles its bbox
    meets in the key tile, from the first to the last whose ``tile_any``
    is set.  Empty where jmin > jmax or imin > imax."""
    b = inp.hier[rows].to(torch.int64)
    jmin, jmax, imin, imax = tr.vertex_bbox(b).unbind(1)
    r0, c0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    if list_y is not None:
        lo, hi = list_y * GT_H, list_y * GT_H + GT_H - 1
    else:
        tiles_x, tiles8_y = width // GT_W, height // GT_H
        k0 = (torch.maximum(b[:, I_IMIN], r0) - r0) // GT_H
        k1 = (torch.minimum(b[:, I_IMAX], r0 + tr.TILE_H - 1) - r0) // GT_H
        k = torch.arange(LISTS, device=rows.device)
        ly = tile_y[:, None] * LISTS + k
        live = ly < tiles8_y
        gate = live & (inp.tile_any.to(torch.int64)[
            torch.where(live, ly * tiles_x + tile_x[:, None], 0)] > 0)
        met = gate & (k >= k0[:, None]) & (k <= k1[:, None])
        first = torch.where(met, k, LISTS).amin(1)
        last = torch.where(met, k, -1).amax(1)
        lo, hi = r0 + first * GT_H, r0 + last * GT_H + GT_H - 1
    return torch.stack([torch.maximum(jmin, c0),
                        torch.minimum(jmax, c0 + tr.TILE_W - 1),
                        torch.maximum(imin, lo), torch.minimum(imax, hi)], 1)


def window_keys(keys, inp: Group8Inputs, rows, rects, tile_y, tile_x,
                width: int):
    """Scatter-min into ``keys`` (key_height * W int64, in place) the (z,
    row id) key of each pair's fragments inside its window ``rects``."""
    r = inp.hier[rows]
    y0, x0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    base, sy, sx = h2.edge_windows(r, y0, x0)
    h2.window_min(keys, width, y0, x0, tr.TILE_H, base, sy, sx,
                  r[:, I_BIAS0:I_BIAS0 + 3],
                  inp.hier_f[rows, F_ZA0:F_ZA0 + 3], rows,
                  rows=rects[:, 2:], cols=rects[:, :2])


def key_planes(keys, inp: Group8Inputs, width: int, height: int,
               gbuffer: bool = False):
    """K10g8's store of a key plane of key_height rows: each pixel's winner
    re-evaluated from the setup rows and resolved -> (packed i32, depth
    f32) of the target's rows; with ``gbuffer`` K10g8g's, the 13 planes
    under the epilogue buf * (covered ? inv : 0)."""
    won, ids = h2.winners(keys)
    kh = key_height(height)
    out = h2.resolve(won, h2.pixel_edges(inp.hier[ids], width, kh),
                     inp.hier_f[ids], width, kh,
                     masked_inv=True if gbuffer else None)
    return [x[:height] for x in out]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster_group8.cu)
# ---------------------------------------------------------------------------

_DTYPES = {"offs": I32, "tile_any": I32, "rows": I32, "megas": I32,
           "supers": I32, "blocks": I32, "hier": I32, "hier_f": F32}


def _group8_args(inp: Group8Inputs, width: int, height: int):
    """Check the kernels' input contract; returns the launch arguments
    before the outputs."""
    _check_frame(width, height)
    dev = inp.hier.device
    for name, t in inp._asdict().items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensor on {dev} expected, got "
                             f"{t.device}")
        if t.dtype != _DTYPES[name]:
            raise TypeError(f"{name}: {_DTYPES[name]} expected, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor expected")
    num_tiles = (width // GT_W) * (height // GT_H)
    if (tuple(inp.offs.shape) != (num_tiles + 1,)
            or tuple(inp.tile_any.shape) != (num_tiles,)):
        raise ValueError("offs/tile_any do not match the group-tile grid")
    if inp.rows.ndim != 2 or inp.rows.shape[1] != ROW_LANES:
        raise ValueError(f"rows: (L, {ROW_LANES}) expected")
    r = inp.hier.shape[0]
    if (tuple(inp.hier.shape) != (r, NI32)
            or tuple(inp.hier_f.shape) != (r, NF32)
            or r % tg.RASTER_BLOCK):
        raise ValueError("hier/hier_f: (R, NI32)/(R, NF32), R a multiple of "
                         f"{tg.RASTER_BLOCK}, expected")
    m, s, b = (x.shape for x in (inp.megas, inp.supers, inp.blocks))
    if (m[1:] != (8,) or s[1:] != (8,) or b[1:] != (8,)
            or s[0] != m[0] * tg.SUPER_BLOCK or b[0] % tg.SUPER_BLOCK
            or b[0] * tg.RASTER_BLOCK < r):
        raise ValueError("megas/supers/blocks do not match the setup rows")
    p = tr._ptr
    return (p(inp.offs), p(inp.tile_any), p(inp.rows), p(inp.megas),
            m[0], p(inp.supers), p(inp.blocks), p(inp.hier), p(inp.hier_f))


def _launch_keyed(entry, run, inp: Group8Inputs, width: int, height: int):
    """Launch K10g8, K10g8g or K10g8d (the C entry named ``entry``, through
    ``run``: ``raster._run``, ``raster._run_gbuffer`` or a one-plane
    ``raster._run_depth``) on the current
    stream in G8_ITEMS work items a key tile.  Its scratch: the hit words
    (key tiles * (2 S + 1) ints, S the superblocks that hold blocks) and,
    with more than one item, the key plane; its planes hold key_height
    rows, the target's returned."""
    _group8_args(inp, width, height)
    items = G8_ITEMS
    if items < 1:
        raise ValueError(f"G8_ITEMS must be positive, got {items}")
    kh = key_height(height)
    dev = inp.hier.device
    num_supers = inp.blocks.shape[0] // tg.SUPER_BLOCK
    tiles = (kh // tr.TILE_H) * (width // tr.TILE_W)
    buf = torch.empty(tiles * (2 * num_supers + 1), dtype=I32, device=dev)
    plane = (torch.empty(kh * width, dtype=torch.int64, device=dev)
             if items > 1 else None)
    p = tr._ptr
    out = run(getattr(_build.load_library(), entry), dev, width, kh,
              p(inp.offs), p(inp.tile_any), p(inp.rows), height // GT_H,
              p(inp.supers), num_supers, p(inp.blocks), p(inp.hier),
              p(inp.hier_f), items, p(buf),
              None if plane is None else p(plane))
    return [x[:height] for x in out]


def raster_group8_kernel(offs, tile_any, rows, megas, supers, blocks,
                         hier, hier_f, width: int, height: int):
    """Launch K10g8 (``csrc/raster_group8.cu``) -> (packed i32, depth
    f32)."""
    color, depth = _launch_keyed(
        "zr_raster_group8", tr._run,
        Group8Inputs(offs, tile_any, rows, megas, supers, blocks, hier,
                     hier_f), width, height)
    raster_group8_kernel.launches += 1
    return color, depth


def gbuffer_group8_kernel(offs, tile_any, rows, megas, supers, blocks,
                          hier, hier_f, width: int, height: int):
    """Launch K10g8g, K10g8's body with the G-buffer key: the 13 G-buffer
    planes."""
    out = _launch_keyed(
        "zr_gbuffer_group8", tr._run_gbuffer,
        Group8Inputs(offs, tile_any, rows, megas, supers, blocks, hier,
                     hier_f), width, height)
    gbuffer_group8_kernel.launches += 1
    return out


def depth_group8_kernel(offs, tile_any, rows, megas, supers, blocks,
                        hier, hier_f, width: int, height: int):
    """Launch K10g8d, K10g8's body with K4d's depth key (visit order): the
    f32 depth plane."""
    (depth,) = _launch_keyed(
        "zr_depth_group8", lambda *a: (tr._run_depth(*a),),
        Group8Inputs(offs, tile_any, rows, megas, supers, blocks, hier,
                     hier_f), width, height)
    depth_group8_kernel.launches += 1
    return depth


KERNELS = (raster_group8_kernel, gbuffer_group8_kernel, depth_group8_kernel)
for _kernel in KERNELS:
    _kernel.launches = 0
del _kernel


def _run_mode(kernel, plain, tri_i32, tri_f32, width, height, pair_cap,
              list_budget, chunk):
    _check_frame(width, height)
    inp = prepare_group8_inputs(tri_i32, tri_f32, width, height,
                                pair_cap=pair_cap, list_budget=list_budget,
                                chunk=chunk)
    if tr._on_cpu(tri_i32):
        return plain(*inp, width, height)
    return kernel(*inp, width, height)


def rasterize_setup_group8(tri_i32, tri_f32, width: int, height: int,
                           pair_cap: int = PAIR_CAP,
                           list_budget: int | None = None,
                           chunk: int = CHUNK):
    """K10g8: the prepare, then the kernel (CUDA tensors) or its plain
    version (CPU tensors) -> (packed i32, depth f32)."""
    return _run_mode(raster_group8_kernel, raster_group8_plain, tri_i32,
                     tri_f32, width, height, pair_cap, list_budget, chunk)


def rasterize_gbuffer_group8(tri_i32, tri_f32, width: int, height: int,
                             pair_cap: int = PAIR_CAP,
                             list_budget: int | None = None,
                             chunk: int = CHUNK):
    """K10g8g: the 13 planes of ``raster.rasterize_gbuffer``."""
    return _run_mode(gbuffer_group8_kernel, gbuffer_group8_plain, tri_i32,
                     tri_f32, width, height, pair_cap, list_budget, chunk)


def rasterize_depth_group8(tri_i32, tri_f32, width: int, height: int,
                           pair_cap: int = PAIR_CAP,
                           list_budget: int | None = None,
                           chunk: int = CHUNK):
    """K10g8d: the shadow-map depth plane."""
    return _run_mode(depth_group8_kernel, depth_group8_plain, tri_i32,
                     tri_f32, width, height, pair_cap, list_budget, chunk)
