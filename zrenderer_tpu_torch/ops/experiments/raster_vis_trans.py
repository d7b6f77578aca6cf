"""Visibility-buffer and transposed-group raster (K10vis, K10trans): the
prepares, the exact colour resolve, the CUDA kernels' wrappers and their
plain torch versions.

Counterpart of ``zrenderer_tpu/ops/experiments/raster_vis_trans.py``
(``rasterize_setup_pallas_vis``, ``rasterize_setup_pallas_trans``).  Both
kernels write a visibility buffer, the f32 depth and the i32 winning row
id (-1 where no row passed) over the padded frame, and
``resolve_flat_vis`` recomputes the winner's colour from its edge ints
and colour coefficients with the production kernels' arithmetic:

* K10vis: ``prepare_group_bits`` marks, per 32x128 tile, the 8-row groups
  whose union bbox (over their rows with a non-empty bbox) meets the tile.
  The kernel walks the superblocks whose bbox meets the tile, then each of
  their blocks whose 16 group bits are not all clear, then runs every
  set bit's 8 rows in order over the whole tile, with no per-row bbox
  test, under the strict-less test ``z >= 0 && z < zb``.
* K10trans: ``prepare_trans_inputs`` keeps the union bbox of each 8-row
  group.  The kernel walks the superblocks and blocks whose bbox meets the
  tile, then each group whose bbox does; it evaluates the group's tile
  rows in TRANS_R-row chunks from its first row (a chunk past the tile's
  end starts at ``TILE_H - TRANS_R``), takes the group's winner at each
  pixel (covered rows with z >= 0, the others parked at BIG_Z; exact ties
  to the lower row id) and merges it into the tile by strict less.

Rows that no evaluation reaches cannot change a visible pixel: a dead row
carries bias INT32_MAX and covers nothing, and a row whose bbox clamps to
empty lies wholly outside the geometry's frame.  So the visible rows equal
K5's frame bit for bit.  The padding rows below the geometry's frame
follow each kernel's own evaluation extent, which the plain versions
follow too: K10vis runs every row of a hit group over the whole tile (so
rows clamped empty below the frame draw there), K10trans only the group's
row span, rounded up to whole chunks.

The reference pads for the TPU only: bitmap words to a multiple of 1024,
tiles to a multiple of 8, 128-lane trans records and a 32-lane resolve
table.  Here the bitmap has ceil(G/32) words a tile, one row a tile; a
trans record holds the 20 setup ints and the 3 bitcast z-plane floats;
the table the 24 lanes the resolve reads.  The reference's
``_hbm_vis_kernel`` is passed to no ``pallas_call`` (dead code) and has
no counterpart.

CUDA: ``csrc/raster_vis.cu``, on K5's keyed hierarchy body.  Each tile's
hit blocks (K10vis: ``vis_block_hits``, from the bitmap; K10trans: K5's,
``raster.hier_block_hits``) are cut into VIS_ITEMS work items; an item
pends the rows of each hit block that its kernel admits (``admitted_rows``:
every row of a group whose bit is set, or whose bbox meets the tile) and
evaluates each over its window (``window_rects``: the row's vertices'
pixel bbox in the tile, K10trans's within its group's chunk rows) into
one key a pixel, (order bits of z, row id, sign of z) (``vis_key``), whose
minimum is both kernels' strict-less result; the items merge through a key
plane, and the depth and id planes are decoded from it
(``key_planes``).
"""

from __future__ import annotations

import ctypes

import torch

from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as h2
from zrenderer_tpu_torch.ops.geometry import (
    F_CB0,
    F_CG0,
    F_CR0,
    F_RW0,
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
    RASTER_BLOCK,
    SUBPIXEL,
    SUPER_BLOCK,
)

GROUP = 8         # rows per hit bit (K10vis)
TRANS_GROUP = 8   # rows per transposed group (K10trans)
TRANS_R = 4       # tile rows per chunk of a group's row span
TRANS_ZA = NI32   # lanes of the bitcast z-plane coefficients in a record
REC_LANES = 24    # 20 setup ints, 3 z-plane floats, one zero lane
BIG_Z = 2.0       # a group row that does not pass; beyond any tile depth
NO_ROW = -1       # id plane where no row passed
# The reference's selection thresholds (its API); nothing selects by them.
VIS_BUFFER_MIN_TRIS = 131072
TRANS_MIN_TRIS = 1 << 62
# K10vis and K10trans on the card: each tile's hit blocks are cut into this
# many work items, one CUDA block each, merged through the output's key
# plane (csrc/raster_vis.cu); one item a tile resolves in place.  The
# wrappers read it at call time.  On the H100 at lattice1M, 1/4/8/16/32
# items took 1.66/0.60/0.48/0.44/0.43 ms a call (K10vis) and
# 1.62/0.62/0.49/0.45/0.46 (K10trans; PERF.md §6): 16 and 32 tie in sum.
VIS_ITEMS = 16
# The key of a pixel no row lowered: z 1.0 over row id 0 and sign 0.
KEY_CLEAR = 0x3F800000 << 32

# Resolve table lanes: the 12 edge ints (dx, dy, x, y of each edge), then
# the 1/w and colour coefficients bitcast to int32.
_TABLE_INTS = (I_DX0, I_DY0, I_X1, I_Y1, I_DX1, I_DY1, I_X2, I_Y2,
               I_DX2, I_DY2, I_X0, I_Y0)
_TABLE_FLOATS = tuple(c + k for c in (F_RW0, F_CR0, F_CG0, F_CB0)
                      for k in range(3))
TABLE_LANES = len(_TABLE_INTS) + len(_TABLE_FLOATS)  # 24

I32, F32 = torch.int32, torch.float32
_BIG_BBOX = 1 << 29  # the reference's neutral bound of an empty group


def _group_bounds(tri_i32, group: int):
    """(G, 4) union bbox [jmin, jmax, imin, imax] of each ``group`` rows'
    rows with a non-empty bbox; a group without one gets the inverted
    bounds (2^29, -2^29)."""
    ng = tri_i32.shape[0] // group

    def col(c):
        return tri_i32[:, c].reshape(ng, group)

    live = (col(I_JMIN) <= col(I_JMAX)) & (col(I_IMIN) <= col(I_IMAX))
    return torch.stack([
        torch.where(live, col(I_JMIN), _BIG_BBOX).amin(dim=1),
        torch.where(live, col(I_JMAX), -_BIG_BBOX).amax(dim=1),
        torch.where(live, col(I_IMIN), _BIG_BBOX).amin(dim=1),
        torch.where(live, col(I_IMAX), -_BIG_BBOX).amax(dim=1),
    ], dim=1).to(I32)


def prepare_group_bits(tri_i32, width: int, height: int):
    """(tiles, ceil(G/32)) i32 hit bitmap, G = rows / GROUP: bit g of word
    w of tile t's row is set when group 32*w + g's union bbox meets tile t
    (tiles in row-major order).  Block b reads the 16 bits of its groups
    as ``(word[b // 2] >> 16 * (b % 2)) & 0xFFFF``."""
    t = tri_i32.shape[0]
    if t % RASTER_BLOCK:
        raise ValueError(f"{t} rows: pad to a multiple of {RASTER_BLOCK}")
    tr._check_frame(width, height)
    dev = tri_i32.device
    ty, tx = height // tr.TILE_H, width // tr.TILE_W
    gb = _group_bounds(tri_i32, GROUP)
    rows = torch.arange(ty, dtype=I32, device=dev)[:, None, None]
    cols = torch.arange(tx, dtype=I32, device=dev)[None, :, None]
    ghit = ((rows >= gb[:, 2] // tr.TILE_H) & (rows <= gb[:, 3] // tr.TILE_H)
            & (cols >= gb[:, 0] // tr.TILE_W)
            & (cols <= gb[:, 1] // tr.TILE_W))  # (ty, tx, G)
    nwords = -(-gb.shape[0] // 32)
    ghit = torch.nn.functional.pad(ghit, (0, nwords * 32 - gb.shape[0]))
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (ghit.reshape(ty * tx, nwords, 32).to(torch.int64)
             << shifts).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(I32)


def vis_resolve_table(tri_i32, tri_f32):
    """(T, TABLE_LANES) i32 resolve rows: the 12 edge ints, then the 12
    1/w and colour coefficients bitcast to int32 (the reference's
    ``_vis_resolve_table`` lanes [0, 24); its other 8 are zero)."""
    return torch.cat([
        tri_i32[:, list(_TABLE_INTS)],
        tri_f32[:, list(_TABLE_FLOATS)].contiguous().view(I32),
    ], dim=1)


def resolve_flat_vis(depth, idx, table):
    """Packed RGBA8 (i32 bits) of the visibility buffer: the winning row's
    edge functions at each pixel centre (int32, wrapping), its 1/w and
    colour interpolated ((e0*c0 + e1*c1) + e2*c2, rounded after each op),
    one divide a pixel and the spec's u8 rounding, alpha 255: the bits of
    the single-pass kernels' colour.  ``depth`` is part of the reference's
    signature; the colour reads only ``idx``."""
    del depth
    h, w = idx.shape
    dev = idx.device
    rows = table[idx.clamp(min=0).reshape(-1).long()].reshape(h, w,
                                                             TABLE_LANES)
    ints = rows[..., :12]
    flts = rows[..., 12:].contiguous().view(F32)
    half = SUBPIXEL // 2
    py = torch.arange(h, dtype=I32, device=dev)[:, None] * SUBPIXEL + half
    px = torch.arange(w, dtype=I32, device=dev)[None, :] * SUBPIXEL + half
    ef = [(ints[..., 4 * k] * (py - ints[..., 4 * k + 3])
           - ints[..., 4 * k + 1] * (px - ints[..., 4 * k + 2])).to(F32)
          for k in range(3)]

    def interp(c):
        return (ef[0] * flts[..., c] + ef[1] * flts[..., c + 1]) \
            + ef[2] * flts[..., c + 2]

    den = interp(0)
    covered = (idx >= 0) & (den > 0)
    inv = torch.reciprocal(torch.where(covered, den, 1.0))

    def chan(k):
        c = torch.clamp(torch.where(covered, interp(3 + 3 * k) * inv, 0.0),
                        0.0, 1.0)
        return torch.floor(c * 255.0 + 0.5).to(I32)

    return chan(0) | (chan(1) << 8) | (chan(2) << 16) | tr._ALPHA_BITS


# ---------------------------------------------------------------------------
# Prepares
# ---------------------------------------------------------------------------


def prepare_vis_inputs(tri_i32, tri_f32, width: int, height: int):
    """K10vis prepare: ``raster.prepare_raster_inputs`` (padded, live rows
    compacted to the front), the hit bitmap and the resolve table.
    Returns (supers, bits, ti, tf, table); the block table is not needed
    (the block skip reads the bitmap)."""
    supers, _, ti, tf = tr.prepare_raster_inputs(tri_i32, tri_f32)
    return (supers, prepare_group_bits(ti, width, height), ti, tf,
            vis_resolve_table(ti, tf))


def prepare_trans_inputs(tri_i32, tri_f32):
    """K10trans prepare: (supers, blocks, rec (T, REC_LANES) i32, gbounds
    (T / TRANS_GROUP, 4) i32, table), over ``prepare_raster_inputs``' rows.
    A record holds the setup ints in lanes [0, 20) and the z-plane
    coefficients F_ZA0..2 bitcast in lanes [TRANS_ZA, TRANS_ZA + 3)."""
    supers, blocks, ti, tf = tr.prepare_raster_inputs(tri_i32, tri_f32)
    rec = torch.zeros((ti.shape[0], REC_LANES), dtype=I32, device=ti.device)
    rec[:, :NI32] = ti
    rec[:, TRANS_ZA:TRANS_ZA + 3] = tf[:, F_ZA0:F_ZA0 + 3].contiguous().view(
        I32)
    return (supers, blocks, rec, _group_bounds(ti, TRANS_GROUP),
            vis_resolve_table(ti, tf))


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------


def _visit_lists(hit):
    """Per tile, the groups of ``hit`` (tiles, G) in order: (lists (tiles,
    K) i64 group ids, -1 past a tile's count)."""
    tiles = hit.shape[0]
    tile, grp = torch.nonzero(hit, as_tuple=True)
    counts = hit.sum(dim=1)
    k = int(counts.max().item()) if tiles else 0
    lists = torch.full((tiles, k), -1, dtype=torch.int64, device=hit.device)
    starts = torch.cumsum(counts, 0) - counts
    lists[tile, torch.arange(tile.numel(), device=hit.device)
          - starts[tile]] = grp
    return lists


def _group_planes(ints, za, lists, row_mask, width: int, height: int):
    """Tile planes (z, tid) after every tile's groups of ``lists``, in
    order: per visit the group's 8 rows (setup ints ``ints`` (T, >= 15),
    z-plane coefficients ``za`` (T, 3) f32) at the visit's tile rows
    (``row_mask(groups)`` -> (tiles, TILE_H) bool), the group's winner
    (covered with z >= 0, else BIG_Z; ties to the lower row) merged by
    strict less.  Equal, row for row, to the group's rows tested in order
    under the strict-less test."""
    ty, tx = height // tr.TILE_H, width // tr.TILE_W
    planes, py, px = tr._tile_planes(ty, tx, True, ints.device, depth=True)
    in_group = torch.arange(GROUP, device=ints.device)
    for k in range(lists.shape[1]):
        grp = lists[:, k]
        rows = (grp.clamp(min=0)[:, None] * GROUP + in_group).T  # (8, tiles)
        ri = ints[rows].reshape(GROUP, ty, tx, 1, 1, -1)
        zk = za[rows].reshape(GROUP, ty, tx, 1, 1, 3)

        def ic(c):
            return ri[..., c]

        e = [ic(dx) * (py - ic(y)) - ic(dy) * (px - ic(x))
             for dx, dy, x, y in ((I_DX0, I_DY0, I_X1, I_Y1),
                                  (I_DX1, I_DY1, I_X2, I_Y2),
                                  (I_DX2, I_DY2, I_X0, I_Y0))]
        cov = (e[0] >= ic(I_BIAS0)) & (e[1] >= ic(I_BIAS1)) \
            & (e[2] >= ic(I_BIAS2))
        z = (e[0].to(F32) * zk[..., 0] + e[1].to(F32) * zk[..., 1]) \
            + e[2].to(F32) * zk[..., 2]
        z = torch.where(cov & (z >= 0.0), z, BIG_Z)
        win = torch.argmin(z, dim=0, keepdim=True)  # first of equal z
        zw = z.gather(0, win)[0]
        idw = rows.reshape(GROUP, ty, tx, 1, 1).expand_as(z).gather(0, win)[0]
        mask = (row_mask(grp) & (grp >= 0)[:, None]).reshape(
            ty, tx, tr.TILE_H, 1)
        upd = mask & (zw < planes["z"])
        planes["z"] = torch.where(upd, zw, planes["z"])
        planes["tid"] = torch.where(upd, idw.to(I32), planes["tid"])
    depth = tr._frame(planes["z"])
    tid = tr._frame(planes["tid"])
    return depth, torch.where(tid == tr._INT_MAX, NO_ROW, tid)


def raster_vis_plain(supers, bits, ti, tf, width: int, height: int):
    """Plain torch K10vis: (depth f32, row id i32) over the (height,
    width) frame."""
    tr._check_frame(width, height)
    ty, tx = height // tr.TILE_H, width // tr.TILE_W
    ng = ti.shape[0] // GROUP
    shifts = torch.arange(32, dtype=I32, device=ti.device)
    hit = ((bits[:, :, None] >> shifts) & 1).bool().reshape(ty * tx, -1)
    sup = tr._tile_hits(supers, ty, tx)
    groups = torch.arange(ng, device=ti.device)
    hit = hit[:, :ng] & sup[:, groups // (SUPER_BLOCK * RASTER_BLOCK // GROUP)]
    whole = torch.ones((ty * tx, tr.TILE_H), dtype=torch.bool,
                       device=ti.device)
    return _group_planes(ti, tf[:, F_ZA0:F_ZA0 + 3], _visit_lists(hit),
                         lambda grp: whole, width, height)


def raster_trans_plain(supers, blocks, rec, gbounds, width: int,
                       height: int):
    """Plain torch K10trans: (depth f32, row id i32)."""
    tr._check_frame(width, height)
    ty, tx = height // tr.TILE_H, width // tr.TILE_W
    dev = rec.device
    groups = torch.arange(gbounds.shape[0], device=dev)
    block = groups // (RASTER_BLOCK // TRANS_GROUP)
    hit = (tr._tile_hits(gbounds, ty, tx)
           & tr._tile_hits(blocks, ty, tx)[:, block]
           & tr._tile_hits(supers, ty, tx)[:, block // SUPER_BLOCK])
    lists = _visit_lists(hit)
    row0 = (torch.arange(ty * tx, device=dev) // tx * tr.TILE_H)[:, None]
    tile_row = torch.arange(tr.TILE_H, device=dev)

    def chunk_rows(grp):
        """The reference's chunk loop: chunk c of the group's tile rows
        starts at min(lo + c * TRANS_R, TILE_H - TRANS_R)."""
        gb = gbounds[grp.clamp(min=0)]
        lo = (gb[:, 2:3] - row0).clamp(min=0)
        hi = (gb[:, 3:4] - row0).clamp(max=tr.TILE_H - 1)
        nch = torch.div(hi - lo, TRANS_R, rounding_mode="floor") + 1
        mask = torch.zeros((ty * tx, tr.TILE_H), dtype=torch.bool, device=dev)
        for c in range(tr.TILE_H // TRANS_R + 1):
            rc = (lo + c * TRANS_R).clamp(max=tr.TILE_H - TRANS_R)
            mask |= (c < nch) & (tile_row >= rc) & (tile_row < rc + TRANS_R)
        return mask

    za = rec[:, TRANS_ZA:TRANS_ZA + 3].contiguous().view(F32)
    return _group_planes(rec, za, lists, chunk_rows, width, height)


# ---------------------------------------------------------------------------
# The CUDA kernels' rules (csrc/raster_vis.cu), in torch
# ---------------------------------------------------------------------------


def vis_block_hits(supers, bits, rows: int, width: int, height: int):
    """(tiles, S * SUPER_BLOCK) bool: K10vis's hit blocks over ``rows``
    rows, the blocks b < rows / RASTER_BLOCK whose superblock meets the
    tile and whose 16 group bits are not all clear
    (``raster.hier_hit_words`` gives their hit words)."""
    ty, tx = height // tr.TILE_H, width // tr.TILE_W
    b = torch.arange(supers.shape[0] * SUPER_BLOCK, device=bits.device)
    live = b < rows // RASTER_BLOCK
    words = bits[:, torch.where(live, b // 2, 0)].to(torch.int64)
    half = (words >> (16 * (b % 2))) & 0xFFFF
    return ((half != 0) & live
            & tr._tile_hits(supers, ty, tx).repeat_interleave(SUPER_BLOCK,
                                                              1))


def admitted_rows(block_hits, width: int, bits=None, gbounds=None):
    """The (tile, row) pairs a kernel pends: (rows, tile y, tile x), int64.
    Each hit block's (``block_hits`` (tiles, B)) rows whose group is
    admitted: K10vis (``bits``) every row of a group whose bitmap bit is
    set, K10trans (``gbounds``) every row of a group whose bbox meets the
    tile."""
    tx = width // tr.TILE_W
    tile, blk = torch.nonzero(block_hits, as_tuple=True)
    rows = blk[:, None] * RASTER_BLOCK + torch.arange(
        RASTER_BLOCK, device=blk.device)
    grp = rows // GROUP
    tile = tile[:, None].expand_as(rows)
    if gbounds is None:
        word = bits[tile, grp // 32].to(torch.int64)
        keep = ((word >> (grp % 32)) & 1) == 1
    else:
        gb = gbounds[grp].to(torch.int64)
        r0, c0 = tile // tx * tr.TILE_H, tile % tx * tr.TILE_W
        keep = ((gb[..., 1] >= c0) & (gb[..., 0] < c0 + tr.TILE_W)
                & (gb[..., 3] >= r0) & (gb[..., 2] < r0 + tr.TILE_H)
                & (gb[..., 0] <= gb[..., 1]) & (gb[..., 2] <= gb[..., 3]))
    tile = tile[keep]
    return rows[keep], tile // tx, tile % tx


def window_rects(ri, rows, tile_y, tile_x, gbounds=None):
    """The window of each (tile, row) pair: (P, 4) int64 [jmin, jmax, imin,
    imax], row ``rows``'s (setup ints ``ri``) vertices' pixel bbox
    (``raster.vertex_bbox``) in tile (tile_y, tile_x); with ``gbounds``
    (K10trans) within its group's chunk rows, [min(lo, TILE_H - TRANS_R),
    min(lo + TRANS_R * nch, TILE_H)) of the tile, lo = max(imin - row0, 0),
    nch = (min(imax - row0, TILE_H - 1) - lo) // TRANS_R + 1.  Empty where
    jmin > jmax or imin > imax."""
    jmin, jmax, imin, imax = tr.vertex_bbox(ri[rows].to(torch.int64)).unbind(1)
    r0, c0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    lo, hi = r0, r0 + tr.TILE_H - 1
    if gbounds is not None:
        gb = gbounds[rows // GROUP].to(torch.int64)
        first = (gb[:, 2] - r0).clamp(min=0)
        nch = torch.div((gb[:, 3] - r0).clamp(max=tr.TILE_H - 1) - first,
                        TRANS_R, rounding_mode="floor") + 1
        lo = r0 + first.clamp(max=tr.TILE_H - TRANS_R)
        hi = r0 + (first + TRANS_R * nch).clamp(max=tr.TILE_H) - 1
    return torch.stack([torch.maximum(jmin, c0),
                        torch.minimum(jmax, c0 + tr.TILE_W - 1),
                        torch.maximum(imin, lo), torch.minimum(imax, hi)], 1)


def vis_key(z, ids):
    """The kernels' int64 key of fragments at depth ``z`` of rows ``ids``:
    the order bits of z (its sign cleared), the row id, the sign of z."""
    zb = z.view(I32).to(torch.int64)
    return (((zb & 0x7FFFFFFF) << 32) | (ids.to(torch.int64) << 1)
            | ((zb >> 31) & 1))


def window_keys(keys, ri, za, rows, rects, tile_y, tile_x, width: int):
    """Scatter-min into ``keys`` (H * W int64, in place) the ``vis_key`` of
    each (tile, row) pair's fragments inside its window ``rects``: setup
    ints ``ri`` (T, >= 15), z-plane coefficients ``za`` (T, 3) f32."""
    r = ri[rows]
    y0, x0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    base, sy, sx = h2.edge_windows(r, y0, x0)
    h2.window_min(keys, width, y0, x0, tr.TILE_H, base, sy, sx,
                  r[:, I_BIAS0:I_BIAS0 + 3], za[rows], rows,
                  rows=rects[:, 2:], cols=rects[:, :2], key_of=vis_key,
                  clear=KEY_CLEAR)


def key_planes(keys, width: int, height: int):
    """The kernels' store of a key plane: (depth f32, row id i32), 1.0 and
    NO_ROW under KEY_CLEAR, else z with its sign and the row id."""
    won = keys != KEY_CLEAR
    bits = (keys >> 32) | ((keys & 1) << 31)
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(I32)
    depth = torch.where(won, bits.view(F32), 1.0)
    idx = torch.where(won, (keys & 0xFFFFFFFF) >> 1, NO_ROW).to(I32)
    return depth.reshape(height, width), idx.reshape(height, width)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster_vis.cu)
# ---------------------------------------------------------------------------


def _require(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensor on {dev} expected, got "
                             f"{t.device}")
        want = F32 if name == "tf" else I32
        if t.dtype != want:
            raise TypeError(f"{name}: {want} expected, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor expected")


def _require_tables(supers, blocks, rows: int):
    if (supers.ndim != 2 or supers.shape[1] != 8
            or supers.shape[0] * SUPER_BLOCK * RASTER_BLOCK < rows
            or rows % RASTER_BLOCK):
        raise ValueError(f"supers do not cover {rows} rows (a multiple of "
                         f"{RASTER_BLOCK})")
    if blocks is not None and (tuple(blocks.shape[1:]) != (8,)
                               or blocks.shape[0] * RASTER_BLOCK < rows):
        raise ValueError("blocks do not cover the rows")


def _run_vis(fn, dev, width: int, height: int, num_supers: int, *args):
    """Allocate the (depth, row id) planes, the hit words (tiles * (2
    num_supers + 1) ints) and, with more than one of VIS_ITEMS work items a
    tile, the key plane of the output's size, and launch ``fn(*args,
    items, buf, plane, depth, idx, height, width, stream)`` on the current
    stream of ``dev``."""
    items = VIS_ITEMS
    if items < 1:
        raise ValueError(f"VIS_ITEMS must be positive, got {items}")
    tiles = (height // tr.TILE_H) * (width // tr.TILE_W)
    buf = torch.empty(tiles * (2 * num_supers + 1), dtype=I32, device=dev)
    plane = (torch.empty(height * width, dtype=torch.int64, device=dev)
             if items > 1 else None)
    depth = torch.empty((height, width), dtype=F32, device=dev)
    idx = torch.empty((height, width), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tr._launch(fn, *args, items, tr._ptr(buf),
                   None if plane is None else tr._ptr(plane),
                   tr._ptr(depth), tr._ptr(idx), height, width,
                   ctypes.c_void_p(stream))
    return depth, idx


def raster_vis_kernel(supers, bits, ti, tf, width: int, height: int):
    """Launch K10vis (``csrc/raster_vis.cu``) on the current stream ->
    (depth f32, row id i32)."""
    tr._check_frame(width, height)
    _require(ti.device, supers=supers, bits=bits, ti=ti, tf=tf)
    rows = ti.shape[0]
    _require_tables(supers, None, rows)
    tiles = (height // tr.TILE_H) * (width // tr.TILE_W)
    if (ti.ndim != 2 or ti.shape[1] != NI32
            or tuple(tf.shape) != (rows, NF32)
            or tuple(bits.shape) != (tiles, -(-rows // (32 * GROUP)))):
        raise ValueError("ti/tf/bits do not match the rows and tile grid")
    p = tr._ptr
    out = _run_vis(_build.load_library().zr_raster_vis, ti.device, width,
                   height, supers.shape[0], p(supers), supers.shape[0],
                   p(bits), bits.shape[1], p(ti), p(tf),
                   rows // RASTER_BLOCK)
    raster_vis_kernel.launches += 1
    return out


def raster_trans_kernel(supers, blocks, rec, gbounds, width: int,
                        height: int):
    """Launch K10trans (``csrc/raster_vis.cu``) on the current stream ->
    (depth f32, row id i32)."""
    tr._check_frame(width, height)
    _require(rec.device, supers=supers, blocks=blocks, rec=rec,
             gbounds=gbounds)
    rows = rec.shape[0]
    _require_tables(supers, blocks, rows)
    if blocks.shape[0] != supers.shape[0] * SUPER_BLOCK:
        raise ValueError("blocks: SUPER_BLOCK rows a superblock expected")
    if (rec.ndim != 2 or rec.shape[1] != REC_LANES
            or tuple(gbounds.shape) != (rows // TRANS_GROUP, 4)):
        raise ValueError(f"rec: (T, {REC_LANES}) and gbounds: (T / "
                         f"{TRANS_GROUP}, 4) expected")
    p = tr._ptr
    out = _run_vis(_build.load_library().zr_raster_trans, rec.device, width,
                   height, supers.shape[0], p(supers), supers.shape[0],
                   p(blocks), p(rec), p(gbounds))
    raster_trans_kernel.launches += 1
    return out


KERNELS = (raster_vis_kernel, raster_trans_kernel)
for _kernel in KERNELS:
    _kernel.launches = 0
del _kernel


def rasterize_setup_vis(tri_i32, tri_f32, width: int, height: int):
    """K10vis: the prepare, the kernel (CUDA tensors) or its plain version
    (CPU tensors), then the colour resolve -> (packed i32, depth f32)."""
    tr._check_frame(width, height)
    *args, table = prepare_vis_inputs(tri_i32, tri_f32, width, height)
    vis = raster_vis_plain if tr._on_cpu(tri_i32) else raster_vis_kernel
    depth, idx = vis(*args, width, height)
    return resolve_flat_vis(depth, idx, table), depth


def rasterize_setup_trans(tri_i32, tri_f32, width: int, height: int):
    """K10trans: the prepare, the kernel or its plain version, then the
    colour resolve -> (packed i32, depth f32)."""
    tr._check_frame(width, height)
    *args, table = prepare_trans_inputs(tri_i32, tri_f32)
    vis = raster_trans_plain if tr._on_cpu(tri_i32) else raster_trans_kernel
    depth, idx = vis(*args, width, height)
    return resolve_flat_vis(depth, idx, table), depth
