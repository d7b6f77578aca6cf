"""Flat raster: prepares, the CUDA kernels' wrappers, their plain torch
versions, the resolve/unpack, and the frame dispatch.

Counterpart of the flat path of ``zrenderer_tpu/ops/raster_pallas.py``:

* K1, the small-scene binned raster (``rasterize_setup_pallas_small``):
  ``prepare_binned_small`` builds sort-free per-tile lists of the head
  rows; the kernel loops its tile's list with the (z, row id) depth
  tie-break, then sends the clipped-fan rows through the
  superblock -> block -> row hierarchy.  CUDA: ``csrc/raster_small.cu``.
* K3, the hierarchy raster (``rasterize_setup_pallas``):
  ``prepare_raster_inputs`` compacts live rows and builds the block and
  superblock union bboxes; the kernel walks the hierarchy in submission
  order with the strict-less depth test; on the card each tile's hit
  blocks are written once a call as hit words (``hier_hit_words``), which
  its work items read.  CUDA: ``csrc/raster_hier.cu``.
* K5, the streamed hierarchy (``rasterize_setup_pallas_hbm``): K3's
  walk and test without the 32768-row cap (every kernel reads its rows
  from device memory on the card).
* K4, the record-streaming binned raster
  (``rasterize_setup_pallas_binned_hbm``): ``prepare_binned_hbm_inputs``
  lists each small-footprint head row once per tile it touches, sorts the
  (tile, row) pairs and gathers each pair's setup record in pair order;
  the kernel evaluates its tile's contiguous record span, then the
  leftover rows through the hierarchy, with the (z, row id) tie-break.
  On the card K4 (and K4g, K4d) run the keyed body: per-pixel keys in
  shared memory, each record over its window (its vertices' pixel bbox in
  the tile), a tile's span cut into work items of at most ITEM_RECORDS
  records (fewer for small lists: KEYED_MIN_ITEMS); K3, K3b, K3g, K3d, K5
  and K5g run it over the hierarchy alone, a tile's blocks cut into
  HIER_ITEMS work items.  K4c adds the
  coarse class: rows too big for the fine lists listed per 4x4-tile bin,
  tested against the tile's bbox; on the card it runs K4's keyed body
  over the tile's span and then its bin's records, cut into work items
  together.
* K6, the global pair-list raster (``rasterize_setup_pallas_binned``):
  ``prepare_binned_inputs`` sorts the same pairs but keeps row ids; the
  kernel reads its tile's rows through them.  On the card K6, K6g and K6d
  run K4's, K4g's and K4d's keyed body, each listed row gathered from the
  setup rows by its id.  K4, K4c and K6 live in
  ``csrc/raster_binned.cu``.

All produce a packed RGBA8 plane (u32 bits carried in an ``int32``
tensor; alpha 255 sets bit 31) and an f32 depth plane over the padded
(H, W) frame, resolved with one divide per pixel (docs/RASTER_SPEC.md §4).
The frame entries (``render_frame`` from the column buffers,
``render_frame_indexed`` from the indexed ones with an optional vertex
shader) can kill the rows of culled meshlets before the dispatch
(``cull_meshlets``); ``ssaa_resolve`` box-filters a supersampled frame.

The G-buffer kernels (K2g, K3g, K4g, K5g, K6g) add the lit planes; the
depth-only kernels of the shadow-map pass (K2d, K3d, K4d, K6d) keep z
alone under the strict-less test and write one f32 plane (``render_depth``
dispatches them, and takes K5's depth plane for ``hierarchy`` above the
row bound).

The band kernels of the sharded frames (``zrenderer_tpu_torch/parallel``)
rasterize one horizontal band of ``band_h`` rows starting at global row
``row0`` into a (band_h, W) output:

* K3b (``rasterize_setup_pallas_band``): K3 over one band;
* K9 (``rasterize_setup_pallas_binned_band``): K4 over one band, with the
  band-local prepare (``band_ty0``/``band_tiles_y``: bboxes clamped to the
  band, keys band-local) or the full-frame one (spans indexed by global
  tile); on the card K4's keyed body with a band-sized key plane;
* K9g (``rasterize_gbuffer_pallas_binned_band``): K4g over one band;
* K9d (``rasterize_setup_pallas_binned_band_dist``): K4 over one band
  whose records come from every triangle shard
  (``prepare_binned_dist_local`` on each shard, one all-to-all), one span
  per source, then the hierarchy over the rows no shard listed; on the
  card K9's keyed body over a tile's spans laid end to end.

Each kernel has a plain torch version beside it taking the same prepared
inputs.  The ``rasterize_setup*`` wrappers take the plain version only for
CPU tensors; for CUDA tensors they launch the kernel or raise.  Each
kernel-launching function counts its launches in its ``launches``
attribute.
"""

from __future__ import annotations

import ctypes

import torch

from zrenderer_tpu_torch.ops.geometry import (
    F_CB0,
    F_CG0,
    F_CR0,
    F_EMB,
    F_EMG,
    F_EMR,
    F_MET,
    F_NX0,
    F_NY0,
    F_NZ0,
    F_RGH,
    F_RW0,
    F_TEX,
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
    SUBPIXEL,
    SUPER_BLOCK,
    head_count,
)
from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import geometry as tg

# Screen tile of both kernels: one CUDA block per tile.  Fixed: the
# prepares' per-tile list granularity and the kernels' thread layout
# (csrc/raster_common.cuh) both depend on it.
TILE_H = 32
TILE_W = 128

# Head-row bound of the sort-free small-scene lists (K1, K2g, K2d), as in
# the reference's SMALL_BIN_MAX_ROWS; also the kernels' shared-memory list
# size.
SMALL_BIN_MAX_ROWS = 1024

# The reference's VMEM_RESIDENT_MAX_TRIS: the dispatch sends frames with
# more setup rows to the streaming kernels (K4, K4c, K5), and K1/K3 take
# at most this many.
MAX_RESIDENT_ROWS = 32768

# K6 pair lists: the auto cap trades pair count against leftover rows.
BIN_PAIR_BUDGET = 1 << 20
# K4 records: the static record-slot budget; listed rows past it are
# demoted to the leftover hierarchy by an exact prefix clamp.
HBM_PAIR_BUDGET = 1 << 20
# K4/K4c/K4g/K4d/K9/K9d/K6d: a tile's record lists are cut into work
# items of at most this many records, one CUDA block each
# (csrc/raster_binned.cu, the keyed body); the wrappers read it at call
# time.  At 1M triangles on the H100, 256 ran K4 in 0.64 ms against 0.75
# for 1024 and K4d in 0.40 against 0.42 (PERF.md §6).
ITEM_RECORDS = 256
# The kernel halves the item size (down to MIN_ITEM_RECORDS, a constant of
# csrc/raster_binned.cu) while the lists' records would make fewer than
# KEYED_MIN_ITEMS items (``keyed_item_records``), so that the small lists
# of a 20K-triangle map or a 40K-triangle band still spread over the card;
# the wrappers read it at call time (0: never halve).  On the H100, K6d on
# the 20K lattice's map and K9d on the 40K lattice's band took 0.21 and
# 0.23 ms of device time a call at 256 records an item, 0.084 (pair_tri
# cut to its spans) and 0.105 at 32; 1024 halves those to 32 and none of
# the 1M lists (PERF.md §6).
KEYED_MIN_ITEMS = 1024
MIN_ITEM_RECORDS = 32
# K3/K3b/K3g/K3d/K5/K5g: the blocks of the hierarchy that meet a tile are
# cut into this many work items, one CUDA block each (csrc/raster_hier.cu,
# the keyed body; ``hier_work_items``).  Each call first writes the tiles'
# hit words; then one item a tile resolves in place (two device operations
# a call); several merge through the output's key plane (memset, items,
# resolve), except in tiles whose rows lie in at most one block.  The
# wrappers read it at call time.  On the H100 at lattice20k, 16 ran K3d on
# its 1024^2 map in 0.098 ms against 0.29 for 1, 0.15 for 4 and 0.11 for
# 64, and K3g in 0.161 against 0.30, 0.19 and 0.20 (PERF.md §6).
HIER_ITEMS = 16
# K4c: coarse bins are COARSE_CB x COARSE_CB tiles; the tile_lists
# dispatch lists a row in at most TILE_LISTS_COARSE_CAP of them.
COARSE_CB = 4
TILE_LISTS_COARSE_CAP = 8

BINNINGS = ("auto", "small", "hierarchy", "tile_lists")

# Sharded frames: the band prepare's pair budget shrinks with the band
# count (``band_pair_budget``), and the distributed prepare sends each band
# owner at most DIST_SLAB_RECORDS records per source shard, rounded up to
# REC_ALIGN (the reference's slab granularity, which is part of the
# budget's semantics).
DIST_SLAB_RECORDS = 1 << 15
REC_ALIGN = 256

_INT_MAX = 2**31 - 1
_ALPHA_BITS = -(1 << 24)  # 0xFF000000 as int32
F32 = torch.float32
I32 = torch.int32


def _pad_rows(tri_i32, tri_f32):
    """Pad setup rows to a RASTER_BLOCK multiple with dead rows."""
    pad = (-tri_i32.shape[0]) % RASTER_BLOCK
    if not pad:
        return tri_i32, tri_f32
    dead = torch.zeros((pad, NI32), dtype=I32, device=tri_i32.device)
    dead[:, I_JMIN] = 1
    dead[:, I_BIAS0:I_BIAS2 + 1] = _INT_MAX
    tri_i32 = torch.cat([tri_i32, dead])
    tri_f32 = torch.cat([
        tri_f32, torch.zeros((pad, NF32), dtype=F32, device=tri_f32.device)
    ])
    return tri_i32, tri_f32


def _check_frame(width: int, height: int):
    if width <= 0 or height <= 0 or width % TILE_W or height % TILE_H:
        raise ValueError(
            f"raster target {width}x{height} must be a positive multiple "
            f"of {TILE_W}x{TILE_H}"
        )


# ---------------------------------------------------------------------------
# Prepares
# ---------------------------------------------------------------------------


def prepare_raster_inputs(tri_i32, tri_f32):
    """K3/K5 prepare: pad to RASTER_BLOCK, stable-compact live rows to the
    front, and build the block/superblock union bboxes.  Returns (supers,
    blocks, tri_i32, tri_f32)."""
    tri_i32, tri_f32 = _pad_rows(tri_i32, tri_f32)
    tri_i32, tri_f32 = tg.compact_triangles(tri_i32, tri_f32)
    blocks = tg.block_bounds(tri_i32)
    blocks, supers = tg.super_bounds(blocks)
    return supers, blocks, tri_i32, tri_f32


# Short-row class of the two-class raster experiments: a live row whose
# bbox spans at most SHORT_ROWS pixel rows (imax - imin < SHORT_ROWS).
SHORT_ROWS = 8


def classify_short(tri_i32):
    """(T,) bool: live rows whose bbox fits a SHORT_ROWS-row window."""
    span = tri_i32[:, I_IMAX] - tri_i32[:, I_IMIN]
    return (tri_i32[:, I_VALID] > 0) & (span < SHORT_ROWS)


def kill_rows(tri_i32, mask):
    """Empty the bbox (jmin 1 > jmax 0) and clear I_VALID of the rows in
    ``mask``: they drop out of the block tables and the per-row bbox tests
    but keep their place (a copy; the input is not changed)."""
    ti = tri_i32.clone()
    ti[:, I_JMIN] = torch.where(mask, 1, ti[:, I_JMIN])
    ti[:, I_JMAX] = torch.where(mask, 0, ti[:, I_JMAX])
    ti[:, I_VALID] = torch.where(mask, 0, ti[:, I_VALID])
    return ti


def _leftover_rows(tri_i32, listed):
    """Empty the bbox and valid flag of the head rows flagged in ``listed``
    (the first ``len(listed)`` rows), so the hierarchy skips the rows the
    lists own.  Returns (supers, blocks, hier)."""
    n = listed.shape[0]
    hier = tri_i32.clone()
    head = hier[:n]
    head[:, I_JMIN] = torch.where(listed, 1, head[:, I_JMIN])
    head[:, I_JMAX] = torch.where(listed, 0, head[:, I_JMAX])
    head[:, I_VALID] = torch.where(listed, 0, head[:, I_VALID])
    blocks = tg.block_bounds(hier)
    blocks, supers = tg.super_bounds(blocks)
    return supers, blocks, hier


def _tile_span(head):
    """Per head row: valid flag and the tile range of its bbox,
    (valid, tj0, tj1, ty0, ty1), floor-divided like the reference (an
    empty or off-screen bbox may give an empty or negative range)."""
    return (head[:, I_VALID] > 0,
            head[:, I_JMIN] // TILE_W, head[:, I_JMAX] // TILE_W,
            head[:, I_IMIN] // TILE_H, head[:, I_IMAX] // TILE_H)


def prepare_binned_small(tri_i32, tri_f32, width: int, height: int):
    """K1 prepare: sort-free per-tile lists of the head rows.

    Returns (counts (num_tiles,) i32, lists (num_tiles*n_head, 1) i32,
    supers, blocks, hier, tri_f32).  Tile t owns list rows
    [t*n_head, t*n_head + counts[t]), ascending row ids (the rest hold
    n_head).  ``hier`` is the padded setup with every head row's bbox
    emptied, so the phase-2 hierarchy only sees the clipped-fan rows.
    """
    tiles_x = width // TILE_W
    tiles_y = height // TILE_H
    num_tiles = tiles_x * tiles_y
    n_head = head_count(tri_i32.shape[0])
    if n_head > SMALL_BIN_MAX_ROWS:
        raise ValueError(
            f"prepare_binned_small: {n_head} head rows > "
            f"{SMALL_BIN_MAX_ROWS} (use the hierarchy raster)"
        )
    tri_i32, tri_f32 = _pad_rows(tri_i32, tri_f32)
    dev = tri_i32.device

    head = tri_i32[:n_head]
    valid, tj0, tj1, ty0, ty1 = _tile_span(head)
    live = (valid & (head[:, I_JMIN] <= head[:, I_JMAX])
            & (head[:, I_IMIN] <= head[:, I_IMAX]))
    rows = torch.arange(tiles_y, dtype=I32, device=dev)[:, None, None]
    cols = torch.arange(tiles_x, dtype=I32, device=dev)[None, :, None]
    hit = ((rows >= ty0) & (rows <= ty1)
           & (cols >= tj0) & (cols <= tj1) & live)  # (ty, tx, n_head)
    hit = hit.reshape(num_tiles, n_head)
    counts = hit.sum(dim=1, dtype=I32)
    ids = torch.arange(n_head, dtype=I32, device=dev)
    lists = torch.sort(torch.where(hit, ids, n_head), dim=1).values

    supers, blocks, hier = _leftover_rows(
        tri_i32, torch.ones(n_head, dtype=torch.bool, device=dev))
    return (counts, lists.reshape(num_tiles * n_head, 1).to(I32), supers,
            blocks, hier, tri_f32)


def bin_cap_for(n_rows: int) -> int:
    """K6 auto cap: generous for small scenes, bounded by the pair budget
    for large ones (the reference's ``bin_cap_for``)."""
    return int(max(4, min(256, BIN_PAIR_BUDGET // max(n_rows, 1))))


def _prefix_clamp(listed, foot, budget: int):
    """Keep the longest prefix of listed rows whose summed footprint fits
    ``budget`` (the reference's int32 cumsum; int64 here, equal while the
    int32 sum cannot overflow, which n_rows * cap < 2**31 ensures).

    A valid row whose bbox clamps to empty can have a negative footprint
    and emits no pair, so it counts 0 here.  The reference sums it as
    negative, which lets the listed pairs pass the budget and the kernel
    read past the gathered records (ROADMAP Queue 3)."""
    used = torch.cumsum(torch.where(listed, foot.clamp(min=0), 0), dim=0)
    return listed & (used <= budget)


def _pair_keys(listed, foot, nx, y0, x0, cap: int, stride: int,
               sentinel: int):
    """(row, slot) pair keys, row-major over ``cap`` slots: slot e of a
    listed row with e < foot is bin (y0 + e // nx) * stride + x0 + e % nx,
    any other slot is ``sentinel``.  Returns (n_rows * cap,) i32."""
    e = torch.arange(cap, dtype=I32, device=listed.device)[None, :]
    # A zero-width range has foot 0, so no key reads its quotient.
    nx = torch.where(nx == 0, 1, nx)[:, None]
    ok = listed[:, None] & (e < foot[:, None])
    keys = torch.where(ok, (y0[:, None] + e // nx) * stride
                       + (x0[:, None] + e % nx), sentinel)
    return keys.reshape(-1)


def pair_value_sort(keys, cap: int, num_tiles: int):
    """Sort (bin, pair) keys by value; counterpart of ``_pair_value_sort``.

    Pair p = row * cap + slot is packed below its key into one int64, so
    every value is unique and one sort gives what the reference's packed
    i32 and lexicographic branches both give: pairs grouped by bin,
    ascending row ids within a bin.  Returns (sorted_tri (P,) i32 row ids,
    offsets (num_tiles+1,) i32 bin span boundaries)."""
    p0 = keys.shape[0]
    idx_bits = max(1, (p0 - 1).bit_length())
    dev = keys.device
    packed = (keys.to(torch.int64) * (1 << idx_bits)
              + torch.arange(p0, dtype=torch.int64, device=dev))
    sp = torch.sort(packed).values
    sorted_tri = ((sp & ((1 << idx_bits) - 1)) // cap).to(I32)
    bounds = torch.arange(num_tiles + 1, dtype=torch.int64,
                          device=dev) * (1 << idx_bits)
    return sorted_tri, torch.searchsorted(sp, bounds).to(I32)


def _coarse_grid(tiles_x: int, tiles_y: int):
    """(bins per row, bins) of the COARSE_CB x COARSE_CB-tile bin grid."""
    ctiles_x = -(-tiles_x // COARSE_CB)
    return ctiles_x, ctiles_x * -(-tiles_y // COARSE_CB)


def _gather_records(tri_i32, tri_f32, rows):
    """Setup records of ``rows`` in order: (P, NI32 + 1) i32 whose last
    column is the row id (the tie-break id), and (P, NF32) f32."""
    idx = rows.long()
    return torch.cat([tri_i32[idx], rows[:, None]], dim=1), tri_f32[idx]


def prepare_binned_inputs(tri_i32, tri_f32, width: int, height: int,
                          cap: int | None = None):
    """K6 prepare: global (tile, row) pair lists of the head rows whose
    bbox spans at most ``cap`` tiles, sorted by tile.

    Returns (offsets (num_tiles+1,) i32, pair_tri (n_head*cap,) i32,
    supers, blocks, hier, tri_f32): tile t owns pair_tri[offsets[t]:
    offsets[t+1]], ascending row ids; ``hier`` is the padded setup with
    the listed rows' bboxes emptied, for the leftover hierarchy."""
    _check_frame(width, height)
    tiles_x = width // TILE_W
    num_tiles = tiles_x * (height // TILE_H)
    n_head = head_count(tri_i32.shape[0])
    if cap is None:
        cap = bin_cap_for(n_head)
    tri_i32, tri_f32 = _pad_rows(tri_i32, tri_f32)
    valid, tj0, tj1, ty0, ty1 = _tile_span(tri_i32[:n_head])
    ntx = tj1 - tj0 + 1
    foot = ntx * (ty1 - ty0 + 1)
    listed = valid & (foot <= cap)
    keys = _pair_keys(listed, foot, ntx, ty0, tj0, cap, tiles_x, num_tiles)
    pair_tri, offsets = pair_value_sort(keys, cap, num_tiles)
    supers, blocks, hier = _leftover_rows(tri_i32, listed)
    return offsets, pair_tri, supers, blocks, hier, tri_f32


def hbm_cap_for(n_head: int) -> int:
    """The record prepares' auto cap for ``n_head`` head rows: more
    generous than K6's, as the record budget clamps the listing."""
    return int(min(256, max(4, (4 * HBM_PAIR_BUDGET) // max(n_head, 1))))


def prepare_binned_hbm_inputs(tri_i32, tri_f32, width: int, height: int,
                              cap: int | None = None,
                              pair_budget: int | None = None,
                              coarse_cap: int | None = None,
                              coarse_budget: int | None = None,
                              n_head: int | None = None,
                              band_ty0: int | None = None,
                              band_tiles_y: int | None = None):
    """K4 prepare: pair lists as in K6, clamped to a record budget, with
    each pair's setup record gathered in pair order.

    ``n_head``: the leading head rows, by default ``head_count`` of the
    rows; the sharded frames' gathered layout (n shards of
    ``capped_rows(shard_tris)``) does not invert that way and passes its
    true count.  ``band_ty0``/``band_tiles_y``: the band-local lists of K9
    and K9g, for the ``band_tiles_y`` tile rows from tile row ``band_ty0``:
    each bbox's tile rows are clamped to the band, keys are band-local, a
    row whose in-band footprint fits ``cap`` is listed, and the offsets
    span the band's tiles.  The coarse class is full-frame only.

    Returns (offsets, rec_i, rec_f, supers, blocks, hier, tri_f32,
    coarse).  Tile t owns records [offsets[t], offsets[t+1]); rec_i is
    (k_budget, NI32 + 1) i32 with the row id last, rec_f (k_budget, NF32)
    f32.  ``hier`` is the padded setup (not compacted: row ids are the
    input's) with every listed row's bbox emptied.  ``coarse`` is None,
    or with ``coarse_cap`` the coarse class (coffsets, crec_i, crec_f):
    rows that are not listed, whose bbox spans at most ``coarse_cap``
    bins of COARSE_CB x COARSE_CB tiles, within their own budget."""
    _check_frame(width, height)
    tiles_x = width // TILE_W
    tiles_y = height // TILE_H
    num_tiles = tiles_x * tiles_y
    n_input = head_count(tri_i32.shape[0]) if n_head is None else n_head
    if cap is None:
        cap = hbm_cap_for(n_input)
    if pair_budget is None:
        pair_budget = HBM_PAIR_BUDGET
    tri_i32, tri_f32 = _pad_rows(tri_i32, tri_f32)
    valid, tj0, tj1, ty0, ty1 = _tile_span(tri_i32[:n_input])
    ty_key = ty0
    if band_tiles_y is not None:
        if coarse_cap is not None:
            raise ValueError("the coarse class is full-frame only")
        if not 0 <= band_ty0 <= tiles_y - band_tiles_y:
            raise ValueError(f"band of {band_tiles_y} tile rows at tile row "
                             f"{band_ty0} outside {tiles_y}")
        num_tiles = tiles_x * band_tiles_y
        ty0 = torch.clamp_min(ty0, band_ty0)
        ty1 = torch.clamp_max(ty1, band_ty0 + band_tiles_y - 1)
        valid = valid & (ty0 <= ty1)
        ty_key = ty0 - band_ty0
    ntx = tj1 - tj0 + 1
    foot = ntx * (ty1 - ty0 + 1)
    k_budget = min(pair_budget, n_input * cap)
    listed = _prefix_clamp(valid & (foot <= cap), foot, k_budget)
    keys = _pair_keys(listed, foot, ntx, ty_key, tj0, cap, tiles_x,
                      num_tiles)
    sorted_tri, offsets = pair_value_sort(keys, cap, num_tiles)
    # Valid pairs sort first and number at most k_budget: only those
    # slots need records.
    rec_i, rec_f = _gather_records(tri_i32, tri_f32, sorted_tri[:k_budget])

    coarse = None
    owned = listed
    if coarse_cap is not None:
        ctiles_x, num_cbins = _coarse_grid(tiles_x, tiles_y)
        cj0, cy0 = tj0 // COARSE_CB, ty0 // COARSE_CB
        ncx = tj1 // COARSE_CB - cj0 + 1
        cfoot = ncx * (ty1 // COARSE_CB - cy0 + 1)
        if coarse_budget is None:
            coarse_budget = pair_budget
        ck_budget = min(coarse_budget, n_input * coarse_cap)
        clisted = _prefix_clamp(valid & ~listed & (cfoot <= coarse_cap),
                                cfoot, ck_budget)
        ckeys = _pair_keys(clisted, cfoot, ncx, cy0, cj0, coarse_cap,
                           ctiles_x, num_cbins)
        sorted_ctri, coffsets = pair_value_sort(ckeys, coarse_cap, num_cbins)
        coarse = (coffsets,
                  *_gather_records(tri_i32, tri_f32, sorted_ctri[:ck_budget]))
        owned = listed | clisted
    supers, blocks, hier = _leftover_rows(tri_i32, owned)
    return offsets, rec_i, rec_f, supers, blocks, hier, tri_f32, coarse


def band_pair_budget(n_bands: int) -> int:
    """K9/K9g's per-band pair budget: the full-frame budget split across
    the bands with 2x headroom for density imbalance, at least 65536."""
    return max(2 * HBM_PAIR_BUDGET // max(n_bands, 1), 1 << 16)


def dist_slab_rows(slab_records: int) -> int:
    """Records a (source, band) slab holds: ``slab_records`` rounded up to
    REC_ALIGN.  (The reference adds one streaming window of margin rows
    for its DMA reads; no kernel here reads past a span.)"""
    return -(-slab_records // REC_ALIGN) * REC_ALIGN


def prepare_binned_dist_local(ti_local, tf_local, width: int, height: int,
                              n_bands: int, shard_index: int,
                              shard_head: int,
                              slab_records: int | None = None):
    """One triangle shard's half of K9d's prepare, before the all-to-all.

    ``ti_local``/``tf_local``: the shard's capped-layout setup rows for
    ``shard_head`` triangles; its head rows have canonical ids
    ``shard_index * shard_head + row``.  A head row is listed when its
    full-frame footprint fits the auto cap of the n_bands * shard_head
    gathered head rows (``prepare_binned_hbm_inputs``'); it is sent to
    band b when its whole footprint in b still fits b's slab (an exact
    prefix over the shard's rows, whole triangles per band; a footprint
    clamped empty counts 0).

    Returns (rec_i (n_bands, R, NI32 + 1) i32 with the canonical id last,
    rec_f (n_bands, R, NF32) f32, offs (n_bands, band_tiles + 1) i32 the
    slab-local record spans, listed_send (n_bands, shard_head) bool), R =
    ``dist_slab_rows(slab_records)``: piece b of each goes to band b's
    owner."""
    _check_frame(width, height)
    tiles_x = width // TILE_W
    tiles_y = height // TILE_H
    num_tiles = tiles_x * tiles_y
    if tiles_y % n_bands:
        raise ValueError(f"{tiles_y} tile rows do not split into {n_bands} "
                         "bands")
    bty = tiles_y // n_bands
    band_tiles = tiles_x * bty
    slab = dist_slab_rows(DIST_SLAB_RECORDS if slab_records is None
                          else slab_records)
    cap = hbm_cap_for(shard_head * n_bands)
    dev = ti_local.device
    valid, tj0, tj1, ty0, ty1 = _tile_span(ti_local[:shard_head])
    ntx = tj1 - tj0 + 1
    foot = ntx * (ty1 - ty0 + 1)
    listed = valid & (foot <= cap)

    band_lo = torch.arange(n_bands, dtype=I32, device=dev) * bty
    cty0 = torch.maximum(ty0[:, None], band_lo[None, :])
    cty1 = torch.minimum(ty1[:, None], band_lo[None, :] + (bty - 1))
    ntyb = cty1 - cty0 + 1
    footb = torch.where(ntyb > 0, ntx[:, None] * ntyb, 0).clamp(min=0)
    used = torch.cumsum(torch.where(listed[:, None], footb, 0), dim=0)
    fits = used <= slab  # (shard_head, n_bands)
    listed_send = (listed[:, None] & fits).T.contiguous()

    # Pair keys over full-frame tiles; a cell is kept when its band's slab
    # took the row.
    e = torch.arange(cap, dtype=I32, device=dev)[None, :]
    nx = torch.where(ntx == 0, 1, ntx)[:, None]
    cell_ty = ty0[:, None] + e // nx
    cell_b = cell_ty // bty
    in_range = (cell_b >= 0) & (cell_b < n_bands)
    fit_e = torch.gather(fits, 1, cell_b.clamp(0, n_bands - 1).long())
    ok = listed[:, None] & (e < foot[:, None]) & in_range & fit_e
    keys = torch.where(ok, cell_ty * tiles_x + (tj0[:, None] + e % nx),
                       num_tiles).reshape(-1)
    sorted_tri, offsets_full = pair_value_sort(keys, cap, num_tiles)

    # The sorted pairs are band-contiguous: band b's slab is the next R
    # pairs from its first (rows past its span repeat the last pair).
    bands = torch.arange(n_bands, device=dev)
    band_starts = offsets_full[bands * band_tiles].long()
    seg = bands[:, None] * band_tiles + torch.arange(band_tiles + 1,
                                                     device=dev)[None, :]
    offs = (offsets_full[seg] - band_starts[:, None]).to(I32)
    idx = torch.clamp(band_starts[:, None]
                      + torch.arange(slab, device=dev)[None, :],
                      0, keys.shape[0] - 1)
    rows = sorted_tri[idx].long()  # (n_bands, R) local head rows
    pid = (rows + shard_index * shard_head).to(I32)
    rec_i = torch.cat([ti_local[rows], pid[..., None]], dim=-1)
    return rec_i, tf_local[rows], offs, listed_send


def prepare_binned_dist_owner(ti, tf, listed_mask, rec_i, rec_f, offs):
    """The band owner's half of K9d's prepare, after the all-to-all.

    ``ti``/``tf``: the gathered setup rows in canonical order;
    ``listed_mask``: (n_head,) bool, the head rows some shard sent this
    band; ``rec_i``/``rec_f``/``offs``: the received (n_src, R, ...) slabs
    and (n_src, band_tiles + 1) spans, stacked by source shard.

    Returns (offsets (n_src, band_tiles + 1) i32 rebased to the
    concatenated records, rec_i (n_src * R, NI32 + 1), rec_f
    (n_src * R, NF32), supers, blocks, hier, tf, None): ``hier`` the
    padded rows with the listed rows' bboxes emptied, for the leftover
    hierarchy; no coarse class, as ``prepare_binned_hbm_inputs``' band
    lists."""
    n_src, r = rec_i.shape[:2]
    base = torch.arange(n_src, dtype=I32, device=offs.device)[:, None] * r
    offsets = (offs + base).to(I32).contiguous()
    ti, tf = _pad_rows(ti, tf)
    supers, blocks, hier = _leftover_rows(ti, listed_mask)
    return (offsets, rec_i.reshape(n_src * r, NI32 + 1).contiguous(),
            rec_f.reshape(n_src * r, NF32).contiguous(), supers, blocks,
            hier, tf, None)


# ---------------------------------------------------------------------------
# Plain torch versions of the kernels
# ---------------------------------------------------------------------------
# Tile state lives in (tiles_y, tiles_x, TILE_H, TILE_W) planes; the
# arithmetic is the kernels' own, op for op, so CPU results are the bits
# the CUDA kernels must reproduce.

_LATCHES = (("den", F_RW0), ("nr", F_CR0), ("ng", F_CG0), ("nb", F_CB0))
# The G-buffer kernels latch five more interpolated numerators and copy six
# per-triangle constants (no 1/w) on every passing row.
_GBUF_LATCHES = (("u", F_U0), ("v", F_V0), ("nx", F_NX0), ("ny", F_NY0),
                 ("nz", F_NZ0))
_CONSTS = (("met", F_MET), ("rgh", F_RGH), ("emr", F_EMR), ("emg", F_EMG),
           ("emb", F_EMB), ("tex", F_TEX))
# Planes of a G-buffer raster: packed color (i32 bits), depth, u, v, nx, ny,
# nz, metallic, roughness, emissive r/g/b, texture layer.
GBUFFER_PLANES = 2 + len(_GBUF_LATCHES) + len(_CONSTS)


def _tile_planes(tiles_y: int, tiles_x: int, tie: bool, device,
                 gbuffer: bool = False, depth: bool = False,
                 ty_base: int = 0, tile_h: int = TILE_H,
                 tile_w: int = TILE_W):
    """Tile state: z, the row id with ``tie``, and the latches (none for
    ``depth``, the depth-only kernels; the lit ones too for ``gbuffer``).
    ``ty_base``: the global tile row of the planes' first tile row (a
    band's); ``tile_h``/``tile_w``: the tile of a kernel whose tiles are
    not 32x128."""
    shape = (tiles_y, tiles_x, tile_h, tile_w)
    planes = {"z": torch.ones(shape, dtype=F32, device=device)}
    if tie:
        planes["tid"] = torch.full(shape, _INT_MAX, dtype=I32, device=device)
    names = () if depth else _LATCHES + (
        _GBUF_LATCHES + _CONSTS if gbuffer else ())
    for name, _ in names:
        planes[name] = torch.zeros(shape, dtype=F32, device=device)
    half = SUBPIXEL // 2
    ty = torch.arange(tiles_y, dtype=I32, device=device)[:, None, None, None]
    tx = torch.arange(tiles_x, dtype=I32, device=device)[None, :, None, None]
    iy = torch.arange(tile_h, dtype=I32, device=device)[:, None]
    ix = torch.arange(tile_w, dtype=I32, device=device)[None, :]
    py = ((ty + ty_base) * tile_h + iy) * SUBPIXEL + half  # (ty, 1, th, 1)
    px = (tx * tile_w + ix) * SUBPIXEL + half  # (1, tx, 1, tw)
    return planes, py, px


def _eval_rows(planes, sel, py, px, ri, rf, tid, emask, tie: bool):
    """Coverage, depth test and latch of one row per tile of ``sel``.

    ``ri``/``rf``: setup rows broadcastable over the selected tiles
    ((NI32,)/(NF32,) for one row, (ty, tx, N) for one row per tile);
    ``tid``: the row id(s), an int or a per-tile tensor; ``emask``: a
    per-tile write mask or None.  ``tie`` selects K1's (z, id) test over
    K3's strict less.  G-buffer planes (``u`` present) latch the uv and
    normal numerators and the row's constants too; depth-only planes (z
    alone) latch nothing."""
    def ic(c):
        return ri[..., c, None, None]

    def fc(c):
        return rf[..., c, None, None]

    pys = py[sel[0]]
    pxs = px[:, sel[1]]
    e0 = ic(I_DX0) * (pys - ic(I_Y1)) - ic(I_DY0) * (pxs - ic(I_X1))
    e1 = ic(I_DX1) * (pys - ic(I_Y2)) - ic(I_DY1) * (pxs - ic(I_X2))
    e2 = ic(I_DX2) * (pys - ic(I_Y0)) - ic(I_DY2) * (pxs - ic(I_X0))
    cov = (e0 >= ic(I_BIAS0)) & (e1 >= ic(I_BIAS1)) & (e2 >= ic(I_BIAS2))
    ef0 = e0.to(F32)
    ef1 = e1.to(F32)
    ef2 = e2.to(F32)

    def interp(c):
        return (ef0 * fc(c) + ef1 * fc(c + 1)) + ef2 * fc(c + 2)

    z = interp(F_ZA0)
    zb = planes["z"][sel]
    if tie:
        tb = planes["tid"][sel]
        ok = cov & (z >= 0.0) & ((z < zb) | ((z == zb) & (tid < tb)))
    else:
        ok = cov & (z >= 0.0) & (z < zb)
    if emask is not None:
        ok = ok & emask
    planes["z"][sel] = torch.where(ok, z, zb)
    if tie:
        planes["tid"][sel] = torch.where(ok, tid, tb)
    for name, c in _LATCHES + _GBUF_LATCHES:
        if name in planes:
            planes[name][sel] = torch.where(ok, interp(c), planes[name][sel])
    for name, c in _CONSTS:
        if name in planes:
            planes[name][sel] = torch.where(ok, fc(c), planes[name][sel])


def _scan_rows(planes, py, px, ti, tf, tie: bool, ty_base: int = 0):
    """Every row with a non-empty bbox, in row order, over the tiles its
    bbox touches (the kernels' superblock/block skips never drop such a
    row: a row with a non-empty bbox is valid, so it is in both unions).
    ``ty_base``: the planes' first global tile row.  The tile size is the
    planes' (``py``/``px``)."""
    tiles_y, tile_h = py.shape[0], py.shape[2]
    tiles_x, tile_w = px.shape[1], px.shape[3]
    bbox = ti[:, [I_JMIN, I_JMAX, I_IMIN, I_IMAX]].cpu()
    rows = torch.nonzero((bbox[:, 0] <= bbox[:, 1])
                         & (bbox[:, 2] <= bbox[:, 3])).flatten().tolist()
    for r in rows:
        jmin, jmax, imin, imax = bbox[r].tolist()
        tx0, tx1 = max(jmin // tile_w, 0), min(jmax // tile_w, tiles_x - 1)
        ty0 = max(imin // tile_h - ty_base, 0)
        ty1 = min(imax // tile_h - ty_base, tiles_y - 1)
        if tx0 > tx1 or ty0 > ty1:
            continue
        sel = (slice(ty0, ty1 + 1), slice(tx0, tx1 + 1))
        _eval_rows(planes, sel, py, px, ti[r], tf[r], r, None, tie)


def _tile_hits(bounds, tiles_y: int, tiles_x: int, row0: int = 0):
    """(tiles, n) bool: bbox n of ``bounds`` (n, >= 4) [jmin, jmax, imin,
    imax] meets tile t (the kernels' tile_overlap).  The tiles are those
    of the tiles_y tile rows from global row ``row0`` (a band's)."""
    dev = bounds.device
    r0 = (torch.arange(tiles_y, dtype=I32, device=dev) * TILE_H
          + row0)[:, None]
    c0 = (torch.arange(tiles_x, dtype=I32, device=dev) * TILE_W)[:, None]
    jmin, jmax, imin, imax = (bounds[:, k] for k in range(4))
    cols = (jmax >= c0) & (jmin < c0 + TILE_W) & (jmin <= jmax)
    rows = (imax >= r0) & (imin < r0 + TILE_H) & (imin <= imax)
    return (rows[:, None, :] & cols[None, :, :]).reshape(tiles_y * tiles_x,
                                                         -1)


def _frame(p):
    """(ty, tx, tile_h, tile_w) tile planes -> the (H, W) frame."""
    ty, tx, th, tw = p.shape
    return p.permute(0, 2, 1, 3).reshape(ty * th, tx * tw).contiguous()


def _resolve_planes(planes):
    """One divide per pixel, RGBA8 packed into int32 bits; returns
    (packed (H, W) i32, depth (H, W) f32)."""
    d = planes["den"]
    covered = d > 0
    inv = torch.reciprocal(torch.where(covered, d, 1.0))

    def chan(numer):
        c = torch.clamp(torch.where(covered, numer * inv, 0.0), 0.0, 1.0)
        return torch.floor(c * 255.0 + 0.5).to(I32)

    packed = (chan(planes["nr"]) | (chan(planes["ng"]) << 8)
              | (chan(planes["nb"]) << 16) | _ALPHA_BITS)
    return _frame(packed), _frame(planes["z"])


def _resolve_gbuffer(planes, masked_inv: bool):
    """The G-buffer epilogue: packed color and depth as ``_resolve_planes``,
    the uv/normal numerators times 1/den, the constants as latched.

    The kernels differ in the form of the divide, which shows in the sign
    of zero and in NaN where a row passed with den <= 0: K3g writes
    where(covered, buf * inv, 0) (``masked_inv=False``), K2g, K4g and K5g
    buf * where(covered, inv, 0).  Returns the GBUFFER_PLANES (H, W)
    planes."""
    packed, depth = _resolve_planes(planes)
    d = planes["den"]
    covered = d > 0
    inv = torch.reciprocal(torch.where(covered, d, 1.0))
    scale = torch.where(covered, inv, 0.0)
    out = [packed, depth]
    for name, _ in _GBUF_LATCHES:
        buf = planes[name]
        out.append(_frame(buf * scale if masked_inv
                          else torch.where(covered, buf * inv, 0.0)))
    return out + [_frame(planes[name]) for name, _ in _CONSTS]


def _small_planes(counts, lists, ti, tf, width: int, height: int,
                  gbuffer: bool, depth: bool = False):
    """K1/K2g/K2d tile planes: phase 1 steps the list position k over
    max(counts) for all tiles at once, phase 2 runs the rows left in
    ``ti`` (the hierarchy's rows); the (z, row id) tie-break, or with
    ``depth`` the strict-less test in that order."""
    _check_frame(width, height)
    tiles_y, tiles_x = height // TILE_H, width // TILE_W
    num_tiles = tiles_y * tiles_x
    tie = not depth
    planes, py, px = _tile_planes(tiles_y, tiles_x, tie, ti.device, gbuffer,
                                  depth)
    lists2d = lists.reshape(num_tiles, -1)
    everything = (slice(None), slice(None))
    for k in range(int(counts.max().item())):
        rid = lists2d[:, k].long()
        ri = ti[rid].reshape(tiles_y, tiles_x, NI32)
        rf = tf[rid].reshape(tiles_y, tiles_x, NF32)
        tid = lists2d[:, k].reshape(tiles_y, tiles_x, 1, 1)
        active = (counts > k).reshape(tiles_y, tiles_x, 1, 1)
        _eval_rows(planes, everything, py, px, ri, rf, tid, active, tie)
    _scan_rows(planes, py, px, ti, tf, tie=tie)
    return planes


def raster_small_plain(counts, lists, supers, blocks, ti, tf,
                       width: int, height: int):
    """Plain torch K1 over ``prepare_binned_small``'s outputs."""
    del supers, blocks  # skip tables only; _scan_rows visits the same rows
    return _resolve_planes(
        _small_planes(counts, lists, ti, tf, width, height, False))


def gbuffer_small_plain(counts, lists, supers, blocks, ti, tf,
                        width: int, height: int):
    """Plain torch K2g: K1's traversal with the G-buffer latches."""
    del supers, blocks
    return _resolve_gbuffer(
        _small_planes(counts, lists, ti, tf, width, height, True),
        masked_inv=True)


def _hier_planes(ti, tf, width: int, height: int, gbuffer: bool,
                 depth: bool = False, row0: int = 0):
    """K3/K5/K3g/K5g/K3d tile planes (K3b: the ``height`` rows from global
    row ``row0``): rows in submission order, strict-less depth test,
    per-tile bbox masks."""
    _check_frame(width, height)
    planes, py, px = _tile_planes(height // TILE_H, width // TILE_W, False,
                                  ti.device, gbuffer, depth, row0 // TILE_H)
    _scan_rows(planes, py, px, ti, tf, tie=False, ty_base=row0 // TILE_H)
    return planes


def raster_hier_plain(supers, blocks, ti, tf, width: int, height: int):
    """Plain torch K3 (and K5) over ``prepare_raster_inputs``' outputs."""
    del supers, blocks  # skip tables only; _scan_rows visits the same rows
    return _resolve_planes(_hier_planes(ti, tf, width, height, False))


def gbuffer_hier_plain(supers, blocks, ti, tf, width: int, height: int):
    """Plain torch K3g: K3's traversal, K3g's epilogue."""
    del supers, blocks
    return _resolve_gbuffer(_hier_planes(ti, tf, width, height, True),
                            masked_inv=False)


def gbuffer_hbm_plain(supers, blocks, ti, tf, width: int, height: int):
    """Plain torch K5g: K3g's traversal, K5g's epilogue."""
    del supers, blocks
    return _resolve_gbuffer(_hier_planes(ti, tf, width, height, True),
                            masked_inv=True)


def _stream_spans(planes, py, px, offsets, bins, rec_i, rec_f,
                  masked: bool, tie: bool = True, ty_base: int = 0):
    """Each tile's record span [offsets[b], offsets[b + 1]), b = bins[ty,
    tx], stepping the span position k over all tiles at once with the
    (z, row id) tie-break (``tie``) or the strict-less test.  ``masked``:
    test each record's bbox against the tile (the coarse class; fine-list
    records always hit)."""
    start = offsets[bins].long()
    count = offsets[bins + 1].long() - start
    everything = (slice(None), slice(None))
    tiles_y, tiles_x = bins.shape
    row0 = (torch.arange(tiles_y, device=bins.device)[:, None]
            + ty_base) * TILE_H
    col0 = torch.arange(tiles_x, device=bins.device)[None, :] * TILE_W
    for k in range(int(count.max().item())):
        active = count > k
        idx = torch.where(active, start + k, 0)
        ri, rf = rec_i[idx], rec_f[idx]
        if masked:
            active = (active
                      & (ri[..., I_JMAX] >= col0)
                      & (ri[..., I_JMIN] < col0 + TILE_W)
                      & (ri[..., I_IMAX] >= row0)
                      & (ri[..., I_IMIN] < row0 + TILE_H))
        _eval_rows(planes, everything, py, px, ri, rf,
                   ri[..., NI32, None, None], active[..., None, None], tie)


def _binned_planes(offsets, rec_i, rec_f, hier, tf, coarse, width: int,
                   height: int, gbuffer: bool, depth: bool = False,
                   row0: int = 0, band_local: bool = True):
    """K4/K4c/K4g/K4d tile planes: phase 1 the tiles' record spans, phase
    1.5 (with ``coarse``) the coarse bins' spans under a per-record bbox
    test, phase 2 the rows left in ``hier``; every phase with the (z, row
    id) tie-break, or with ``depth`` the strict-less test in that order.

    K9/K9g/K9d: the ``height`` rows from global row ``row0``; the offsets
    index the band's tiles (``band_local``) or the frame's; 2-D offsets
    (n_src, band_tiles + 1) are one span list per source, streamed in
    source order (K9d)."""
    _check_frame(width, height)
    tiles_y, tiles_x = height // TILE_H, width // TILE_W
    dev = hier.device
    tie = not depth
    ty_base = row0 // TILE_H
    planes, py, px = _tile_planes(tiles_y, tiles_x, tie, dev, gbuffer, depth,
                                  ty_base)
    ty = torch.arange(tiles_y, device=dev)[:, None]
    tx = torch.arange(tiles_x, device=dev)[None, :]
    bins = (ty if band_local else ty + ty_base) * tiles_x + tx
    for offs in (offsets if offsets.ndim == 2 else offsets[None]):
        _stream_spans(planes, py, px, offs, bins, rec_i, rec_f, masked=False,
                      tie=tie, ty_base=ty_base)
    if coarse is not None:
        coffsets, crec_i, crec_f = coarse
        ctiles_x, num_cbins = _coarse_grid(tiles_x, tiles_y)
        if coffsets.shape[0] != num_cbins + 1:
            raise ValueError("coffsets do not match the coarse-bin grid")
        _stream_spans(planes, py, px, coffsets,
                      (ty // COARSE_CB) * ctiles_x + tx // COARSE_CB,
                      crec_i, crec_f, masked=True, tie=tie)
    _scan_rows(planes, py, px, hier, tf, tie=tie, ty_base=ty_base)
    return planes


def raster_binned_plain(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                        coarse, width: int, height: int):
    """Plain torch K4/K4c over ``prepare_binned_hbm_inputs``' outputs."""
    del supers, blocks  # skip tables only; _scan_rows visits the same rows
    return _resolve_planes(_binned_planes(offsets, rec_i, rec_f, hier, tf,
                                          coarse, width, height, False))


def gbuffer_binned_plain(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                         coarse, width: int, height: int):
    """Plain torch K4g: K4's traversal (no coarse class) with the G-buffer
    latches."""
    del supers, blocks
    if coarse is not None:
        raise ValueError("K4g takes no coarse class")
    return _resolve_gbuffer(_binned_planes(offsets, rec_i, rec_f, hier, tf,
                                           None, width, height, True),
                            masked_inv=True)


def raster_lists_plain(offsets, pair_tri, supers, blocks, hier, tf,
                       width: int, height: int):
    """Plain torch K6 over ``prepare_binned_inputs``' outputs: the tiles'
    row-id spans read through ``hier``/``tf`` (phase 1 has no bbox test,
    so the emptied bboxes do not matter), then the leftover rows."""
    rec_i, rec_f = _gather_records(hier, tf, pair_tri)
    return raster_binned_plain(offsets, rec_i, rec_f, supers, blocks, hier,
                               tf, None, width, height)


def gbuffer_lists_plain(offsets, pair_tri, supers, blocks, hier, tf,
                        width: int, height: int):
    """Plain torch K6g: K6's traversal with the G-buffer latches and the
    buf * where(covered, inv, 0) epilogue."""
    rec_i, rec_f = _gather_records(hier, tf, pair_tri)
    return gbuffer_binned_plain(offsets, rec_i, rec_f, supers, blocks, hier,
                                tf, None, width, height)


# Depth-only plain versions: z alone, strict-less, rows in the kernel's
# order; each returns the (H, W) f32 plane.


def depth_small_plain(counts, lists, supers, blocks, ti, tf, width: int,
                      height: int):
    """Plain torch K2d: ascending list ids, then the fan-tail hierarchy."""
    del supers, blocks
    return _frame(_small_planes(counts, lists, ti, tf, width, height, False,
                                depth=True)["z"])


def depth_hier_plain(supers, blocks, ti, tf, width: int, height: int):
    """Plain torch K3d: rows in submission order."""
    del supers, blocks
    return _frame(_hier_planes(ti, tf, width, height, False,
                               depth=True)["z"])


def depth_binned_plain(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                       coarse, width: int, height: int):
    """Plain torch K4d: the record span, then the leftovers."""
    del supers, blocks
    if coarse is not None:
        raise ValueError("K4d takes no coarse class")
    return _frame(_binned_planes(offsets, rec_i, rec_f, hier, tf, None,
                                 width, height, False, depth=True)["z"])


def depth_lists_plain(offsets, pair_tri, supers, blocks, hier, tf,
                      width: int, height: int):
    """Plain torch K6d: the pair span, then the leftovers."""
    rec_i, rec_f = _gather_records(hier, tf, pair_tri)
    return depth_binned_plain(offsets, rec_i, rec_f, supers, blocks, hier,
                              tf, None, width, height)


# The keyed body's extent and work items (csrc/raster_keyed.cuh: K4, K4c,
# K4g, K4d, K9, K9d, K6, K6g, K6d and K3, K3b, K3g, K3d, K5, K5g), for the
# bounds in chip_smoke.py and for the tests.


def vertex_bbox(ri):
    """[jmin, jmax, imin, imax] (..., 4) of setup rows ``ri`` (..., >=
    NI32): the pixels whose centres lie in [min, max] of the snapped
    vertices' x and y, unclamped.  A pixel a row covers lies in the closed
    triangle, so in this box: the keyed body's extent."""
    xs = ri[..., [I_X0, I_X1, I_X2]]
    ys = ri[..., [I_Y0, I_Y1, I_Y2]]
    half = SUBPIXEL // 2
    lo = SUBPIXEL - 1 - half
    return torch.stack([(xs.amin(-1) + lo) // SUBPIXEL,
                        (xs.amax(-1) - half) // SUBPIXEL,
                        (ys.amin(-1) + lo) // SUBPIXEL,
                        (ys.amax(-1) - half) // SUBPIXEL], dim=-1)


def keyed_work_items(offsets, item_records: int, num_supers: int,
                     coffsets=None, tiles_x: int | None = None):
    """The keyed body's work items, numbered tile by tile: (items, 7 + 2 L)
    i64 rows (tile, index, items of the tile, first record, end record,
    first superblock, end superblock, then the first and end record in
    each further list), L >= 1 further lists.  A tile's records, its span
    (2-D ``offsets`` (n_src, tiles + 1), K9d: each source's span, in source
    order) and then (K4c, given ``coffsets`` and the frame's ``tiles_x``)
    its coarse bin's records, laid end to end, are cut into pieces of at
    most ``item_records`` (one item for none), and item i of n takes
    superblocks [i * S / n, (i + 1) * S / n) of the leftover walk.  The
    first record and end record are those of the first list; the further
    lists follow in order.  With one list the further range is empty (L =
    1, as K4c's without a coarse record)."""
    offs = offsets.to(torch.int64).cpu()
    offs = offs if offs.ndim == 2 else offs[None]
    lists = [(o[:-1], o[1:] - o[:-1]) for o in offs]  # (start, count)
    if coffsets is not None:
        coffs = coffsets.to(torch.int64).cpu()
        u = torch.arange(offs.shape[1] - 1)
        ctiles_x = -(-tiles_x // COARSE_CB)
        b = (u // tiles_x // COARSE_CB) * ctiles_x + u % tiles_x // COARSE_CB
        lists.append((coffs[b], coffs[b + 1] - coffs[b]))
    total = sum(count for _, count in lists)
    n = torch.clamp_min(-(-total // item_records), 1)
    tile = torch.repeat_interleave(torch.arange(n.numel()), n)
    first = torch.cumsum(n, 0) - n
    idx = torch.arange(tile.numel()) - first[tile]
    count = n[tile]
    q = idx * item_records  # the item's first record, from each list's
    pieces = []
    for start, size in lists:
        c = size[tile]
        pieces += [start[tile] + torch.minimum(q.clamp(min=0), c),
                   start[tile] + torch.minimum((q + item_records).clamp(
                       min=0), c)]
        q = q - c
    if len(lists) == 1:
        pieces += [torch.zeros_like(tile)] * 2
    return torch.stack([tile, idx, count, *pieces[:2],
                        idx * num_supers // count,
                        (idx + 1) * num_supers // count, *pieces[2:]],
                       dim=1)


def hier_block_hits(supers, blocks, width: int, height: int,
                    row0: int = 0):
    """(tiles, B) bool: block b's bbox and its superblock's meet tile t of
    the ``height`` rows from global row ``row0`` (a band's), at any number
    of superblocks (the keyed hierarchy walk's hit blocks,
    csrc/raster_hier.cu hier_hit_words_kernel)."""
    ty, tx = height // TILE_H, width // TILE_W
    return (_tile_hits(blocks, ty, tx, row0)
            & _tile_hits(supers, ty, tx, row0).repeat_interleave(SUPER_BLOCK,
                                                                  1))


def hier_work_items(block_hits, items: int):
    """The keyed hierarchy walk's work items (K3, K3b, K3g, K3d, K5, K5g):
    (tiles, B) i64, the item of each of a tile's hit blocks
    (``block_hits``), -1 elsewhere.  A tile's H hit blocks, in row order
    over every superblock, are cut into ``items`` shares: item i takes hit
    blocks [i * H // n, (i + 1) * H // n), so hit block k falls to item
    ceil((k + 1) * n / H) - 1."""
    h = block_hits.to(torch.int64)
    rank = torch.cumsum(h, 1) - h
    total = h.sum(1, keepdim=True).clamp(min=1)
    item = ((rank + 1) * items + total - 1) // total - 1
    return torch.where(block_hits, item, -1)


def hier_hit_words(block_hits):
    """The keyed hierarchy walk's hit words (csrc/raster_hier.cu
    hier_hit_words_kernel) of the (tiles, B) ``block_hits`` of
    ``hier_block_hits``: (words (tiles, S) i64, bit j of word s set when
    block SUPER_BLOCK s + j is a hit block of the tile; before (tiles, S)
    i64, the tile's hit blocks in superblocks before s; count (tiles,) i64,
    its H)."""
    bits = block_hits.reshape(block_hits.shape[0], -1,
                              SUPER_BLOCK).to(torch.int64)
    words = (bits << torch.arange(SUPER_BLOCK, device=bits.device)).sum(-1)
    n = bits.sum(-1)
    return words, torch.cumsum(n, 1) - n, n.sum(1)


# Band plain versions: the (band_h, W) rows from global row ``row0``.


def raster_hier_band_plain(supers, blocks, ti, tf, width: int, band_h: int,
                           row0: int):
    """Plain torch K3b: K3 over one band."""
    del supers, blocks
    return _resolve_planes(_hier_planes(ti, tf, width, band_h, False,
                                        row0=row0))


def raster_binned_band_plain(offsets, rec_i, rec_f, supers, blocks, hier,
                             tf, coarse, width: int, band_h: int, row0: int,
                             band_local: bool = True):
    """Plain torch K9: K4 over one band, spans indexed by band tile
    (``band_local``) or by global tile.  Also plain K9d over
    ``prepare_binned_dist_owner``'s outputs: its (n_src, band_tiles + 1)
    offsets stream each tile's span from every source in source order."""
    del supers, blocks
    if coarse is not None:
        raise ValueError("K9 takes no coarse class")
    return _resolve_planes(_binned_planes(
        offsets, rec_i, rec_f, hier, tf, None, width, band_h, False,
        row0=row0, band_local=band_local))


def gbuffer_binned_band_plain(offsets, rec_i, rec_f, supers, blocks, hier,
                              tf, coarse, width: int, band_h: int, row0: int):
    """Plain torch K9g: K4g over one band (band-local spans)."""
    del supers, blocks
    if coarse is not None:
        raise ValueError("K9g takes no coarse class")
    return _resolve_gbuffer(_binned_planes(
        offsets, rec_i, rec_f, hier, tf, None, width, band_h, True,
        row0=row0), masked_inv=True)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster_small.cu, csrc/raster_hier.cu,
# csrc/raster_binned.cu)
# ---------------------------------------------------------------------------

_DTYPES = {"counts": I32, "lists": I32, "supers": I32, "blocks": I32,
           "ti": I32, "tf": F32, "offsets": I32, "pair_tri": I32,
           "rec_i": I32, "rec_f": F32, "coffsets": I32, "crec_i": I32,
           "crec_f": F32}


def _require_cuda(device, max_rows: int | None, **tensors):
    """Check the kernels' input contract; raise on anything else.
    ``max_rows``: the kernel's setup-row cap (None: no cap)."""
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensor on {device} expected, "
                             f"got {t.device}")
        if t.dtype != _DTYPES[name]:
            raise TypeError(f"{name}: {_DTYPES[name]} expected, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor expected")
    ti, tf = tensors["ti"], tensors["tf"]
    blocks, supers = tensors["blocks"], tensors["supers"]
    if ti.ndim != 2 or ti.shape[1] != NI32:
        raise ValueError(f"ti: (R, {NI32}) expected, got {tuple(ti.shape)}")
    rows = ti.shape[0]
    if tuple(tf.shape) != (rows, NF32):
        raise ValueError(f"tf: ({rows}, {NF32}) expected")
    if rows % RASTER_BLOCK or (max_rows is not None and rows > max_rows):
        raise ValueError(f"ti: {rows} rows; need a multiple of "
                         f"{RASTER_BLOCK}, at most {max_rows}")
    if (blocks.shape[1:] != (8,) or supers.shape[1:] != (8,)
            or blocks.shape[0] != supers.shape[0] * SUPER_BLOCK
            or blocks.shape[0] * RASTER_BLOCK < rows):
        raise ValueError("blocks/supers do not match the setup rows")


def _require_spans(offsets, bins: int, rec_i, rec_f=None):
    """Span offsets over ``bins`` bins, and records (rec_i (P, NI32 + 1),
    rec_f (P, NF32)) or row ids (rec_i (P,)) to index."""
    if tuple(offsets.shape) != (bins + 1,):
        raise ValueError(f"offsets: ({bins + 1},) expected, got "
                         f"{tuple(offsets.shape)}")
    if rec_f is None:
        if rec_i.ndim != 1:
            raise ValueError("pair_tri: 1-D row ids expected")
        return
    p = rec_i.shape[0]
    if (tuple(rec_i.shape) != (p, NI32 + 1)
            or tuple(rec_f.shape) != (p, NF32)):
        raise ValueError(f"records: ({p}, {NI32 + 1}) i32 and ({p}, {NF32}) "
                         f"f32 expected, got {tuple(rec_i.shape)} and "
                         f"{tuple(rec_f.shape)}")


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        msg = _build.load_library().zr_error_string(err).decode()
        raise RuntimeError(
            f"{fn.__name__} launch failed: CUDA error {err} ({msg})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _run(fn, dev, width: int, height: int, *args):
    """Allocate the (color, depth) planes and launch
    ``fn(*args, color, depth, height, width, stream)`` on the current
    stream of ``dev``."""
    color = torch.empty((height, width), dtype=I32, device=dev)
    depth = torch.empty((height, width), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, *args, _ptr(color), _ptr(depth), height, width,
                ctypes.c_void_p(stream))
    return color, depth


def _small_args(counts, lists, supers, blocks, ti, tf, width: int,
                height: int):
    """Check K1/K2g inputs; returns the launch arguments before the
    outputs."""
    _check_frame(width, height)
    _require_cuda(ti.device, MAX_RESIDENT_ROWS, counts=counts, lists=lists,
                  supers=supers, blocks=blocks, ti=ti, tf=tf)
    num_tiles = (height // TILE_H) * (width // TILE_W)
    if counts.shape != (num_tiles,) or lists.numel() % num_tiles:
        raise ValueError("counts/lists do not match the tile grid")
    n_head = lists.numel() // num_tiles
    if n_head > SMALL_BIN_MAX_ROWS or n_head > ti.shape[0]:
        raise ValueError(f"n_head {n_head} > {SMALL_BIN_MAX_ROWS} or rows")
    return (_ptr(counts), _ptr(lists), n_head, _ptr(supers), supers.shape[0],
            _ptr(blocks), _ptr(ti), _ptr(tf))


def _run_gbuffer(fn, dev, width: int, height: int, *args):
    """Allocate the G-buffer as one (GBUFFER_PLANES, H, W) f32 block and
    launch ``fn(*args, out, height, width, stream)``; returns its planes,
    the packed color plane viewed as int32."""
    out = torch.empty((GBUFFER_PLANES, height, width), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, *args, _ptr(out), height, width, ctypes.c_void_p(stream))
    return [out[0].view(I32), *out[1:]]


def raster_small_kernel(counts, lists, supers, blocks, ti, tf,
                        width: int, height: int):
    """Launch K1 (``csrc/raster_small.cu``) on the current stream."""
    args = _small_args(counts, lists, supers, blocks, ti, tf, width, height)
    out = _run(_build.load_library().zr_raster_small, ti.device, width,
               height, *args)
    raster_small_kernel.launches += 1
    return out


def gbuffer_small_kernel(counts, lists, supers, blocks, ti, tf,
                         width: int, height: int):
    """Launch K2g (``csrc/raster_small.cu``) on the current stream; returns
    the GBUFFER_PLANES planes."""
    args = _small_args(counts, lists, supers, blocks, ti, tf, width, height)
    out = _run_gbuffer(_build.load_library().zr_gbuffer_small, ti.device,
                       width, height, *args)
    gbuffer_small_kernel.launches += 1
    return out


def _hier_args(supers, blocks, ti, tf, width: int, height: int,
               max_rows: int | None):
    _check_frame(width, height)
    _require_cuda(ti.device, max_rows, supers=supers, blocks=blocks, ti=ti,
                  tf=tf)
    return (_ptr(supers), supers.shape[0], _ptr(blocks), _ptr(ti), _ptr(tf))


def raster_hier_kernel(supers, blocks, ti, tf, width: int, height: int):
    """Launch K3 (``csrc/raster_hier.cu``, the keyed body over the
    hierarchy in HIER_ITEMS work items a tile) on the current stream."""
    args, _scratch = _keyed_hier_args(supers, blocks, ti, tf, width, height)
    out = _run(_build.load_library().zr_raster_hier_keyed, ti.device, width,
               height, *args)
    raster_hier_kernel.launches += 1
    return out


def raster_hbm_kernel(supers, blocks, ti, tf, width: int, height: int):
    """Launch K5 (``csrc/raster_hier.cu``, K3's keyed body) over any
    number of setup rows on the current stream."""
    args, _scratch = _keyed_hier_args(supers, blocks, ti, tf, width, height,
                                      max_rows=None)
    out = _run(_build.load_library().zr_raster_hier, ti.device, width,
               height, *args)
    raster_hbm_kernel.launches += 1
    return out


def _keyed_hier_args(supers, blocks, ti, tf, width: int, height: int,
                     max_rows: int | None = MAX_RESIDENT_ROWS):
    """Check K3/K3b/K3g/K3d/K5/K5g inputs (``height``: the output's rows, a
    band's for K3b; ``max_rows`` None for K3b, K5 and K5g); returns the
    launch arguments before the outputs (the hierarchy's, the item count
    HIER_ITEMS, the hit-word buffer, the key plane of the output's size or
    NULL with one item a tile) and the buffer and plane, which the call
    must hold until it has launched.  The buffer holds each tile's hit word
    and hit-block count before each superblock, then each tile's count
    (csrc/raster_hier.cu HitWords)."""
    args = _hier_args(supers, blocks, ti, tf, width, height, max_rows)
    items = HIER_ITEMS
    if items < 1:
        raise ValueError(f"HIER_ITEMS must be positive, got {items}")
    tiles = (height // TILE_H) * (width // TILE_W)
    buf = torch.empty(tiles * (2 * supers.shape[0] + 1), dtype=I32,
                      device=ti.device)
    plane = None
    if items > 1:  # freed after the launch, as _keyed_launch's plane
        plane = torch.empty(height * width, dtype=torch.int64,
                            device=ti.device)
    return ((*args, items, _ptr(buf),
             None if plane is None else _ptr(plane)), (buf, plane))


def gbuffer_hier_kernel(supers, blocks, ti, tf, width: int, height: int):
    """Launch K3g (``csrc/raster_hier.cu``, the keyed body over the
    hierarchy in HIER_ITEMS work items a tile) on the current stream."""
    args, _scratch = _keyed_hier_args(supers, blocks, ti, tf, width, height)
    out = _run_gbuffer(_build.load_library().zr_gbuffer_hier, ti.device,
                       width, height, *args)
    gbuffer_hier_kernel.launches += 1
    return out


def gbuffer_hbm_kernel(supers, blocks, ti, tf, width: int, height: int):
    """Launch K5g (``csrc/raster_hier.cu``, K5's walk with K5g's epilogue,
    no row cap) on the current stream; returns the GBUFFER_PLANES
    planes."""
    args, _scratch = _keyed_hier_args(supers, blocks, ti, tf, width, height,
                                      max_rows=None)
    out = _run_gbuffer(_build.load_library().zr_gbuffer_hbm, ti.device,
                       width, height, *args)
    gbuffer_hbm_kernel.launches += 1
    return out


def _records_args(offsets, rec_i, rec_f, supers, blocks, hier, tf, coarse,
                  width: int, height: int):
    """Check K4/K4c/K4g inputs; returns the launch arguments before the
    outputs (the coarse pointers None without ``coarse``)."""
    _check_frame(width, height)
    tiles_x, tiles_y = width // TILE_W, height // TILE_H
    tensors = dict(offsets=offsets, rec_i=rec_i, rec_f=rec_f, supers=supers,
                   blocks=blocks, ti=hier, tf=tf)
    _require_spans(offsets, tiles_x * tiles_y, rec_i, rec_f)
    cptrs = (None, None, None)
    if coarse is not None:
        coffsets, crec_i, crec_f = coarse
        tensors.update(coffsets=coffsets, crec_i=crec_i, crec_f=crec_f)
        _require_spans(coffsets, _coarse_grid(tiles_x, tiles_y)[1], crec_i,
                       crec_f)
        cptrs = (_ptr(coffsets), _ptr(crec_i), _ptr(crec_f))
    _require_cuda(hier.device, None, **tensors)
    return (_ptr(offsets), _ptr(rec_i), _ptr(rec_f), *cptrs, _ptr(supers),
            supers.shape[0], _ptr(blocks), _ptr(hier), _ptr(tf))


def keyed_item_records(records: int, tiles: int, item_records: int,
                       min_items: int) -> int:
    """The keyed record kernels' item size (csrc/raster_binned.cu
    ``item_size``): ``item_records`` halved while it stays even and at
    least MIN_ITEM_RECORDS and ``tiles`` plus ``records`` / size (a bound
    on the items; ``records``: the lists' records, a coarse bin's counted
    COARSE_CB**2 times) stays under ``min_items``."""
    size = item_records
    while (size % 2 == 0 and size // 2 >= MIN_ITEM_RECORDS
           and tiles + records // size < min_items):
        size //= 2
    return size


def keyed_items(width: int, height: int, records: int, item_records: int,
                coarse_records: int = 0, min_items: int = 0) -> int:
    """Blocks of a keyed K4/K4c/K4g/K4d/K9/K9d/K6/K6g/K6d launch over the
    ``height`` rows of its output: a bound on the work items, one per tile
    plus one per ``item_records`` records (``tile_items``).  A tile's
    records are its spans (K9d: every source's; the spans of all tiles lie
    in ``records``, the record buffer's or row-id list's length) and, for
    K4c, its coarse bin's; a bin serves at most COARSE_CB**2 tiles, so the
    tiles read at most that many times ``coarse_records``.  With
    ``min_items`` the kernel may halve the item size
    (``keyed_item_records``); it does so only while a tile plus one item
    per size's records stay under ``min_items``, so then under
    2 ``min_items`` items.  Sizes alone: no host sync (the kernel's blocks
    past the bound its lists' ends give return at once:
    csrc/raster_binned.cu item_bound)."""
    return max((width // TILE_W) * (height // TILE_H)
               + -(-(records + COARSE_CB**2 * coarse_records)
                   // item_records), 2 * min_items)


def _keyed_launch(device, width: int, height: int, records: int,
                  coarse_records: int = 0):
    """The keyed record launches' (K4, K4c, K4g, K4d, K9, K9d, K6, K6g,
    K6d) last arguments before the outputs: the largest item ITEM_RECORDS
    and the items KEYED_MIN_ITEMS the kernel's item size aims at (both
    read at call time), the grid and the key plane of the ``height`` rows;
    and the plane, which the call must hold until it has launched."""
    item_records, min_items = ITEM_RECORDS, KEYED_MIN_ITEMS
    if item_records < 1 or min_items < 0:
        raise ValueError(f"ITEM_RECORDS {item_records} must be positive, "
                         f"KEYED_MIN_ITEMS {min_items} not negative")
    items = keyed_items(width, height, records, item_records, coarse_records,
                        min_items)
    # Freed after the launch: the caching allocator hands the memory to
    # later work on the same stream only, which runs after both kernels.
    plane = torch.empty(height * width, dtype=torch.int64, device=device)
    return (item_records, min_items, items, _ptr(plane)), plane


def _keyed_args(offsets, rec_i, rec_f, supers, blocks, hier, tf, coarse,
                width: int, height: int):
    """Check K4/K4c/K4g/K4d inputs; returns the launch arguments before the
    outputs (the records' arguments, K4c's coarse class among them, then
    ``_keyed_launch``'s) and the key plane, which the call must hold until
    it has launched."""
    args = _records_args(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                         coarse, width, height)
    if coarse is None:
        args = (*args[:3], *args[6:])
    launch, plane = _keyed_launch(
        hier.device, width, height, rec_i.shape[0],
        0 if coarse is None else coarse[1].shape[0])
    return (*args, *launch), plane


def raster_binned_kernel(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                         coarse, width: int, height: int):
    """Launch K4 (``csrc/raster_binned.cu``, the keyed body over record
    spans: work items of at most ITEM_RECORDS records, then the resolve)
    on the current stream; ``coarse`` must be None (K4c takes the
    coarse class)."""
    if coarse is not None:
        raise ValueError("K4 takes no coarse class; use "
                         "raster_binned_coarse_kernel")
    args, _plane = _keyed_args(offsets, rec_i, rec_f, supers, blocks, hier,
                                tf, None, width, height)
    out = _run(_build.load_library().zr_raster_records_keyed, hier.device,
               width, height, *args)
    raster_binned_kernel.launches += 1
    return out


def raster_binned_coarse_kernel(offsets, rec_i, rec_f, supers, blocks, hier,
                                tf, coarse, width: int, height: int):
    """Launch K4c (``csrc/raster_binned.cu``, K4's keyed body over each
    tile's record span and then its bin's records of the coarse class
    ``coarse`` = (coffsets, crec_i, crec_f), in work items of at most
    ITEM_RECORDS records, then the resolve) on the current stream."""
    if coarse is None:
        raise ValueError("K4c needs the coarse class (coffsets, crec_i, "
                         "crec_f)")
    args, _plane = _keyed_args(offsets, rec_i, rec_f, supers, blocks, hier,
                                tf, coarse, width, height)
    out = _run(_build.load_library().zr_raster_records, hier.device, width,
               height, *args)
    raster_binned_coarse_kernel.launches += 1
    return out


def raster_lists_kernel(offsets, pair_tri, supers, blocks, hier, tf,
                        width: int, height: int):
    """Launch K6 (``csrc/raster_binned.cu``, K4's keyed body over row-id
    spans: each listed row gathered from ``hier``/``tf`` by its id, in
    work items of at most ITEM_RECORDS entries, then the resolve) on the
    current stream."""
    args, _plane = _lists_args(offsets, pair_tri, supers, blocks, hier, tf,
                               width, height)
    out = _run(_build.load_library().zr_raster_lists, hier.device, width,
               height, *args)
    raster_lists_kernel.launches += 1
    return out


def gbuffer_binned_kernel(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                          coarse, width: int, height: int):
    """Launch K4g (``csrc/raster_binned.cu``, the keyed body over record
    spans with the G-buffer resolve) on the current stream; ``coarse``
    must be None."""
    if coarse is not None:
        raise ValueError("K4g takes no coarse class")
    args, _plane = _keyed_args(offsets, rec_i, rec_f, supers, blocks, hier,
                                tf, None, width, height)
    out = _run_gbuffer(_build.load_library().zr_gbuffer_records_keyed,
                       hier.device, width, height, *args)
    gbuffer_binned_kernel.launches += 1
    return out


def _lists_args(offsets, pair_tri, supers, blocks, hier, tf, width: int,
                height: int):
    """Check K6/K6g/K6d inputs; returns the launch arguments before the
    outputs (the lists' arguments, then ``_keyed_launch``'s over
    ``pair_tri``'s slots) and the key plane, which the call must hold until
    it has launched."""
    _check_frame(width, height)
    _require_spans(offsets, (width // TILE_W) * (height // TILE_H), pair_tri)
    _require_cuda(hier.device, None, offsets=offsets, pair_tri=pair_tri,
                  supers=supers, blocks=blocks, ti=hier, tf=tf)
    launch, plane = _keyed_launch(hier.device, width, height,
                                  pair_tri.shape[0])
    return (_ptr(offsets), _ptr(pair_tri), _ptr(supers), supers.shape[0],
            _ptr(blocks), _ptr(hier), _ptr(tf), *launch), plane


def gbuffer_lists_kernel(offsets, pair_tri, supers, blocks, hier, tf,
                         width: int, height: int):
    """Launch K6g (``csrc/raster_binned.cu``, K4g's keyed body over row-id
    spans, as K6's, with the G-buffer resolve) on the current stream."""
    args, _plane = _lists_args(offsets, pair_tri, supers, blocks, hier, tf,
                               width, height)
    out = _run_gbuffer(_build.load_library().zr_gbuffer_lists, hier.device,
                       width, height, *args)
    gbuffer_lists_kernel.launches += 1
    return out


def _run_depth(fn, dev, width: int, height: int, *args):
    """Allocate the (H, W) f32 depth plane and launch ``fn(*args, depth,
    height, width, stream)`` on the current stream of ``dev``."""
    depth = torch.empty((height, width), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, *args, _ptr(depth), height, width,
                ctypes.c_void_p(stream))
    return depth


def depth_small_kernel(counts, lists, supers, blocks, ti, tf, width: int,
                       height: int):
    """Launch K2d (``csrc/raster_small.cu``) on the current stream;
    returns the f32 depth plane."""
    args = _small_args(counts, lists, supers, blocks, ti, tf, width, height)
    out = _run_depth(_build.load_library().zr_depth_small, ti.device, width,
                     height, *args)
    depth_small_kernel.launches += 1
    return out


def depth_hier_kernel(supers, blocks, ti, tf, width: int, height: int):
    """Launch K3d (``csrc/raster_hier.cu``, the keyed body over the
    hierarchy in HIER_ITEMS work items a tile) on the current stream."""
    args, _scratch = _keyed_hier_args(supers, blocks, ti, tf, width, height)
    out = _run_depth(_build.load_library().zr_depth_hier, ti.device, width,
                     height, *args)
    depth_hier_kernel.launches += 1
    return out


def depth_binned_kernel(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                        coarse, width: int, height: int):
    """Launch K4d (``csrc/raster_binned.cu``, the keyed body over record
    spans, depth only) on the current stream; ``coarse`` must be None."""
    if coarse is not None:
        raise ValueError("K4d takes no coarse class")
    args, _plane = _keyed_args(offsets, rec_i, rec_f, supers, blocks, hier,
                                tf, None, width, height)
    out = _run_depth(_build.load_library().zr_depth_records_keyed,
                     hier.device, width, height, *args)
    depth_binned_kernel.launches += 1
    return out


def depth_lists_kernel(offsets, pair_tri, supers, blocks, hier, tf,
                       width: int, height: int):
    """Launch K6d (``csrc/raster_binned.cu``, K4d's keyed body over row-id
    spans: each listed row gathered from ``hier``/``tf`` by its id, in
    work items of at most ITEM_RECORDS entries, then the resolve) on the
    current stream."""
    args, _plane = _lists_args(offsets, pair_tri, supers, blocks, hier, tf,
                               width, height)
    out = _run_depth(_build.load_library().zr_depth_lists, hier.device,
                     width, height, *args)
    depth_lists_kernel.launches += 1
    return out


def _check_band(width: int, band_h: int, row0: int,
                full_height: int | None = None):
    """A band of ``band_h`` rows from global row ``row0``: tile-aligned
    and, with ``full_height``, inside the frame."""
    _check_frame(width, band_h)
    if row0 < 0 or row0 % TILE_H or (full_height is not None and (
            full_height % TILE_H or row0 + band_h > full_height)):
        raise ValueError(f"band of {band_h} rows at row {row0}: a multiple "
                         f"of {TILE_H} inside the {full_height}-row frame")


def _run_band(fn, dev, width: int, band_h: int, row0: int, *args,
              gbuffer: bool = False, extra=()):
    """Allocate a band's (color, depth) planes, or its GBUFFER_PLANES
    planes, and launch ``fn(*args, outputs..., band_h, width, row0,
    *extra, stream)`` on the current stream of ``dev``."""
    if gbuffer:
        outs = [torch.empty((GBUFFER_PLANES, band_h, width), dtype=F32,
                            device=dev)]
    else:
        outs = [torch.empty((band_h, width), dtype=I32, device=dev),
                torch.empty((band_h, width), dtype=F32, device=dev)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, *args, *(_ptr(t) for t in outs), band_h, width, row0,
                *extra, ctypes.c_void_p(stream))
    if gbuffer:
        return [outs[0][0].view(I32), *outs[0][1:]]
    return tuple(outs)


def raster_hier_band_kernel(supers, blocks, ti, tf, width: int, band_h: int,
                            row0: int):
    """Launch K3b (``csrc/raster_hier.cu``, K3's keyed body over the
    ``band_h`` rows from global row ``row0``, a band-sized key plane) at
    any row count (like K5); returns the band's (color, depth)."""
    _check_band(width, band_h, row0)
    args, _scratch = _keyed_hier_args(supers, blocks, ti, tf, width, band_h,
                                      None)
    out = _run_band(_build.load_library().zr_raster_hier_band_keyed,
                    ti.device, width, band_h, row0, *args)
    raster_hier_band_kernel.launches += 1
    return out


def _band_records_args(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                       coarse, width: int, band_h: int, row0: int,
                       band_local: bool = True):
    """Check K9/K9g/K9d inputs; returns the launch arguments before the
    outputs.  ``offsets``: (band_tiles + 1,) band-local spans, with
    ``band_local=False`` (tiles_x * tiles_y + 1,) spans of a frame that
    holds the band, or (n_src, band_tiles + 1) spans per source (K9d)."""
    _check_band(width, band_h, row0)
    if coarse is not None:
        raise ValueError("the band kernels take no coarse class")
    tiles_x = width // TILE_W
    band_tiles = tiles_x * (band_h // TILE_H)
    if offsets.ndim == 2:
        if offsets.shape[1] != band_tiles + 1:
            raise ValueError(f"offsets: (n_src, {band_tiles + 1}) expected, "
                             f"got {tuple(offsets.shape)}")
        _require_spans(offsets[0], band_tiles, rec_i, rec_f)
    elif band_local:
        _require_spans(offsets, band_tiles, rec_i, rec_f)
    else:
        bins = offsets.shape[0] - 1
        if bins % tiles_x or bins < (row0 + band_h) // TILE_H * tiles_x:
            raise ValueError(f"offsets: {bins} tiles do not hold the band "
                             f"of {band_h} rows at row {row0}")
        _require_spans(offsets, bins, rec_i, rec_f)
    _require_cuda(hier.device, None, offsets=offsets, rec_i=rec_i,
                  rec_f=rec_f, supers=supers, blocks=blocks, ti=hier, tf=tf)
    return (_ptr(offsets), _ptr(rec_i), _ptr(rec_f), _ptr(supers),
            supers.shape[0], _ptr(blocks), _ptr(hier), _ptr(tf))


def raster_binned_band_kernel(offsets, rec_i, rec_f, supers, blocks, hier,
                              tf, coarse, width: int, band_h: int, row0: int,
                              band_local: bool = True):
    """Launch K9 (``csrc/raster_binned.cu``): K4's keyed body over the
    ``band_h`` rows from global row ``row0`` with a band-sized key plane,
    the spans indexed by band tile (``band_local``) or by global tile."""
    if offsets.ndim != 1:
        raise ValueError("K9 takes one span list; K9d takes one per source")
    args = _band_records_args(offsets, rec_i, rec_f, supers, blocks, hier,
                              tf, coarse, width, band_h, row0, band_local)
    launch, _plane = _keyed_launch(hier.device, width, band_h,
                                   rec_i.shape[0])
    out = _run_band(_build.load_library().zr_raster_records_band,
                    hier.device, width, band_h, row0, *args, *launch,
                    extra=(int(band_local),))
    raster_binned_band_kernel.launches += 1
    return out


def gbuffer_binned_band_kernel(offsets, rec_i, rec_f, supers, blocks, hier,
                               tf, coarse, width: int, band_h: int,
                               row0: int):
    """Launch K9g (``csrc/raster_binned.cu``): K4g over one band
    (band-local spans); returns the GBUFFER_PLANES (band_h, W) planes."""
    if offsets.ndim != 1:
        raise ValueError("K9g takes one span list")
    args = _band_records_args(offsets, rec_i, rec_f, supers, blocks, hier,
                              tf, coarse, width, band_h, row0)
    out = _run_band(_build.load_library().zr_gbuffer_records_band,
                    hier.device, width, band_h, row0, *args, gbuffer=True)
    gbuffer_binned_band_kernel.launches += 1
    return out


def raster_binned_band_dist_kernel(offsets, rec_i, rec_f, supers, blocks,
                                   hier, tf, coarse, width: int, band_h: int,
                                   row0: int):
    """Launch K9d (``csrc/raster_binned.cu``, K9's keyed body) over
    ``prepare_binned_dist_owner``'s outputs: each tile's spans of every
    source laid end to end, cut into work items of at most ITEM_RECORDS
    records, then the leftover hierarchy and the resolve."""
    if offsets.ndim != 2:
        raise ValueError("K9d takes (n_src, band_tiles + 1) offsets")
    args = _band_records_args(offsets, rec_i, rec_f, supers, blocks, hier,
                              tf, coarse, width, band_h, row0)
    launch, _plane = _keyed_launch(hier.device, width, band_h,
                                   rec_i.shape[0])
    out = _run_band(_build.load_library().zr_raster_records_dist,
                    hier.device, width, band_h, row0, *args, *launch,
                    extra=(offsets.shape[0],))
    raster_binned_band_dist_kernel.launches += 1
    return out


KERNELS = (raster_small_kernel, raster_hier_kernel, raster_hbm_kernel,
           raster_binned_kernel, raster_binned_coarse_kernel,
           raster_lists_kernel)
GBUFFER_KERNELS = (gbuffer_small_kernel, gbuffer_hier_kernel,
                   gbuffer_binned_kernel, gbuffer_hbm_kernel,
                   gbuffer_lists_kernel)
DEPTH_KERNELS = (depth_small_kernel, depth_hier_kernel, depth_binned_kernel,
                 depth_lists_kernel)
BAND_KERNELS = (raster_hier_band_kernel, raster_binned_band_kernel,
                gbuffer_binned_band_kernel, raster_binned_band_dist_kernel)
for _kernel in KERNELS + GBUFFER_KERNELS + DEPTH_KERNELS + BAND_KERNELS:
    _kernel.launches = 0
del _kernel


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def rasterize_setup_small(tri_i32, tri_f32, width: int, height: int):
    """K1 wrapper: ``prepare_binned_small`` then the kernel (CUDA tensors)
    or its plain version (CPU tensors).  Returns (packed i32, depth f32)
    over the (height, width) padded frame."""
    _check_frame(width, height)
    prepared = prepare_binned_small(tri_i32, tri_f32, width, height)
    if _on_cpu(tri_i32):
        return raster_small_plain(*prepared, width, height)
    return raster_small_kernel(*prepared, width, height)


def rasterize_setup(tri_i32, tri_f32, width: int, height: int):
    """K3 wrapper: ``prepare_raster_inputs`` then the kernel (CUDA tensors)
    or its plain version (CPU tensors)."""
    _check_frame(width, height)
    prepared = prepare_raster_inputs(tri_i32, tri_f32)
    if _on_cpu(tri_i32):
        return raster_hier_plain(*prepared, width, height)
    return raster_hier_kernel(*prepared, width, height)


def rasterize_setup_hbm(tri_i32, tri_f32, width: int, height: int):
    """K5 wrapper: ``prepare_raster_inputs`` (compacted) then the streamed
    hierarchy, at any number of setup rows."""
    _check_frame(width, height)
    prepared = prepare_raster_inputs(tri_i32, tri_f32)
    if _on_cpu(tri_i32):
        return raster_hier_plain(*prepared, width, height)
    return raster_hbm_kernel(*prepared, width, height)


def rasterize_setup_binned_hbm(tri_i32, tri_f32, width: int, height: int,
                               cap: int | None = None,
                               pair_budget: int | None = None,
                               coarse_cap: int | None = None,
                               coarse_budget: int | None = None):
    """K4 wrapper (K4c with ``coarse_cap``): ``prepare_binned_hbm_inputs``
    then the kernel (CUDA tensors) or its plain version (CPU tensors)."""
    _check_frame(width, height)
    prepared = prepare_binned_hbm_inputs(
        tri_i32, tri_f32, width, height, cap=cap, pair_budget=pair_budget,
        coarse_cap=coarse_cap, coarse_budget=coarse_budget)
    if _on_cpu(tri_i32):
        return raster_binned_plain(*prepared, width, height)
    if coarse_cap is None:
        return raster_binned_kernel(*prepared, width, height)
    return raster_binned_coarse_kernel(*prepared, width, height)


def rasterize_setup_binned_hbm_coarse(tri_i32, tri_f32, width: int,
                                      height: int):
    """K4c as the tile_lists dispatch calls it: the coarse class with
    ``coarse_cap = TILE_LISTS_COARSE_CAP``."""
    return rasterize_setup_binned_hbm(tri_i32, tri_f32, width, height,
                                      coarse_cap=TILE_LISTS_COARSE_CAP)


def rasterize_setup_binned(tri_i32, tri_f32, width: int, height: int,
                           cap: int | None = None):
    """K6 wrapper: ``prepare_binned_inputs`` then the kernel (CUDA tensors)
    or its plain version (CPU tensors)."""
    _check_frame(width, height)
    prepared = prepare_binned_inputs(tri_i32, tri_f32, width, height, cap=cap)
    if _on_cpu(tri_i32):
        return raster_lists_plain(*prepared, width, height)
    return raster_lists_kernel(*prepared, width, height)


def unpack_rgba8(packed):
    """(H, W) i32 packed RGBA8 -> (H, W, 4) u8 (channel order r, g, b, a)."""
    return torch.stack(
        [(packed >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1
    ).to(torch.uint8)


def select_raster(binning: str, rows: int):
    """The dispatch of ``render_frame_pallas``, branch for branch: returns
    the wrapper that rasterizes a frame of ``rows`` setup rows.

    * ``tile_lists``: K4c above MAX_RESIDENT_ROWS rows, else K6;
    * above MAX_RESIDENT_ROWS rows: K5 for ``hierarchy``, else K4;
    * below: K1 for ``small``, and for ``auto`` up to SMALL_BIN_MAX_ROWS
      head rows; K3 otherwise."""
    if binning not in BINNINGS:
        raise ValueError(f"unknown binning {binning!r}; one of {BINNINGS}")
    big = rows > MAX_RESIDENT_ROWS
    if binning == "tile_lists":
        return (rasterize_setup_binned_hbm_coarse if big
                else rasterize_setup_binned)
    if big:
        return (rasterize_setup_hbm if binning == "hierarchy"
                else rasterize_setup_binned_hbm)
    if binning == "small" or (
            binning == "auto" and head_count(rows) <= SMALL_BIN_MAX_ROWS):
        return rasterize_setup_small
    return rasterize_setup


def cull_meshlets(tri_i32, matrices, meshlet_cull):
    """Kill the head rows of the meshlets that ``meshlet_keep_mask``
    culls (``kill_rows``), as ``render_frame_pallas`` does before its
    dispatch.  ``meshlet_cull``: (bounds (M, 8), mdraw (M,), enabled (M,),
    cam_local (D, 4)) on the rows' device.  The M * RASTER_BLOCK head rows
    lie first, in triangle order (``geometry_pipeline``'s layout); the fan
    rows after them stay."""
    bounds, mdraw, enabled, cam_local = meshlet_cull
    keep = tg.meshlet_keep_mask(bounds, mdraw, enabled, matrices, cam_local)
    n_tris = keep.shape[0] * RASTER_BLOCK
    if n_tris != head_count(tri_i32.shape[0]):
        raise ValueError(f"{keep.shape[0]} meshlets of {RASTER_BLOCK} rows "
                         f"for a frame of {head_count(tri_i32.shape[0])} "
                         "head rows")
    kill = torch.cat([
        torch.repeat_interleave(~keep, RASTER_BLOCK),
        torch.zeros(tri_i32.shape[0] - n_tris, dtype=torch.bool,
                    device=tri_i32.device),
    ])
    return kill_rows(tri_i32, kill)


def _flat_dispatch(tri_i32, tri_f32, matrices, height: int, width: int,
                   pad_height: int, pad_width: int, binning: str,
                   raw_packed: bool, meshlet_cull):
    """The flat frame after its geometry: the meshlet cull, the raster
    dispatch over the padded target, the crop."""
    if meshlet_cull is not None:
        tri_i32 = cull_meshlets(tri_i32, matrices, meshlet_cull)
    raster = select_raster(binning, tri_i32.shape[0])
    color, depth = raster(tri_i32, tri_f32, pad_width, pad_height)
    if raw_packed:
        return color, depth
    return color[:height, :width], depth[:height, :width]


def render_frame(ccols, tri_node, matrices, width: int, height: int,
                 pad_height: int, pad_width: int, binning: str = "auto",
                 raw_packed: bool = False, meshlet_cull=None):
    """Full flat frame: column geometry at the true (width, height)
    viewport, then the raster kernel over the padded target.
    ``meshlet_cull``: None, or (bounds, mdraw, enabled, cam_local) to kill
    the rows of culled meshlets first (``cull_meshlets``).

    Returns (packed (height, width) i32, depth f32), cropped; with
    ``raw_packed`` the padded planes as the kernel wrote them.
    """
    tri_i32, tri_f32 = tg.geometry_pipeline_cols(
        ccols, tri_node, matrices, width, height)
    return _flat_dispatch(tri_i32, tri_f32, matrices, height, width,
                          pad_height, pad_width, binning, raw_packed,
                          meshlet_cull)


def render_frame_indexed(positions, attrs, tri_vidx, vert_node, matrices,
                         width: int, height: int, pad_height: int,
                         pad_width: int, binning: str = "auto",
                         vertex_shader=None, raw_packed: bool = False,
                         meshlet_cull=None):
    """``render_frame`` from the indexed buffers (per-vertex positions
    (N, 4) and attrs (N, 12), ``tri_vidx`` (T, 3), ``vert_node`` (N,)):
    the indexed geometry stage with the optional vertex shader
    (``geometry_pipeline``), then the same cull, dispatch and crop.  The
    path of ``render_frame_pallas`` with a shader bound, and of the mesh
    pipeline's generated geometry."""
    tri_i32, tri_f32 = tg.geometry_pipeline(
        positions, attrs, tri_vidx, matrices, vert_node, width, height,
        vertex_shader=vertex_shader)
    return _flat_dispatch(tri_i32, tri_f32, matrices, height, width,
                          pad_height, pad_width, binning, raw_packed,
                          meshlet_cull)


def ssaa_resolve(color_u8, depth, s: int):
    """Ordered-grid supersample resolve of an (s*H, s*W, 4) u8 frame and
    its depth to (H, W): the box sum of each s x s block with round-half-up
    ((sum + s*s // 2) // (s*s), integer), depth the block's minimum (the
    reference's ``raster_xla.ssaa_resolve``; plain torch ops)."""
    h2, w2 = depth.shape
    h, w = h2 // s, w2 // s
    c = color_u8.to(torch.int32).reshape(h, s, w, s, 4)
    csum = c.sum(dim=(1, 3), dtype=torch.int32)
    n = s * s
    out = torch.div(csum + n // 2, n, rounding_mode="floor").to(torch.uint8)
    d = depth.reshape(h, s, w, s).amin(dim=(1, 3))
    return out, d


# ---------------------------------------------------------------------------
# G-buffer raster (the lit pipelines' first pass)
# ---------------------------------------------------------------------------


def rasterize_gbuffer_small(tri_i32, tri_f32, width: int, height: int):
    """K2g wrapper: ``prepare_binned_small`` then the kernel (CUDA tensors)
    or its plain version (CPU tensors).  Returns the GBUFFER_PLANES
    (height, width) padded planes."""
    _check_frame(width, height)
    prepared = prepare_binned_small(tri_i32, tri_f32, width, height)
    if _on_cpu(tri_i32):
        return gbuffer_small_plain(*prepared, width, height)
    return gbuffer_small_kernel(*prepared, width, height)


def rasterize_gbuffer(tri_i32, tri_f32, width: int, height: int):
    """K3g wrapper: ``prepare_raster_inputs`` then the kernel or its plain
    version."""
    _check_frame(width, height)
    prepared = prepare_raster_inputs(tri_i32, tri_f32)
    if _on_cpu(tri_i32):
        return gbuffer_hier_plain(*prepared, width, height)
    return gbuffer_hier_kernel(*prepared, width, height)


def rasterize_gbuffer_hbm(tri_i32, tri_f32, width: int, height: int):
    """K5g wrapper: ``prepare_raster_inputs`` then the streamed hierarchy
    G-buffer, at any number of setup rows."""
    _check_frame(width, height)
    prepared = prepare_raster_inputs(tri_i32, tri_f32)
    if _on_cpu(tri_i32):
        return gbuffer_hbm_plain(*prepared, width, height)
    return gbuffer_hbm_kernel(*prepared, width, height)


def rasterize_gbuffer_binned_hbm(tri_i32, tri_f32, width: int, height: int,
                                 cap: int | None = None,
                                 pair_budget: int | None = None):
    """K4g wrapper: ``prepare_binned_hbm_inputs`` (no coarse class) then
    the kernel or its plain version."""
    _check_frame(width, height)
    prepared = prepare_binned_hbm_inputs(tri_i32, tri_f32, width, height,
                                         cap=cap, pair_budget=pair_budget)
    if _on_cpu(tri_i32):
        return gbuffer_binned_plain(*prepared, width, height)
    return gbuffer_binned_kernel(*prepared, width, height)


def rasterize_gbuffer_binned(tri_i32, tri_f32, width: int, height: int,
                             cap: int | None = None):
    """K6g wrapper: ``prepare_binned_inputs`` then the kernel or its plain
    version."""
    _check_frame(width, height)
    prepared = prepare_binned_inputs(tri_i32, tri_f32, width, height, cap=cap)
    if _on_cpu(tri_i32):
        return gbuffer_lists_plain(*prepared, width, height)
    return gbuffer_lists_kernel(*prepared, width, height)


def select_gbuffer_raster(binning: str, rows: int):
    """The dispatch of ``render_gbuffer_pallas``, branch for branch (not
    the flat one): returns the wrapper that rasterizes a G-buffer of
    ``rows`` setup rows.

    * ``tile_lists``: K4g without the coarse class above MAX_RESIDENT_ROWS
      rows; below, K6g;
    * above MAX_RESIDENT_ROWS rows: K5g for ``hierarchy``, else K4g;
    * below: K2g for ``small``, and for ``auto`` up to SMALL_BIN_MAX_ROWS
      head rows; K3g otherwise."""
    if binning not in BINNINGS:
        raise ValueError(f"unknown binning {binning!r}; one of {BINNINGS}")
    big = rows > MAX_RESIDENT_ROWS
    if binning == "tile_lists":
        return (rasterize_gbuffer_binned_hbm if big
                else rasterize_gbuffer_binned)
    if big:
        return (rasterize_gbuffer_hbm if binning == "hierarchy"
                else rasterize_gbuffer_binned_hbm)
    if binning == "small" or (
            binning == "auto" and head_count(rows) <= SMALL_BIN_MAX_ROWS):
        return rasterize_gbuffer_small
    return rasterize_gbuffer


def render_gbuffer(ccols, tri_node, matrices, normal_matrices,
                   material_table, width: int, height: int, pad_height: int,
                   pad_width: int, binning: str = "auto"):
    """Column geometry with normals and material constants at the true
    (width, height) viewport, then the G-buffer raster over the padded
    target, cropped to (height, width) like ``render_gbuffer_pallas``.

    Returns the GBUFFER_PLANES planes: packed color (i32 bits), depth, u,
    v, nx, ny, nz, metallic, roughness, emissive r/g/b, texture layer."""
    tri_i32, tri_f32 = tg.geometry_pipeline_cols(
        ccols, tri_node, matrices, width, height,
        normal_matrices=normal_matrices, material_table=material_table)
    return _gbuffer_dispatch(tri_i32, tri_f32, width, height, pad_height,
                             pad_width, binning)


def render_gbuffer_indexed(positions, attrs, tri_vidx, vert_node, matrices,
                           normal_matrices, material_table, width: int,
                           height: int, pad_height: int, pad_width: int,
                           binning: str = "auto", vertex_shader=None):
    """``render_gbuffer`` from the indexed buffers, through the indexed
    geometry stage with the optional vertex shader."""
    tri_i32, tri_f32 = tg.geometry_pipeline(
        positions, attrs, tri_vidx, matrices, vert_node, width, height,
        normal_matrices=normal_matrices, material_table=material_table,
        vertex_shader=vertex_shader)
    return _gbuffer_dispatch(tri_i32, tri_f32, width, height, pad_height,
                             pad_width, binning)


def _gbuffer_dispatch(tri_i32, tri_f32, width: int, height: int,
                      pad_height: int, pad_width: int, binning: str):
    raster = select_gbuffer_raster(binning, tri_i32.shape[0])
    planes = raster(tri_i32, tri_f32, pad_width, pad_height)
    return [p[:height, :width] for p in planes]


# ---------------------------------------------------------------------------
# Depth-only raster (the shadow-map pass)
# ---------------------------------------------------------------------------


def rasterize_depth_small(tri_i32, tri_f32, width: int, height: int):
    """K2d wrapper: ``prepare_binned_small`` then the kernel (CUDA tensors)
    or its plain version (CPU tensors).  Returns the (height, width) f32
    depth plane."""
    _check_frame(width, height)
    prepared = prepare_binned_small(tri_i32, tri_f32, width, height)
    if _on_cpu(tri_i32):
        return depth_small_plain(*prepared, width, height)
    return depth_small_kernel(*prepared, width, height)


def rasterize_depth(tri_i32, tri_f32, width: int, height: int):
    """K3d wrapper: ``prepare_raster_inputs`` then the kernel or its plain
    version."""
    _check_frame(width, height)
    prepared = prepare_raster_inputs(tri_i32, tri_f32)
    if _on_cpu(tri_i32):
        return depth_hier_plain(*prepared, width, height)
    return depth_hier_kernel(*prepared, width, height)


def rasterize_depth_hbm(tri_i32, tri_f32, width: int, height: int):
    """The depth plane of K5 (``rasterize_setup_hbm``), as the reference's
    depth dispatch takes it for ``hierarchy`` above MAX_RESIDENT_ROWS."""
    return rasterize_setup_hbm(tri_i32, tri_f32, width, height)[1]


def rasterize_depth_binned_hbm(tri_i32, tri_f32, width: int, height: int,
                               cap: int | None = None,
                               pair_budget: int | None = None):
    """K4d wrapper: ``prepare_binned_hbm_inputs`` (no coarse class) then
    the kernel or its plain version."""
    _check_frame(width, height)
    prepared = prepare_binned_hbm_inputs(tri_i32, tri_f32, width, height,
                                         cap=cap, pair_budget=pair_budget)
    if _on_cpu(tri_i32):
        return depth_binned_plain(*prepared, width, height)
    return depth_binned_kernel(*prepared, width, height)


def rasterize_depth_binned(tri_i32, tri_f32, width: int, height: int,
                           cap: int | None = None):
    """K6d wrapper: ``prepare_binned_inputs`` then the kernel or its plain
    version."""
    _check_frame(width, height)
    prepared = prepare_binned_inputs(tri_i32, tri_f32, width, height, cap=cap)
    if _on_cpu(tri_i32):
        return depth_lists_plain(*prepared, width, height)
    return depth_lists_kernel(*prepared, width, height)


def select_depth_raster(binning: str, rows: int):
    """The dispatch of ``render_depth_pallas``, branch for branch: returns
    the wrapper that rasterizes the depth of ``rows`` setup rows.

    * ``tile_lists``: K4d above MAX_RESIDENT_ROWS rows, else K6d;
    * above MAX_RESIDENT_ROWS rows: K5's depth plane for ``hierarchy``,
      else K4d;
    * below: K2d for ``small``, and for ``auto`` up to SMALL_BIN_MAX_ROWS
      head rows; K3d otherwise."""
    if binning not in BINNINGS:
        raise ValueError(f"unknown binning {binning!r}; one of {BINNINGS}")
    big = rows > MAX_RESIDENT_ROWS
    if binning == "tile_lists":
        return rasterize_depth_binned_hbm if big else rasterize_depth_binned
    if big:
        return (rasterize_depth_hbm if binning == "hierarchy"
                else rasterize_depth_binned_hbm)
    if binning == "small" or (
            binning == "auto" and head_count(rows) <= SMALL_BIN_MAX_ROWS):
        return rasterize_depth_small
    return rasterize_depth


def render_depth(ccols, tri_node, matrices, size: int,
                 binning: str = "auto"):
    """The shadow-map pass: column geometry (no normals, no material
    table) at the (size, size) viewport, then the depth dispatch over the
    same target, which has no crop and no padding: ``size`` must be a
    multiple of TILE_W and TILE_H.  Returns the (size, size) f32 plane."""
    _check_frame(size, size)
    tri_i32, tri_f32 = tg.geometry_pipeline_cols(ccols, tri_node, matrices,
                                                 size, size)
    return select_depth_raster(binning, tri_i32.shape[0])(tri_i32, tri_f32,
                                                          size, size)


# ---------------------------------------------------------------------------
# Band raster (one band of a sharded frame)
# ---------------------------------------------------------------------------


def rasterize_setup_band(tri_i32, tri_f32, width: int, band_h: int,
                         row0: int):
    """K3b wrapper: ``prepare_raster_inputs`` then K3 over the ``band_h``
    rows from global row ``row0`` (CUDA tensors) or its plain version (CPU
    tensors).  Returns the band's (packed i32, depth f32)."""
    _check_band(width, band_h, row0)
    prepared = prepare_raster_inputs(tri_i32, tri_f32)
    if _on_cpu(tri_i32):
        return raster_hier_band_plain(*prepared, width, band_h, row0)
    return raster_hier_band_kernel(*prepared, width, band_h, row0)


def rasterize_setup_binned_band(tri_i32, tri_f32, width: int,
                                full_height: int, band_h: int, row0: int,
                                cap: int | None = None,
                                pair_budget: int | None = None,
                                n_head: int | None = None,
                                band_local: bool = True):
    """K9 wrapper: the band-local ``prepare_binned_hbm_inputs`` (or, with
    ``band_local=False``, the full-frame one of the ``full_height`` frame)
    then K4 over the band.  Sharded callers pass ``n_head``."""
    _check_band(width, band_h, row0, full_height)
    band_kw = {}
    if band_local:
        band_kw = dict(band_ty0=row0 // TILE_H, band_tiles_y=band_h // TILE_H)
    prepared = prepare_binned_hbm_inputs(
        tri_i32, tri_f32, width, full_height, cap=cap,
        pair_budget=pair_budget, n_head=n_head, **band_kw)
    if _on_cpu(tri_i32):
        return raster_binned_band_plain(*prepared, width, band_h, row0,
                                        band_local)
    return raster_binned_band_kernel(*prepared, width, band_h, row0,
                                     band_local)


def rasterize_gbuffer_binned_band(tri_i32, tri_f32, width: int,
                                  full_height: int, band_h: int, row0: int,
                                  cap: int | None = None,
                                  pair_budget: int | None = None,
                                  n_head: int | None = None):
    """K9g wrapper: the band-local prepare then K4g over the band; returns
    the GBUFFER_PLANES (band_h, W) planes."""
    _check_band(width, band_h, row0, full_height)
    prepared = prepare_binned_hbm_inputs(
        tri_i32, tri_f32, width, full_height, cap=cap,
        pair_budget=pair_budget, n_head=n_head, band_ty0=row0 // TILE_H,
        band_tiles_y=band_h // TILE_H)
    if _on_cpu(tri_i32):
        return gbuffer_binned_band_plain(*prepared, width, band_h, row0)
    return gbuffer_binned_band_kernel(*prepared, width, band_h, row0)


def rasterize_setup_binned_band_dist(ti, tf, listed_mask, rec_i, rec_f, offs,
                                     width: int, full_height: int,
                                     band_h: int, row0: int):
    """K9d wrapper: the owner's prepare over the received slabs
    (``rec_i``/``rec_f`` (n_src, R, ...), ``offs`` (n_src, band_tiles + 1),
    ``listed_mask`` the (n_head,) rows sent to this band) and the gathered
    rows, then the kernel or its plain version."""
    _check_band(width, band_h, row0, full_height)
    prepared = prepare_binned_dist_owner(ti, tf, listed_mask, rec_i, rec_f,
                                         offs)
    if _on_cpu(ti):
        return raster_binned_band_plain(*prepared, width, band_h, row0)
    return raster_binned_band_dist_kernel(*prepared, width, band_h, row0)
