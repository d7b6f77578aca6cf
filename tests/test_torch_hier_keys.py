"""The keyed hierarchy body's rules (zrenderer_tpu_torch/csrc/raster_hier.cu
``keyed_hier`` over csrc/raster_keyed.cuh: K3,
K3b, K3g, K3d, K5 and K5g), through the mirrors below, the work-item
helpers ``hier_block_hits``, ``hier_work_items`` and ``hier_hit_words``
and the window helper ``vertex_bbox`` of zrenderer_tpu_torch/ops/raster.py,
on setup rows from the JAX package's NumPy geometry:

* (a) keys: the minimum of K3's, K3b's and K3g's (z order bits, row id)
  keys under the clear key (1.0, 0), and of K3d's (z order bits, row id,
  sign) keys, is the strict-less test z >= 0 && z < zb from 1.0 in row
  order, over z values with +-0.0, 1.0, subnormals, NaN, negatives and
  exact ties; a row at z == 1.0 never goes below either clear key;
* (b) windows: every pixel a row covers in a tile that the walk admits
  (its clamped bbox meets the tile) lies in the kernel's window for it
  (the vertices' pixel bbox in the tile), the padding rows included;
* (c) work items: each tile's hit blocks cut into work items, each item's
  keys over its rows' windows, merged by the minimum and resolved,
  equals ``raster_hier_plain`` (K3: colour and depth as int32),
  ``raster_hier_band_plain`` (K3b: two bands at two row bases, the
  tiles' rows global and the planes band-local), ``depth_hier_plain`` and,
  on lit rows (random uv, normals and per-triangle materials),
  ``gbuffer_hier_plain`` (K3g) and ``gbuffer_hbm_plain`` (K5g: its own
  epilogue, which the den < 0 case tells from K3g's) in all 13 planes as
  int32 (K5's keys and plain version are K3's): the padded soup (its rows below
  the geometry), the duplicated soup with items of one hit block (exact
  ties split across items), the 20K lattice, the edge map, a row at z ==
  1.0 (stays clear), a subnormal and a NaN z, and -0.0 ties both ways;
* (d) the item table cuts each tile's hit blocks into consecutive shares,
  as the kernel's walk over the hit words does at any superblock count,
  and the hit blocks hold every row the walk admits, on a prepare above
  32768 rows too;
* (e) the walk over the hit words (``hier_hit_words``) gives
  every hit block the item of ``hier_work_items``, up to 300 superblocks,
  and on 135 168 rows (five groups of 8 superblocks) K5 and K5g equal
  their plain versions at 1, 2 and 16 items, a share starting past a
  group and ending inside one.

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py (phases 4k, 4b, 4g, 4d, 5b, 5l and 5s).
"""

import numpy as np
import pytest
import torch

from test_torch_binned_keys import (
    DEPTH_CLEAR_KEY,
    F32_SPECIALS,
    _cover_z,
    _duplicated_soup,
    _edge_map,
    _lattice_narrow,
    _lit_duplicated_soup,
    _lit_padding_soup,
    _lit_pair,
    _padding_soup,
    _rows,
    _sequential_depth,
    _window_pixels,
    depth_key_z,
    depth_keys,
    flat_keys,
    record_windows,
)
from test_torch_raster import _bits
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.scene.procedural import make_stress_scene
from zrenderer_tpu_torch.ops import raster as tr

# K3g's clear key: (1.0, row id 0), which no row at z == 1.0 goes below, as
# the strict-less test never lets 1.0 pass.  K3d's is K4d's (1.0, visit 0).
HIER_CLEAR_KEY = 0x3F800000 << 32


def _walk_pairs(hier, blocks, supers, width: int, height: int,
                row0: int = 0):
    """Every (tile, row) the hierarchy walk admits: rows whose clamped bbox
    meets the tile (tile_overlap), in a block and superblock whose union
    bboxes meet it too.  The tiles are those of the ``height`` rows from
    global row ``row0``.  Returns (tile (P,), row (P,)), row order within
    each tile."""
    ty, tx = height // tr.TILE_H, width // tr.TILE_W
    box = [g.I_JMIN, g.I_JMAX, g.I_IMIN, g.I_IMAX]
    hits = tr._tile_hits(hier[:, box], ty, tx, row0)
    tile, row = torch.nonzero(hits, as_tuple=True)
    block_hits = tr.hier_block_hits(supers, blocks, width, height, row0)
    # A row that meets a tile is in its block's and superblock's unions.
    assert bool(block_hits[tile, row // tr.RASTER_BLOCK].all())
    return tile, row


def _resolve_winners(keys, ti, tf, width: int, height: int,
                     gbuffer: bool = True, row0: int = 0,
                     masked_inv: bool = False):
    """K3g's store: the winner of each (H, W) key (its id; none where the
    key is the clear one) re-evaluated at the pixel, its z (-0.0 kept),
    colour, uv and normal numerators and constants, then K3g's epilogue
    covered ? buf * 1/den : 0 (``masked_inv``: K5g's, buf * (covered ?
    1/den : 0)).  Returns the GBUFFER_PLANES planes; without ``gbuffer``
    K3's and K5's store, the packed colour and depth planes.  The keys'
    first row is global row ``row0`` (a band's)."""
    th, tw = tr.TILE_H, tr.TILE_W
    tiles_x = width // tw
    won = keys != HIER_CLEAR_KEY
    ids = (keys & 0xFFFFFFFF)[won]
    row, col = torch.nonzero(won, as_tuple=True)
    _, interp, zw = _cover_z(ti[ids], tf[ids], row + row0, col)
    latches = tr._LATCHES + (tr._GBUF_LATCHES if gbuffer else ())
    consts = tr._CONSTS if gbuffer else ()
    out = {name: torch.zeros((height, width), dtype=torch.float32)
           for name, _ in latches + consts}
    out["z"] = torch.ones((height, width), dtype=torch.float32)
    out["z"][won] = zw
    for name, c in latches:
        out[name][won] = interp(c)
    for name, c in consts:
        out[name][won] = tf[ids, c]
    planes = {name: p.reshape(height // th, th, tiles_x,
                              tw).permute(0, 2, 1, 3)
              for name, p in out.items()}
    if not gbuffer:
        return tr._resolve_planes(planes)
    return tr._resolve_gbuffer(planes, masked_inv=masked_inv)


def keyed_hier_plain(supers, blocks, ti, tf, width: int, height: int,
                     depth: bool, items: int, gbuffer: bool = True,
                     row0: int = 0, masked_inv: bool = False):
    """K3g (with ``masked_inv`` K5g, with ``depth`` K3d, without
    ``gbuffer`` K3 and K5) as the keyed body computes it over the hierarchy
    alone: each tile's hit blocks cut into ``items`` work items
    (``tr.hier_work_items``), each item's keys over its rows' windows (a
    scatter min; a key at or above the clear one lowers nothing), the
    items' keys merged by their minimum, then the store.  ``row0``: K3b,
    the ``height`` rows from global row ``row0`` (tiles, windows and edge
    functions at global rows, the keys and planes band-local)."""
    th, tw = tr.TILE_H, tr.TILE_W
    tiles_x = width // tw
    num_tiles = tiles_x * (height // th)
    work = tr.hier_work_items(
        tr.hier_block_hits(supers, blocks, width, height, row0), items)
    tile, rows = _walk_pairs(ti, blocks, supers, width, height, row0)
    item = work[tile, rows // tr.RASTER_BLOCK]
    assert bool(((item >= 0) & (item < items)).all())
    owner = tile * items + item
    r0, c0 = row0 + (tile // tiles_x) * th, (tile % tiles_x) * tw
    ri = ti[rows].long()
    pair, row, col = _window_pixels(ri, r0, c0)
    cov, _, z = _cover_z(ti[rows][pair], tf[rows][pair], row, col)
    ok = cov & (z >= 0.0)
    tag = rows[pair][ok]
    key = depth_keys(z[ok], tag) if depth else flat_keys(z[ok], tag)
    clear = DEPTH_CLEAR_KEY if depth else HIER_CLEAR_KEY
    slot = (owner[pair][ok] * (th * tw) + (row[ok] - r0[pair][ok]) * tw
            + col[ok] - c0[pair][ok])
    per_item = torch.full((num_tiles * items * th * tw,), clear,
                          dtype=torch.int64)
    per_item.scatter_reduce_(0, slot, key, "amin")
    merged = per_item.reshape(num_tiles, items, th * tw).amin(1)
    keys = tr._frame(merged.reshape(height // th, tiles_x, th, tw))
    if depth:
        return depth_key_z(keys)
    return _resolve_winners(keys, ti, tf, width, height, gbuffer, row0,
                            masked_inv)


# (a) keys


def _sequential_strict(z):
    """K3g's register loop over rows in order: z >= 0 && z < zb from 1.0,
    keeping the last row that passed; returns (z bits, row) or (1.0's
    bits, None)."""
    zb, tb = np.float32(1.0), None
    for t, zz in enumerate(z):
        if zz >= 0 and zz < zb:
            zb, tb = zz, t
    return np.float32(zb).view(np.uint32), tb


@pytest.mark.parametrize("seed", range(6))
def test_key_minimum_is_the_strict_less_test(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 12))
        z = rng.choice(F32_SPECIALS, n)
        if n > 1 and rng.random() < 0.5:  # an exact tie, a later row
            z[rng.integers(n)] = z[rng.integers(n)]
        ok = torch.from_numpy(z >= 0)
        zt, ids = torch.from_numpy(z), torch.arange(n)
        keys = flat_keys(zt, ids)[ok].tolist()
        k = min([HIER_CLEAR_KEY] + [x for x in keys if x < HIER_CLEAR_KEY])
        zbits, tb = _sequential_strict(z)
        if tb is None:
            assert k == HIER_CLEAR_KEY
        else:
            assert (k >> 32, k & 0xFFFFFFFF) == (zbits & 0x7FFFFFFF, tb)
            # The store re-evaluates the winner's z: its sign is kept.
            assert z[tb].view(np.uint32) == zbits
        deep = depth_keys(zt, ids)[ok]
        kd = torch.tensor(min([DEPTH_CLEAR_KEY] + deep.tolist()))
        assert (depth_key_z(kd).numpy().view(np.uint32)
                == _sequential_depth(z))


def test_key_clear_values():
    """A row at z == 1.0 goes below neither clear key, whatever its id;
    -0.0 ties +0.0 and the lower row id wins."""
    one = torch.tensor([1.0, 1.0])
    assert (flat_keys(one, torch.tensor([0, 7])) >= HIER_CLEAR_KEY).all()
    assert (depth_keys(one, torch.tensor([0, 7])) >= DEPTH_CLEAR_KEY).all()
    below = torch.tensor([np.nextafter(np.float32(1.0), np.float32(0.0))])
    assert flat_keys(below, torch.tensor([2**31 - 1]))[0] < HIER_CLEAR_KEY
    zeros = torch.tensor([-0.0, 0.0])
    for first in (0, 1):
        ids = torch.tensor([first, 1 - first])
        fk = flat_keys(zeros, ids)
        assert int(fk.argmin()) == int(ids.argmin())
        dk = depth_keys(zeros, ids)
        winner = depth_key_z(dk.min().reshape(1))
        assert bool(torch.signbit(winner)) == (first == 0)


# (b) windows

HIER_INPUTS = {"padding_soup": _padding_soup,
               "duplicated_soup": _duplicated_soup,
               "lattice20k_256x128": _lattice_narrow, "edge_map": _edge_map}


@pytest.mark.parametrize("name", list(HIER_INPUTS))
def test_windows_hold_every_covered_pixel(name):
    (ti, tf), (w, h) = HIER_INPUTS[name]()
    supers, blocks, hier, tf_c = tr.prepare_raster_inputs(ti, tf)
    tile, rows = _walk_pairs(hier, blocks, supers, w, h)
    tiles_x = w // tr.TILE_W
    row0 = (tile // tiles_x) * tr.TILE_H
    col0 = (tile % tiles_x) * tr.TILE_W
    ri = hier[rows].long()
    r_lo, r_hi, c_lo, c_hi = record_windows(ri, row0, col0)
    iy = torch.arange(tr.TILE_H)[:, None]
    ix = torch.arange(tr.TILE_W)[None, :]
    covered = outside = 0
    for s in range(0, ri.shape[0], 1024):
        sl = slice(s, s + 1024)
        r = ri[sl].to(torch.int32)
        rr = (row0[sl, None, None] + iy).to(torch.int32)
        cc = (col0[sl, None, None] + ix).to(torch.int32)
        py, px = rr * 8 + 4, cc * 8 + 4

        def c(k):
            return r[:, k, None, None]

        cov = ((c(g.I_DX0) * (py - c(g.I_Y1)) - c(g.I_DY0) * (px - c(g.I_X1))
                >= c(g.I_BIAS0))
               & (c(g.I_DX1) * (py - c(g.I_Y2)) - c(g.I_DY1) * (px - c(g.I_X2))
                  >= c(g.I_BIAS1))
               & (c(g.I_DX2) * (py - c(g.I_Y0)) - c(g.I_DY2) * (px - c(g.I_X0))
                  >= c(g.I_BIAS2)))
        inside = ((rr >= r_lo[sl, None, None]) & (rr <= r_hi[sl, None, None])
                  & (cc >= c_lo[sl, None, None])
                  & (cc <= c_hi[sl, None, None]))
        covered += int(cov.sum())
        outside += int((cov & ~inside).sum())
    assert covered > 0
    assert outside == 0
    if name == "padding_soup":
        # The walk's rows draw into the padding rows 80-95 by their window,
        # as the whole-tile evaluation drew them.
        z = tr.depth_hier_plain(supers, blocks, hier, tf_c, w, h)
        assert (z[80:] < 1.0).sum() > 0


# (c) work items merged


def _ties_split_across_items(supers, blocks, hier, w, h, items):
    """(tile, row) pairs of the walk whose row repeats the vertices of an
    earlier row of the tile from another work item: exact ties that the
    items' merge must break."""
    work = tr.hier_work_items(tr.hier_block_hits(supers, blocks, w, h),
                              items)
    tile, rows = _walk_pairs(hier, blocks, supers, w, h)
    item = work[tile, rows // tr.RASTER_BLOCK]
    first, split = {}, 0
    for t, r, it in zip(tile.tolist(), rows.tolist(), item.tolist()):
        v = (t, *hier[r, :6].tolist())
        split += v in first and first[v] != it
        first.setdefault(v, it)
    return split


# name: (lit rows, items a tile, what the frame must show)
HIER_ITEM_CASES = {
    "padding_soup_items1": (_lit_padding_soup, 1, "padding"),
    "padding_soup_items3": (_lit_padding_soup, 3, "padding"),
    "duplicated_soup_items32": (_lit_duplicated_soup, 32, "split_ties"),
    "lattice20k_items5": (
        lambda: (_rows(*make_stress_scene(20000), 256, 128, tri_align=256,
                       lit=True, seed=7), (256, 128)), 5, "frame"),
    "edge_map_items2": (
        lambda: (_rows(*_edge_scene(), 256, 256, lit=True, seed=8),
                 (256, 256)), 2, "frame"),
    "z_one_items1": (lambda: _lit_pair(za_a=(0.25, 0.0, 0.0)), 1, "z_one"),
    "subnormal_nan_items2": (
        lambda: _lit_pair(za_a=(1e-45, 0.0, 0.0), za_b=(np.nan,) * 3), 2,
        "subnormal"),
    "neg_zero_first_items1": (
        lambda: _lit_pair(za_a=(-0.0,) * 3, za_b=(0.0,) * 3), 1, "neg_zero"),
    "pos_zero_first_items2": (
        lambda: _lit_pair(za_a=(0.0,) * 3, za_b=(-0.0,) * 3), 2, "pos_zero"),
    "den_negative_items1": (lambda: _negative_den_pair(), 1, "den_negative"),
}


def _negative_den_pair():
    """The lit pair with A's 1/w plane negated: where A wins, its den < 0,
    so K3g's epilogue (covered ? buf * 1/den : 0) writes +0.0 where
    buf * (covered ? 1/den : 0) would write -0.0 or NaN."""
    (ti, tf), wh = _lit_pair()
    a = int(torch.nonzero(ti[:, g.I_VALID] > 0)[0])
    tf[a, g.F_RW0:g.F_RW0 + 3] = -tf[a, g.F_RW0:g.F_RW0 + 3]
    return (ti, tf), wh


def _edge_scene():
    from zrenderer_tpu.scene.procedural import make_triangle_soup
    return make_triangle_soup(600, seed=3, extent=6.0)


def _bands(h: int):
    """K3b's two bands of a frame of ``h`` rows: rows [0, r) and [r, h),
    r the middle tile row; one tile row past the frame (clear) when the
    frame is one tile high.  (row0, band_h) each."""
    r = max(tr.TILE_H, h // 2 // tr.TILE_H * tr.TILE_H)
    return [(0, r), (r, max(h - r, tr.TILE_H))]


@pytest.mark.parametrize("kernel", ["k3", "k3b", "k3g", "k3d", "k5g"])
@pytest.mark.parametrize("name", list(HIER_ITEM_CASES))
def test_items_merged_equal_the_plain_versions(name, kernel):
    build, items, shows = HIER_ITEM_CASES[name]
    (ti, tf), (w, h) = build()
    prep = tr.prepare_raster_inputs(ti, tf)
    depth, gbuffer = kernel == "k3d", kernel in ("k3g", "k5g")
    if depth:
        got = keyed_hier_plain(*prep, w, h, True, items)
        ref = tr.depth_hier_plain(*prep, w, h)
        _bits(got.numpy(), ref.numpy())
        z, color = ref, None
    elif gbuffer:
        # K3g and K5g: one walk and key, each kernel's epilogue.
        k5g = kernel == "k5g"
        got = keyed_hier_plain(*prep, w, h, False, items, masked_inv=k5g)
        ref = (tr.gbuffer_hbm_plain if k5g
               else tr.gbuffer_hier_plain)(*prep, w, h)
        assert len(got) == len(ref) == tr.GBUFFER_PLANES
        for a, b in zip(got, ref):
            _bits(a.numpy(), b.numpy())
        z, color = ref[1], ref[0]
    else:
        # K3 (K5's plain version and keys too), or K3b's two bands:
        # colour and depth as int32, each band against the plain K3b at its
        # row base, laid side by side equal to the plain K3 frame.
        bands = _bands(h) if kernel == "k3b" else [(0, h)]
        outs = []
        for row0, band_h in bands:
            got = keyed_hier_plain(*prep, w, band_h, False, items,
                                   gbuffer=False, row0=row0)
            ref = (tr.raster_hier_band_plain(*prep, w, band_h, row0)
                   if kernel == "k3b" else tr.raster_hier_plain(*prep, w, h))
            assert tuple(got[0].shape) == (band_h, w)
            for a, b in zip(got, ref):
                _bits(a.numpy(), b.numpy())
            outs.append(ref)
        color = torch.cat([c for c, _ in outs])[:h]
        z = torch.cat([d for _, d in outs])[:h]
        if kernel == "k3b":
            frame = tr.raster_hier_plain(*prep, w, h)
            _bits(color.numpy(), frame[0].numpy())
            _bits(z.numpy(), frame[1].numpy())
    assert int((z < 1.0).sum()) > 0
    if shows == "padding":
        assert (z[80:] < 1.0).sum() > 0  # rows below the geometry
    elif shows == "split_ties":
        assert _ties_split_across_items(*prep[:3], w, h, items) > 0
        if gbuffer:  # many winners' materials
            assert torch.unique(ref[12][z < 1.0]).numel() > 50
    elif shows == "z_one":
        # A (row 0) covers a pixel at z == 1.0, which the strict-less
        # test leaves clear.
        row, col = torch.nonzero(torch.ones(h, w, dtype=torch.bool),
                                 as_tuple=True)
        cov, _, za = _cover_z(prep[2][:1], prep[3][:1], row, col)
        assert int((cov & (za == 1.0)).sum()) == 1
        if color is not None:
            latched = int(((z == 1.0) & (color != -(1 << 24))).sum())
            assert latched == 0
    elif shows == "subnormal":
        sub = (z > 0.0) & (z < np.float32(np.finfo(np.float32).tiny))
        assert int(sub.sum()) > 0
    elif shows == "den_negative" and color is not None:
        uncovered = (z < 1.0) & (color == -(1 << 24))
        assert int(uncovered.sum()) > 0
        if gbuffer:
            # uv and normal where den <= 0: K3g's epilogue writes +0.0,
            # K5g's buf * 0 (-0.0 where buf < 0); the other planes agree.
            k3g = tr.gbuffer_hier_plain(*prep, w, h)
            signed = [bool(torch.signbit(p[uncovered]).any())
                      for p in ref[2:7]]
            assert any(signed) == (kernel == "k5g")
            differ = [not torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                      for a, b in zip(ref, k3g)]
            assert any(differ[2:7]) == (kernel == "k5g")
            assert not any(differ[:2] + differ[7:])
    elif shows in ("neg_zero", "pos_zero"):
        neg = int((torch.signbit(z) & (z == 0.0)).sum())
        assert (neg > 0) == (shows == "neg_zero")


# Superblocks a group: one a warp in csrc/raster_hier.cu
# hier_hit_words_kernel (THREADS / SUPER_BLOCK), which tests superblocks w,
# w + 8, ... in warp w.
GROUP_SUPERS = 8


@pytest.mark.parametrize("seed", range(8))
def test_work_items_cut_each_tiles_hit_blocks(seed):
    rng = np.random.default_rng(seed)
    tiles = int(rng.integers(1, 30))
    # Up to 24 superblocks: three groups.
    blocks = tr.SUPER_BLOCK * int(rng.integers(1, 3 * GROUP_SUPERS + 1))
    hits = torch.from_numpy(rng.random((tiles, blocks))
                            < rng.choice([0.0, 0.02, 0.3, 1.0]))
    hits[0] = False  # a tile no row meets
    items = int(rng.integers(1, 80))
    work = tr.hier_work_items(hits, items)
    words, before, count = tr.hier_hit_words(hits)
    assert (work[~hits] == -1).all()
    for t in range(tiles):
        mine = work[t][hits[t]].tolist()
        n = len(mine)
        # As the kernel cuts: item i takes hit blocks [i n / items,
        # (i + 1) n / items), in row order over every group.
        want = [i for i in range(items)
                for _ in range(i * n // items, (i + 1) * n // items)]
        assert mine == want
        assert work[t].tolist() == _words_walk(words[t].tolist(),
                                               before[t].tolist(), count[t],
                                               items)
        if n:
            sizes = np.bincount(mine, minlength=items)
            assert int(sizes.max() - sizes.min()) <= 1


def _lattice40k_narrow():
    """The 40K lattice at 256x128: above 32768 rows, 12 superblocks (two
    groups)."""
    return (_rows(*make_stress_scene(40000), 256, 128, tri_align=256),
            (256, 128))


@pytest.mark.parametrize("build", [_lattice_narrow, _lattice40k_narrow],
                         ids=["lattice20k_256x128", "lattice40k_256x128"])
def test_hit_blocks_match_the_walk(build):
    """On the 20K lattice, and above 32768 rows on the 40K lattice, at
    256x128: every block that holds a row the walk admits in a tile is one
    of the tile's hit blocks, and so in a band's tiles."""
    (ti, tf), (w, h) = build()
    supers, blocks, hier, _ = tr.prepare_raster_inputs(ti, tf)
    if build is _lattice40k_narrow:
        assert hier.shape[0] > tr.MAX_RESIDENT_ROWS
        assert supers.shape[0] > GROUP_SUPERS
    hits = tr.hier_block_hits(supers, blocks, w, h)
    tile, rows = _walk_pairs(hier, blocks, supers, w, h)
    held = torch.zeros_like(hits)
    held[tile, rows // tr.RASTER_BLOCK] = True
    assert bool((hits | ~held).all())
    assert int(held.sum()) > 0
    assert int(hits.sum()) >= int(held.sum())
    # A band's tiles are the frame's tile rows from its row base.
    band = tr.hier_block_hits(supers, blocks, w, h // 2, h // 2)
    assert torch.equal(band, hits[hits.shape[0] // 2:])


# The walk reads the hit words (csrc/raster_hier.cu
# hier_hit_words_kernel) a chunk of this many superblocks at a time when it
# counts the superblocks before an item's share (THREADS), and this many
# words at a time when it walks the share (HIT_WORDS).
COUNT_CHUNK = 256
HIT_WORDS = 32


def _words_walk(words, before, count, items: int):
    """The kernel's walk of one tile's hit words (``tr.hier_hit_words``,
    one tile's row of each): item i's share [h0, h1) = [i H / n, (i + 1) H
    / n); the superblocks whose hit blocks all lie before h0 counted a
    COUNT_CHUNK at a time (stopping at the first chunk not all counted),
    then the words from the first other superblock, HIT_WORDS at a time,
    each set bit a rank.  Returns the item of each block (-1 where none)."""
    s = len(words)
    total = int(count)
    out = [-1] * (s * tr.SUPER_BLOCK)
    for i in range(items):
        h0, h1 = i * total // items, (i + 1) * total // items
        first = 0
        for c in range(0, s + COUNT_CHUNK, COUNT_CHUNK):
            n = sum(1 for sb in range(c, min(c + COUNT_CHUNK, s))
                    if before[sb] + bin(words[sb]).count("1") <= h0)
            first += n
            if n < COUNT_CHUNK:
                break
        h = int(before[first]) if first < s else total
        for c in range(first, s, HIT_WORDS):
            if h >= h1:
                break
            for sb in range(c, min(c + HIT_WORDS, s)):
                m = int(words[sb])
                while m and h < h1:
                    j = (m & -m).bit_length() - 1
                    if h >= h0:
                        out[sb * tr.SUPER_BLOCK + j] = i
                    m &= m - 1
                    h += 1
                if h >= h1:
                    break
    return out


@pytest.mark.parametrize("seed", range(8))
def test_hit_words_walk_cuts_each_tiles_hit_blocks(seed):
    """The walk over ``tr.hier_hit_words`` gives every hit block
    the item ``tr.hier_work_items`` names, at up to 300 superblocks (the
    count's chunks of 256 and the walk's chunks of 32 crossed)."""
    rng = np.random.default_rng(100 + seed)
    tiles = int(rng.integers(1, 6))
    supers = int(rng.choice([1, 9, 33, 257, 300]))
    hits = torch.from_numpy(rng.random((tiles, supers * tr.SUPER_BLOCK))
                            < rng.choice([0.0, 0.002, 0.05, 1.0]))
    if supers > COUNT_CHUNK:  # a share that starts past the first chunk
        hits[-1, :(COUNT_CHUNK + 3) * tr.SUPER_BLOCK] = False
        hits[-1, -5 * tr.SUPER_BLOCK:] = True
    hits[0] = False  # a tile no row meets
    words, before, count = tr.hier_hit_words(hits)
    assert words.shape == before.shape == (tiles, supers)
    assert torch.equal(count, hits.sum(1))
    for items in (1, 2, 16, int(rng.integers(3, 80))):
        work = tr.hier_work_items(hits, items)
        for t in range(tiles):
            got = _words_walk(words[t].tolist(), before[t].tolist(),
                              count[t], items)
            assert got == work[t].tolist()


def _many_groups(lit: bool):
    """Five groups of 8 superblocks (33 superblocks, 135 168
    rows, at 256x64): a soup's live rows spread in order over 13
    blocks in superblock groups 0, 2, 3 and 4 (none in group 1; group 4's in
    superblock 32, past the first HIT_WORDS words), the other rows live with
    an empty bbox, so the plain versions visit the soup's rows alone.  The
    3 blocks of group 0 hold 30 rows left of column 128 (the right tiles'
    items start past group 0), the other 10 the rows after them."""
    from zrenderer_tpu.scene.procedural import make_triangle_soup
    ti, tf = _rows(*make_triangle_soup(300, seed=9, extent=4.0), 256, 64,
                   lit=lit, seed=3)
    live = torch.nonzero(ti[:, g.I_VALID] > 0).flatten()
    left = live[ti[live, g.I_JMAX] < 128][:30]
    parts = (torch.tensor_split(left, 3)
             + torch.tensor_split(live[live > left[-1]], 10))
    hit_blocks = [3, 40, 200, 520, 530, 600, 700, 760, 767, 800, 900, 1000,
                  1029]
    rows = 33 * tr.SUPER_BLOCK * tr.RASTER_BLOCK
    big_i = torch.zeros((rows, g.NI32), dtype=torch.int32)
    big_i[:, g.I_VALID] = 1
    big_i[:, [g.I_JMIN, g.I_IMIN]] = 1 << 30
    big_i[:, [g.I_JMAX, g.I_IMAX]] = -(1 << 30)
    big_i[:, g.I_BIAS0:g.I_BIAS2 + 1] = 2**31 - 1
    big_f = torch.zeros((rows, g.NF32), dtype=torch.float32)
    for b, part in zip(hit_blocks, parts):
        dst = b * tr.RASTER_BLOCK + torch.arange(len(part))
        big_i[dst], big_f[dst] = ti[part], tf[part]
    return (big_i, big_f), (256, 64)


@pytest.mark.parametrize("items", [1, 2, 16])
@pytest.mark.parametrize("kernel", ["k5", "k5g"])
def test_many_groups_items_equal_the_plain_versions(kernel, items):
    """K5 and K5g over more than 98 304 rows: every plane equal to
    ``raster_hier_plain``/``gbuffer_hbm_plain`` as int32, with a share that
    starts past a superblock group and ends inside one, and the hit words'
    walk equal to the item table."""
    (ti, tf), (w, h) = _many_groups(lit=kernel == "k5g")
    prep = tr.prepare_raster_inputs(ti, tf)
    assert prep[2].shape[0] > 3 * GROUP_SUPERS * 4096
    hits = tr.hier_block_hits(*prep[:2], w, h)
    work = tr.hier_work_items(hits, items)
    words, before, count = tr.hier_hit_words(hits)
    group = GROUP_SUPERS * tr.SUPER_BLOCK  # blocks a group
    inside = False
    for t in range(hits.shape[0]):
        assert _words_walk(words[t].tolist(), before[t].tolist(), count[t],
                           items) == work[t].tolist()
        for i in range(items):
            mine = torch.nonzero(work[t] == i).flatten()
            if not len(mine):
                continue
            first, last = int(mine[0]) // group, int(mine[-1]) // group
            later = torch.nonzero(hits[t]).flatten() > mine[-1]
            rest = torch.nonzero(hits[t]).flatten()[later] // group
            inside |= first > 0 and bool((rest == last).any())
    if items > 1:
        assert inside
    if kernel == "k5":
        got = keyed_hier_plain(*prep, w, h, False, items, gbuffer=False)
        ref = tr.raster_hier_plain(*prep, w, h)
    else:
        got = keyed_hier_plain(*prep, w, h, False, items, masked_inv=True)
        ref = tr.gbuffer_hbm_plain(*prep, w, h)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _bits(a.numpy(), b.numpy())
    assert int((ref[1] < 1.0).sum()) > 0
