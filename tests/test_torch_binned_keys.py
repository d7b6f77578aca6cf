"""The keyed K4/K4d body's rules (zrenderer_tpu_torch/csrc/raster_binned.cu
``keyed_records``), through their mirrors below and the window and work-item
helpers of zrenderer_tpu_torch/ops/raster.py, on setup rows from the JAX
package's NumPy geometry:

* (a) keys: the minimum of K4's (z order bits, row id) keys is the (z, row
  id) tie-break, and of K4d's (z order bits, visit index, sign) keys the
  strict-less test in visit order, over z values with +-0.0, 1.0,
  subnormals, NaN, negatives and exact ties;
* (b) windows: every pixel a row covers in a tile that the plain K4/K4d
  evaluates lies in the kernel's window for it (the vertices' pixel bbox in
  the tile), the padding rows included;
* (c) work items: the plain evaluation cut into work items, each into its
  own key plane, merged by the minimum and resolved, equals
  ``raster_binned_plain`` and ``depth_binned_plain`` bit for bit, with
  items small enough to split exact ties; in the G-buffer mode (K4g: K4's
  keys, the winner resolved into 13 planes) it equals
  ``gbuffer_binned_plain`` in all 13 planes as int32 on lit rows (random
  uv, normals and per-triangle materials): the padded soup, the duplicated
  soup at 16-record items (ties split across items), a row at z == 1.0 and
  -0.0 ties both ways;
* (d) the work-item table covers each span and the leftover superblocks once;
* (e) K4c (K4's keys over each tile's span, then its coarse bin's records,
  one list cut into items; a coarse record whose bbox misses the tile
  skipped): every pixel a coarse record draws lies in its window, the
  items merged equal ``raster_binned_plain`` with the coarse class (and
  K4's frame in the geometry's rows) on soups whose rows fall to the
  coarse class, and the item table covers each span, each tile's bin and
  the leftover superblocks once;
* (f) K6d (K4d's keys over row-id spans: each listed row gathered from
  ``hier``, whose bbox and valid flag the prepare emptied, by its id): the
  windows from the vertices hold every pixel a listed row covers, while
  the emptied bbox would hold none; the items merged equal
  ``depth_lists_plain`` bit for bit on the padded soup, the duplicated
  soup at 16-record items (ties split across items), the edge map, the
  20K lattice, rows left to the hierarchy and -0.0 ties both ways; the
  item table covers each tile's row-id span once; K6 and K6g (K4's and
  K4g's keys over the same entry, the row id the tag) equal
  ``raster_lists_plain`` and, on lit rows, ``gbuffer_lists_plain`` in all
  13 planes on the same cases and a row at z == 1.0 (latched); their
  resolve, which reads the winner back from ``hier``, gives the same
  planes from the unemptied setup rows, and ``resolve_winner`` reads no
  bbox or valid word;
* (g) the kernels' item bound (csrc/raster_binned.cu ``item_bound``: one
  item a tile and one per ``item_records`` of the lists' records, from the
  lists' ends) holds every item of one span list, of several (K9d) and of
  a span and a coarse bin (K4c); the item size the kernels halve to while
  the lists would make fewer than ``KEYED_MIN_ITEMS`` items
  (``keyed_item_records``, its floor the kernel's MIN_ITEM_RECORDS) keeps
  the items within the launch's grid (``keyed_items``).

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py (phases 4b, 4g, 4d, 5b, 5l and 5s).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_raster import _bits, _setup
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.scene.mesh import MeshData
from zrenderer_tpu.scene.procedural import make_stress_scene
from zrenderer_tpu.scene.procedural import make_triangle_soup as make_jax_soup
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr

F32_SPECIALS = np.array(
    [0.0, -0.0, 1.0, np.nextafter(np.float32(1.0), np.float32(0.0)), 1e-45,
     1e-40, np.float32(np.finfo(np.float32).tiny), 0.5, 0.25, np.inf,
     np.nan, -1e-45, -0.5, 2.0], dtype=np.float32)


def _rows(scene, md, w, h, tri_align=64, lit=False, seed=0):
    """Setup rows of the JAX package's NumPy geometry at (w, h); ``lit``:
    with random uv and normals per corner, random normal matrices per draw
    and a random material table per triangle (seeded), so that a wrong
    winner shows in the G-buffer planes."""
    flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ccols, tri_node = flat.expand_corner_cols()
    kw = {}
    if lit:
        rng = np.random.default_rng(seed)
        uv_normal = np.array([c * 16 + j for c in range(3)
                              for j in range(8, 13)])
        ccols[uv_normal] = rng.standard_normal(
            (len(uv_normal), ccols.shape[1])).astype(np.float32)
        kw = dict(normal_matrices=rng.standard_normal(
                      (len(mats), 3, 3)).astype(np.float32),
                  material_table=rng.random(
                      (ccols.shape[1], g.MATERIAL_COLS), dtype=np.float32))
    ti, tf = g.geometry_pipeline_cols(np, ccols, tri_node, mats, w, h, **kw)
    return torch.from_numpy(ti), torch.from_numpy(tf)


# Mirrors of the keyed body: its per-pixel keys, each record's window, and
# a plain evaluation cut into its work items.

# Clear keys: K4's (1.0, INT32_MAX) lets a row at z == 1.0 latch; K4d's
# (1.0, visit 0, +) is below every row at z == 1.0.
FLAT_CLEAR_KEY = (0x3F800000 << 32) | tr._INT_MAX
DEPTH_CLEAR_KEY = 0x3F800000 << 32


def _z_bits(z):
    """f32 z -> its bits as int64 (0 .. 2**32 - 1)."""
    return z.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def flat_keys(z, ids):
    """K4's keys of z (f32, z >= 0) and row ids: the order bits of z (the
    sign cleared: -0.0 ties +0.0) over the id."""
    return ((_z_bits(z) & 0x7FFFFFFF) << 32) | ids.to(torch.int64)


def depth_keys(z, visits):
    """K4d's keys of z (f32, z >= 0) and visit indices: the order bits of
    z over the visit index over the sign of z."""
    bits = _z_bits(z)
    return (((bits & 0x7FFFFFFF) << 32) | (visits.to(torch.int64) << 1)
            | (bits >> 31))


def depth_key_z(keys):
    """The z plane of K4d's keys: the winner's z bits, 1.0 where clear."""
    bits = ((keys >> 32) | ((keys & 1) << 31)).to(torch.int64)
    z = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32)
    return torch.where(keys == DEPTH_CLEAR_KEY, 1.0, z.view(torch.float32))


def record_windows(ri, row0, col0):
    """The keyed body's window of setup rows ``ri`` in the tile at (row0,
    col0): ``tr.vertex_bbox`` clipped to the tile.  Returns (r_lo, r_hi,
    c_lo, c_hi); empty where lo > hi."""
    jmin, jmax, imin, imax = tr.vertex_bbox(ri).unbind(-1)
    return (torch.maximum(imin, row0),
            torch.minimum(imax, row0 + tr.TILE_H - 1),
            torch.maximum(jmin, col0),
            torch.minimum(jmax, col0 + tr.TILE_W - 1))


def record_hits(ri, row0, col0):
    """K4c's test of coarse records ``ri`` against the tile at (row0,
    col0): the reference's four-sided bbox test (csrc/raster_binned.cu
    record_hits, the plain version's ``masked`` spans)."""
    return ((ri[..., tg.I_JMAX] >= col0)
            & (ri[..., tg.I_JMIN] < col0 + tr.TILE_W)
            & (ri[..., tg.I_IMAX] >= row0)
            & (ri[..., tg.I_IMIN] < row0 + tr.TILE_H))


def _window_pixels(ri, row0, col0):
    """Every pixel of each row's window: (pair, global row, global col),
    pairs indexing ``ri``'s rows."""
    r_lo, r_hi, c_lo, c_hi = record_windows(ri, row0, col0)
    h = torch.clamp_min(r_hi - r_lo + 1, 0)
    w = torch.clamp_min(c_hi - c_lo + 1, 0)
    area = torch.where(w > 0, h * w, 0)
    pair = torch.repeat_interleave(torch.arange(area.numel()), area)
    q = torch.arange(pair.numel()) - (torch.cumsum(area, 0) - area)[pair]
    return (pair, r_lo[pair] + q // w[pair], c_lo[pair] + q % w[pair])


def _cover_z(ri, rf, row, col):
    """Setup rows (P, NI32)/(P, NF32) at pixels (row, col) (P,), with the
    kernels' int32 edge functions and interp3: (coverage, the
    interpolation of float column c as a function of c, z)."""
    py = (row * tg.SUBPIXEL + tg.SUBPIXEL // 2).to(torch.int32)
    px = (col * tg.SUBPIXEL + tg.SUBPIXEL // 2).to(torch.int32)
    e = [ri[:, dx] * (py - ri[:, y]) - ri[:, dy] * (px - ri[:, x])
         for dx, dy, x, y in ((tg.I_DX0, tg.I_DY0, tg.I_X1, tg.I_Y1),
                              (tg.I_DX1, tg.I_DY1, tg.I_X2, tg.I_Y2),
                              (tg.I_DX2, tg.I_DY2, tg.I_X0, tg.I_Y0))]
    cov = ((e[0] >= ri[:, tg.I_BIAS0]) & (e[1] >= ri[:, tg.I_BIAS1])
           & (e[2] >= ri[:, tg.I_BIAS2]))
    ef = [x.to(torch.float32) for x in e]

    def interp(c):
        return (ef[0] * rf[:, c] + ef[1] * rf[:, c + 1]) + ef[2] * rf[:, c + 2]

    return cov, interp, interp(tg.F_ZA0)


def keyed_binned_plain(offsets, rec_i, rec_f, supers, blocks, hier, tf,
                       width: int, height: int, depth: bool,
                       item_records: int, gbuffer: bool = False,
                       coarse=None, row0: int = 0, band_local: bool = True,
                       resolve_ti=None):
    """K4 (or with ``depth`` K4d, with ``gbuffer`` K4g, with ``coarse`` K4c,
    with ``row0`` K9, with 2-D ``offsets`` K9d) as the keyed body computes
    it: each work item's keys over its records' and leftover rows' windows
    (a scatter min), the items' keys merged by their minimum, then the
    resolve from the winner (K4g: K4's keys, the 13 planes under the buf *
    (covered ? 1/den : 0) epilogue).  ``coarse`` = (coffsets, crec_i,
    crec_f): each tile's items also walk its bin's records, a record whose
    bbox misses the tile skipped (record_hits).  ``row0``: the ``height``
    rows from global row ``row0`` (a band's; tiles, windows and edge
    functions global, the planes band-local), the spans indexed by band
    tile (``band_local``) or by frame tile.  2-D ``offsets`` (n_src, tiles
    + 1): each tile's spans of every source laid end to end (K9d).  K6d,
    K6 and K6g are K4d, K4 and K4g over the records their row-id entry
    stages (``lists_as_records``).  ``resolve_ti``: the setup rows' ints
    the resolve reads the winner from (by default ``hier``)."""
    del blocks  # a row that meets a tile is in its block's union
    th, tw = tr.TILE_H, tr.TILE_W
    tiles_x = width // tw
    num_tiles = tiles_x * (height // th)
    if not band_local:  # the band's tiles of the frame's spans
        base = (row0 // th) * tiles_x
        offsets = offsets[base:base + num_tiles + 1]
    coffsets = None if coarse is None else coarse[0]
    items = tr.keyed_work_items(offsets, item_records, supers.shape[0],
                                coffsets, tiles_x)
    per_super = tg.RASTER_BLOCK * tg.SUPER_BLOCK
    box = [tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX]
    hits = tr._tile_hits(hier[:, box], height // th, tiles_x,
                         row0)  # (tiles, rows)
    src_i, src_f, tags, owner = [], [], [], []
    n_src = offsets.shape[0] if offsets.ndim == 2 else 1
    span_end = offsets.reshape(n_src, -1)[-1, 1:].long()
    for it, (t, _, _, k0, k1, s0, s1, *further) in enumerate(
            items.tolist()):
        pieces = [(k0, k1)] + list(zip(further[0::2], further[1::2]))
        k = torch.cat([torch.arange(a, b) for a, b in pieces[:n_src]])
        c0, c1 = further[-2:]
        rows = torch.nonzero(hits[t]).flatten()
        rows = rows[(rows >= s0 * per_super) & (rows < s1 * per_super)]
        src_i += [rec_i[k, :tg.NI32], hier[rows]]
        src_f += [rec_f[k], tf[rows]]
        if depth:
            tags += [k, span_end[t] + rows]
        else:
            tags += [rec_i[k, tg.NI32].long(), rows]
        n = k.numel() + rows.numel()
        if coarse is not None:
            kc = torch.arange(c0, c1)
            kc = kc[record_hits(coarse[1][kc], row0 + (t // tiles_x) * th,
                                (t % tiles_x) * tw)]
            src_i.append(coarse[1][kc, :tg.NI32])
            src_f.append(coarse[2][kc])
            tags.append(coarse[1][kc, tg.NI32].long())
            n += kc.numel()
        owner.append(torch.full((n,), it))
    ri, rf = torch.cat(src_i), torch.cat(src_f)
    tag, owner = torch.cat(tags), torch.cat(owner)
    tile = items[owner, 0]
    t_row0 = row0 + (tile // tiles_x) * th
    col0 = (tile % tiles_x) * tw
    pair, row, col = _window_pixels(ri.long(), t_row0, col0)
    cov, _, z = _cover_z(ri[pair], rf[pair], row, col)
    ok = cov & (z >= 0.0)
    key = (depth_keys if depth else flat_keys)(z[ok], tag[pair][ok])
    clear = DEPTH_CLEAR_KEY if depth else FLAT_CLEAR_KEY
    slot = (owner[pair][ok] * (th * tw)
            + (row[ok] - t_row0[pair][ok]) * tw + col[ok] - col0[pair][ok])
    planes = torch.full((items.shape[0] * th * tw,), clear,
                        dtype=torch.int64)
    planes.scatter_reduce_(0, slot, key, "amin")
    # The items' minimum per tile, laid out as the (H, W) frame.
    merged = torch.full((num_tiles, th * tw), clear, dtype=torch.int64)
    merged.scatter_reduce_(0, items[:, :1].expand(-1, th * tw),
                           planes.reshape(-1, th * tw), "amin")
    keys = tr._frame(merged.reshape(height // th, tiles_x, th, tw))
    if depth:
        return depth_key_z(keys)
    won = keys != FLAT_CLEAR_KEY
    ids = (keys & 0xFFFFFFFF)[won]
    row, col = torch.nonzero(won, as_tuple=True)
    _, interp, zw = _cover_z((hier if resolve_ti is None else resolve_ti)[ids],
                             tf[ids], row + row0, col)
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
    if gbuffer:
        return tr._resolve_gbuffer(planes, masked_inv=True)
    return tr._resolve_planes(planes)


# (name, rows at the geometry's size, the raster target (w, h))
def _padding_soup():
    """test_torch_binned.py's padding-row soup: geometry at 256x80, the
    raster target 256x96, rows clamped to an empty bbox below row 79."""
    return _rows(*make_jax_soup(200, seed=2, extent=6.0), 256, 80), (256, 96)


def _duplicated_soup():
    ti, tf, w, h = _setup("tie_soup_256x128")
    return (torch.from_numpy(ti), torch.from_numpy(tf)), (w, h)


def _lattice_narrow():
    """The 20K lattice at a narrow 256x128 target."""
    return _rows(*make_stress_scene(20000), 256, 128, tri_align=256), (256,
                                                                        128)


def _edge_map():
    """A wide soup seen into a 256x256 map: rows whose bbox clamps to empty
    at the bottom and right edges and past them."""
    return _rows(*make_jax_soup(600, seed=3, extent=6.0), 256, 256), (256, 256)


INPUTS = {"padding_soup": _padding_soup, "duplicated_soup": _duplicated_soup,
          "lattice20k_256x128": _lattice_narrow, "edge_map": _edge_map}


def _sequential_flat(z, ids):
    """K4's register loop: z >= 0 && (z < zb || (z == zb && id < tb)) from
    (1.0, INT32_MAX); returns (z bits, id)."""
    zb, tb = np.float32(1.0), tr._INT_MAX
    for zz, t in zip(z, ids):
        if zz >= 0 and (zz < zb or (zz == zb and t < tb)):
            zb, tb = zz, t
    return np.float32(zb).view(np.uint32), tb


def _sequential_depth(z):
    """K4d's register loop: z >= 0 && z < zb from 1.0, in visit order."""
    zb = np.float32(1.0)
    for zz in z:
        if zz >= 0 and zz < zb:
            zb = zz
    return np.float32(zb).view(np.uint32)


@pytest.mark.parametrize("seed", range(6))
def test_key_minimum_is_the_sequential_test(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n = int(rng.integers(1, 12))
        z = rng.choice(F32_SPECIALS, n)
        ids = rng.permutation(1000)[:n].astype(np.int64)
        if n > 1 and rng.random() < 0.5:  # an exact tie, other ids
            z[rng.integers(n)] = z[rng.integers(n)]
        ok = z >= 0
        zt = torch.from_numpy(z)
        flat = flat_keys(zt, torch.from_numpy(ids))[torch.from_numpy(ok)]
        k = min([FLAT_CLEAR_KEY] + flat.tolist())
        zbits, tb = _sequential_flat(z, ids)
        assert (k >> 32, k & 0xFFFFFFFF) == (zbits & 0x7FFFFFFF, tb)
        # K4 re-evaluates the winner's z, so its sign is the winner's.
        if tb != tr._INT_MAX:
            assert z[list(ids).index(tb)].view(np.uint32) == zbits
        visits = torch.arange(n)
        deep = depth_keys(zt, visits)[torch.from_numpy(ok)]
        kd = torch.tensor(min([DEPTH_CLEAR_KEY] + deep.tolist()))
        assert (depth_key_z(kd).numpy().view(np.uint32)
                == _sequential_depth(z))


def test_key_clear_values():
    """A row at exactly z == 1.0 latches in K4 (the register body's tie
    with the clear id) and never in K4d; -0.0 ties +0.0 by id or visit."""
    one = torch.tensor([1.0])
    assert flat_keys(one, torch.tensor([7]))[0] < FLAT_CLEAR_KEY
    assert depth_keys(one, torch.tensor([0]))[0] >= DEPTH_CLEAR_KEY
    zeros = torch.tensor([-0.0, 0.0])
    fk = flat_keys(zeros, torch.tensor([5, 3]))
    assert fk[1] < fk[0]
    dk = depth_keys(zeros, torch.tensor([0, 1]))
    assert dk[0] < dk[1]
    assert depth_key_z(dk[:1]).view(torch.int32).item() == -(1 << 31)


def _visited_pairs(prep, w, h):
    """Every (tile, row) the plain K4/K4d evaluates: each span record, and
    each leftover row with a non-empty bbox in each tile it meets.
    Returns (setup rows (P, NI32), tile (P,))."""
    offsets, rec_i, hier = prep[0], prep[1], prep[5]
    span = (offsets[1:] - offsets[:-1]).long()
    tiles = torch.repeat_interleave(torch.arange(span.numel()), span)
    hits = tr._tile_hits(hier[:, [g.I_JMIN, g.I_JMAX, g.I_IMIN, g.I_IMAX]],
                         h // tr.TILE_H, w // tr.TILE_W)
    lt, lr = torch.nonzero(hits, as_tuple=True)
    spans = rec_i[int(offsets[0]):int(offsets[-1]), :g.NI32]
    return torch.cat([spans, hier[lr]]).long(), torch.cat([tiles, lt])


def _covered_outside(ri, tile, w):
    """(pixels covered, covered pixels outside the window) of setup rows
    ``ri`` (P, NI32) over the whole of their tiles ``tile`` (P,) of a
    ``w``-wide frame, under the kernels' int32 edge functions."""
    tiles_x = w // tr.TILE_W
    row0 = (tile // tiles_x) * tr.TILE_H
    col0 = (tile % tiles_x) * tr.TILE_W
    r_lo, r_hi, c_lo, c_hi = record_windows(ri, row0, col0)
    iy = torch.arange(tr.TILE_H)[:, None]
    ix = torch.arange(tr.TILE_W)[None, :]
    covered = outside = 0
    for s in range(0, ri.shape[0], 1024):
        sl = slice(s, s + 1024)
        r = ri[sl].to(torch.int32)
        rows = (row0[sl, None, None] + iy).to(torch.int32)
        cols = (col0[sl, None, None] + ix).to(torch.int32)
        py = rows * 8 + 4
        px = cols * 8 + 4

        def c(k):
            return r[:, k, None, None]

        cov = ((c(g.I_DX0) * (py - c(g.I_Y1)) - c(g.I_DY0) * (px - c(g.I_X1))
                >= c(g.I_BIAS0))
               & (c(g.I_DX1) * (py - c(g.I_Y2)) - c(g.I_DY1) * (px - c(g.I_X2))
                  >= c(g.I_BIAS1))
               & (c(g.I_DX2) * (py - c(g.I_Y0)) - c(g.I_DY2) * (px - c(g.I_X0))
                  >= c(g.I_BIAS2)))
        inside = ((rows >= r_lo[sl, None, None]) & (rows <= r_hi[sl, None, None])
                  & (cols >= c_lo[sl, None, None])
                  & (cols <= c_hi[sl, None, None]))
        covered += int(cov.sum())
        outside += int((cov & ~inside).sum())
    return covered, outside


@pytest.mark.parametrize("name", list(INPUTS))
def test_windows_hold_every_covered_pixel(name):
    (ti, tf), (w, h) = INPUTS[name]()
    prep = tr.prepare_binned_hbm_inputs(ti, tf, w, h)
    ri, tile = _visited_pairs(prep, w, h)
    covered, outside = _covered_outside(ri, tile, w)
    assert covered > 0
    assert outside == 0
    if name in ("padding_soup", "edge_map"):
        # Rows past the geometry's last row or column are drawn by their
        # window, as the whole-tile evaluation drew them.
        z = tr.depth_binned_plain(*prep, w, h)
        geo_h = 80 if name == "padding_soup" else h
        assert name == "edge_map" or (z[geo_h:] < 1.0).sum() > 0
        clamped = ((ti[:, g.I_VALID] > 0)
                   & ((ti[:, g.I_IMIN] > ti[:, g.I_IMAX])
                      | (ti[:, g.I_JMIN] > ti[:, g.I_JMAX])))
        assert int(clamped.sum()) > 0


def _ties_split_across_items(prep, items):
    """Span records that meet a record with the same vertices (a duplicate,
    another id) in one tile from another work item: exact ties that the
    items' merge must break."""
    item_of = torch.repeat_interleave(
        torch.arange(items.shape[0]), items[:, 4] - items[:, 3])
    verts = prep[1][int(prep[0][0]):int(prep[0][-1]), :6].tolist()
    pos = {}
    split = 0
    for it, v in zip(item_of.tolist(), verts):
        key = (int(items[it, 0]), *v)
        split += key in pos and pos[key] != it
        pos[key] = it
    return split


ITEM_CASES = {
    "duplicated_soup_item3": (_duplicated_soup, {}, 3),
    "padding_soup_item2": (_padding_soup, {}, 2),
    "padding_soup_budget_item5": (_padding_soup,
                                  dict(cap=2, pair_budget=40), 5),
    "edge_map_item7": (_edge_map, {}, 7),
    "lattice20k_item64": (_lattice_narrow, {}, 64),
}


@pytest.mark.parametrize("name", list(ITEM_CASES))
def test_items_merged_equal_the_plain_versions(name):
    build, kw, item = ITEM_CASES[name]
    (ti, tf), (w, h) = build()
    prep = tr.prepare_binned_hbm_inputs(ti, tf, w, h, **kw)
    color, depth = tr.raster_binned_plain(*prep, w, h)
    z = tr.depth_binned_plain(*prep, w, h)
    kc, kd = keyed_binned_plain(*prep[:7], w, h, False, item)
    kz = keyed_binned_plain(*prep[:7], w, h, True, item)
    np.testing.assert_array_equal(kc.numpy(), color.numpy())
    _bits(kd.numpy(), depth.numpy())
    _bits(kz.numpy(), z.numpy())
    assert (depth < 1.0).float().mean() > 0.02  # a frame, not a few pixels
    items = tr.keyed_work_items(prep[0], item, prep[3].shape[0])
    assert int((items[:, 2] > 1).sum()) > 0  # some tile is split
    if name.startswith("duplicated"):
        assert _ties_split_across_items(prep, items) > 0
    if "budget" in name:
        assert int((prep[5][:, g.I_VALID] > 0).sum()) > 0  # leftover rows


@pytest.mark.parametrize("seed", range(4))
def test_work_items_cover_each_span_once(seed):
    rng = np.random.default_rng(seed)
    tiles = int(rng.integers(1, 40))
    spans = rng.integers(0, 50, tiles)
    spans[rng.random(tiles) < 0.3] = 0
    # Off-screen rows' records sort below tile 0: spans may start above 0.
    base = int(rng.integers(0, 5))
    offsets = torch.from_numpy(
        (base + np.concatenate([[0], np.cumsum(spans)])).astype(np.int32))
    item = int(rng.integers(1, 20))
    supers = int(rng.integers(0, 9))
    items = tr.keyed_work_items(offsets, item, supers)
    assert items.shape[0] <= tr.keyed_items(
        tr.TILE_W, tr.TILE_H * tiles, int(offsets[-1]), item)
    for t in range(tiles):
        mine = items[items[:, 0] == t]
        assert mine.shape[0] == max(1, -(-int(spans[t]) // item))
        assert (mine[:, 1] == torch.arange(mine.shape[0])).all()
        assert (mine[:, 2] == mine.shape[0]).all()
        # Records: consecutive pieces of at most `item` covering the span.
        assert int(mine[0, 3]) == int(offsets[t])
        assert int(mine[-1, 4]) == int(offsets[t + 1])
        assert (mine[1:, 3] == mine[:-1, 4]).all()
        assert ((mine[:, 4] - mine[:, 3]) <= item).all()
        # Superblocks: consecutive ranges covering [0, supers).
        assert int(mine[0, 5]) == 0 and int(mine[-1, 6]) == supers
        assert (mine[1:, 5] == mine[:-1, 6]).all()
    # Numbered tile by tile.
    assert (items[1:, 0] >= items[:-1, 0]).all()


def _lit_padding_soup():
    """The padding-row soup with the lit columns."""
    return (_rows(*make_jax_soup(200, seed=2, extent=6.0), 256, 80,
                  lit=True, seed=4), (256, 96))


def _lit_duplicated_soup():
    """200 soup triangles and their duplicates (the same vertices, later
    rows) with their own materials: every duplicate ties its original."""
    scene, md = make_jax_soup(200, seed=3, extent=2.0)
    v = md.vertex_data.reshape(-1, 16)
    md2 = MeshData()
    v = np.concatenate([v, v])
    md2.append_mesh(v, np.arange(len(v), dtype=np.uint32))
    return _rows(scene, md2, 256, 128, lit=True, seed=5), (256, 128)


def _lit_pair(za_a=None, za_b=None, w=128, h=32, seed=6):
    """A tall triangle A and a short triangle B inside it, submitted after
    A (tests/test_raster_pallas.py :556-606), through the port's geometry
    on the CPU with random uv, normals and per-triangle materials;
    ``za_a``/``za_b`` replace a row's z-plane coefficients."""
    rng = np.random.default_rng(seed)
    positions = torch.tensor([
        [-0.8, -0.8, 0.5, 1.0], [0.8, -0.8, 0.5, 1.0], [0.0, 0.8, 0.5, 1.0],
        [-0.2, -0.1, 0.3, 1.0], [0.2, -0.1, 0.3, 1.0], [0.0, 0.1, 0.3, 1.0]])
    attrs = torch.from_numpy(rng.random((6, 12), dtype=np.float32))
    ti, tf = tg.geometry_pipeline(
        positions, attrs, torch.tensor([[0, 1, 2], [3, 4, 5]],
                                       dtype=torch.int32),
        torch.eye(4)[None], torch.zeros(6, dtype=torch.int32), w, h,
        normal_matrices=torch.from_numpy(
            rng.standard_normal((1, 3, 3)).astype(np.float32)),
        material_table=torch.from_numpy(
            rng.random((2, g.MATERIAL_COLS), dtype=np.float32)))
    a, b = torch.nonzero(ti[:, g.I_VALID] > 0).flatten().tolist()
    for row, za in ((a, za_a), (b, za_b)):
        if za is not None:
            tf[row, g.F_ZA0:g.F_ZA0 + 3] = torch.tensor(za)
    return (ti, tf), (w, h)


# name: (rows, item size, what the frame must show)
GBUFFER_ITEM_CASES = {
    "padding_soup_item2": (_lit_padding_soup, 2, "padding"),
    "duplicated_soup_item16": (_lit_duplicated_soup, 16, "split_ties"),
    "z_one_item1": (lambda: _lit_pair(za_a=(0.25, 0.0, 0.0)), 1, "z_one"),
    "neg_zero_first_item1": (
        lambda: _lit_pair(za_a=(-0.0,) * 3, za_b=(0.0,) * 3), 1, "neg_zero"),
    "pos_zero_first_item1": (
        lambda: _lit_pair(za_a=(0.0,) * 3, za_b=(-0.0,) * 3), 1, "pos_zero"),
}


@pytest.mark.parametrize("name", list(GBUFFER_ITEM_CASES))
def test_gbuffer_items_merged_equal_the_plain_version(name):
    build, item, shows = GBUFFER_ITEM_CASES[name]
    (ti, tf), (w, h) = build()
    prep = tr.prepare_binned_hbm_inputs(ti, tf, w, h)
    ref = tr.gbuffer_binned_plain(*prep, w, h)
    got = keyed_binned_plain(*prep[:7], w, h, False, item, gbuffer=True)
    assert len(got) == len(ref) == tr.GBUFFER_PLANES
    for a, b in zip(got, ref):
        _bits(a.numpy(), b.numpy())
    depth = ref[1]
    assert int((depth < 1.0).sum()) > 0
    items = tr.keyed_work_items(prep[0], item, prep[3].shape[0])
    if shows in ("padding", "split_ties"):  # many winners' materials
        assert torch.unique(ref[12][depth < 1.0]).numel() > 50
    if shows == "padding":
        assert (depth[80:] < 1.0).sum() > 0  # rows below the geometry
        assert int((items[:, 2] > 1).sum()) > 0
    elif shows == "split_ties":
        assert _ties_split_across_items(prep, items) > 0
    elif shows == "z_one":
        latched = int(((depth == 1.0) & (ref[0] != -(1 << 24))).sum())
        assert latched == 1
    else:
        neg = int((torch.signbit(depth) & (depth == 0.0)).sum())
        assert (neg > 0) == (shows == "neg_zero")


# K4c: K4's keyed body with the coarse class.  A tile's items cut its span
# and then its coarse bin's records as one list; a coarse record whose bbox
# misses the tile adds nothing (record_hits), and one that meets it draws
# over its window.


def _wide_soup():
    """A wide soup at 640x256: 5 x 8 tiles, so 2 x 2 coarse bins with a
    partial column and the bins' tile index in play."""
    return _rows(*make_jax_soup(600, seed=3, extent=6.0), 640, 256), (640,
                                                                       256)


def _coarse_pairs(coarse, w, h):
    """Every (tile, coarse record) K4c evaluates: each record of a tile's
    bin whose bbox meets the tile.  Returns (the records' setup rows (P,
    NI32), tile (P,))."""
    coffsets, crec_i, _ = coarse
    tiles_x = w // tr.TILE_W
    t = torch.arange(tiles_x * (h // tr.TILE_H))
    ctiles_x = -(-tiles_x // tr.COARSE_CB)
    b = ((t // tiles_x // tr.COARSE_CB) * ctiles_x
         + t % tiles_x // tr.COARSE_CB)
    n = (coffsets[b + 1] - coffsets[b]).long()
    tile = torch.repeat_interleave(t, n)
    k = (coffsets[b].long()[tile] + torch.arange(tile.numel())
         - (torch.cumsum(n, 0) - n)[tile])
    ri = crec_i[k]
    keep = record_hits(ri, (tile // tiles_x) * tr.TILE_H,
                       (tile % tiles_x) * tr.TILE_W)
    return ri[keep, :g.NI32].long(), tile[keep]


# name: (rows, prepare arguments beside coarse_cap, item size)
COARSE_CASES = {
    "padding_soup_cap1_item16": (_padding_soup, dict(cap=1), 16),
    "duplicated_soup_cap1_item16": (_duplicated_soup, dict(cap=1), 16),
    "duplicated_soup_cap1_item3": (_duplicated_soup, dict(cap=1), 3),
    "wide_soup_cap2_item16": (_wide_soup, dict(cap=2), 16),
    "padding_soup_budgets_item5": (_padding_soup,
                                   dict(cap=2, pair_budget=40,
                                        coarse_budget=30), 5),
}


def _coarse_prep(name):
    build, kw, item = COARSE_CASES[name]
    (ti, tf), (w, h) = build()
    prep = tr.prepare_binned_hbm_inputs(
        ti, tf, w, h, coarse_cap=tr.TILE_LISTS_COARSE_CAP, **kw)
    return prep, (ti, tf), (w, h), item


@pytest.mark.parametrize("name", list(COARSE_CASES))
def test_coarse_windows_hold_every_drawn_pixel(name):
    prep, _, (w, h), _ = _coarse_prep(name)
    ri, tile = _coarse_pairs(prep[7], w, h)
    covered, outside = _covered_outside(ri, tile, w)
    assert covered > 0
    assert outside == 0


@pytest.mark.parametrize("name", list(COARSE_CASES))
def test_coarse_items_merged_equal_the_plain_version(name):
    prep, (ti, tf), (w, h), item = _coarse_prep(name)
    coarse = prep[7]
    assert int(coarse[0][-1] - coarse[0][0]) > 0  # a coarse class
    color, depth = tr.raster_binned_plain(*prep, w, h)
    kc, kd = keyed_binned_plain(*prep[:7], w, h, False, item, coarse=coarse)
    np.testing.assert_array_equal(kc.numpy(), color.numpy())
    _bits(kd.numpy(), depth.numpy())
    # The (z, row id) minimum is order-free: K4's frame in the geometry's
    # rows.  (Below them, in the padding soup's rows 80-95, a row draws as
    # its class lets it: listed, by its window; coarse, where its clamped
    # bbox meets the tile; leftover, not at all.)
    c4, d4 = tr.raster_binned_plain(
        *tr.prepare_binned_hbm_inputs(ti, tf, w, h), w, h)
    geo_h = 80 if name.startswith("padding") else h
    np.testing.assert_array_equal(kc[:geo_h].numpy(), c4[:geo_h].numpy())
    _bits(kd[:geo_h].numpy(), d4[:geo_h].numpy())
    assert (depth < 1.0).float().mean() > 0.02
    items = tr.keyed_work_items(prep[0], item, prep[3].shape[0], coarse[0],
                                w // tr.TILE_W)
    in_coarse = items[:, 8] > items[:, 7]
    # Some tile's coarse records span several items.
    split = items[in_coarse, 0].bincount(minlength=1)
    assert int(split.max()) > 1
    if name.startswith("duplicated"):
        # Duplicates share a bin: exact ties across the coarse items.
        assert int(in_coarse.sum()) > 1
    if "budgets" in name:
        assert int((prep[5][:, g.I_VALID] > 0).sum()) > 0  # leftover rows


@pytest.mark.parametrize("seed", range(4))
def test_coarse_work_items_cover_each_list_once(seed):
    rng = np.random.default_rng(10 + seed)
    tiles_x, tiles_y = (int(x) for x in rng.integers(1, 10, 2))
    tiles = tiles_x * tiles_y
    ctiles_x = -(-tiles_x // tr.COARSE_CB)
    bins = ctiles_x * -(-tiles_y // tr.COARSE_CB)
    spans = rng.integers(0, 30, tiles)
    spans[rng.random(tiles) < 0.3] = 0
    cspans = rng.integers(0, 60, bins)
    cspans[rng.random(bins) < 0.3] = 0
    offsets = torch.from_numpy((int(rng.integers(0, 5)) + np.concatenate(
        [[0], np.cumsum(spans)])).astype(np.int32))
    coffsets = torch.from_numpy((int(rng.integers(0, 5)) + np.concatenate(
        [[0], np.cumsum(cspans)])).astype(np.int32))
    item = int(rng.integers(1, 20))
    supers = int(rng.integers(0, 9))
    items = tr.keyed_work_items(offsets, item, supers, coffsets, tiles_x)
    assert items.shape[0] <= tr.keyed_items(
        tr.TILE_W * tiles_x, tr.TILE_H * tiles_y, int(offsets[-1]), item,
        int(coffsets[-1]))
    for t in range(tiles):
        b = (t // tiles_x // tr.COARSE_CB) * ctiles_x + (
            t % tiles_x // tr.COARSE_CB)
        mine = items[items[:, 0] == t]
        n = int(spans[t]) + int(cspans[b])
        assert mine.shape[0] == max(1, -(-n // item))
        assert (mine[:, 1] == torch.arange(mine.shape[0])).all()
        assert (mine[:, 2] == mine.shape[0]).all()
        # The span, then the bin's records, consecutive pieces of at most
        # `item` records together, every piece but the last full.
        sizes = (mine[:, 4] - mine[:, 3]) + (mine[:, 8] - mine[:, 7])
        assert int(sizes.sum()) == n
        assert (sizes[:-1] == item).all() and (sizes <= item).all()
        assert int(mine[0, 3]) == int(offsets[t])
        assert int(mine[-1, 4]) == int(offsets[t + 1])
        assert (mine[1:, 3] == mine[:-1, 4]).all()
        assert int(mine[0, 7]) == int(coffsets[b])
        assert int(mine[-1, 8]) == int(coffsets[b + 1])
        assert (mine[1:, 7] == mine[:-1, 8]).all()
        # An item reads the bin only after the span's end.
        starts_bin = mine[:, 8] > mine[:, 7]
        assert (mine[starts_bin, 4] == int(offsets[t + 1])).all()
        # Superblocks: consecutive ranges covering [0, supers).
        assert int(mine[0, 5]) == 0 and int(mine[-1, 6]) == supers
        assert (mine[1:, 5] == mine[:-1, 6]).all()
    assert (items[1:, 0] >= items[:-1, 0]).all()


# K6d: K4d's keyed body over row-id spans.  The entry stages each listed
# row from hier (its bbox and valid flag emptied by the prepare, so that
# the leftover walk skips it) and tf by its id, with the id after its ints:
# the records of a K4 prepare whose spans are pair_tri's.


def lists_as_records(prep):
    """K6's prepare (offsets, pair_tri, supers, blocks, hier, tf) as K6d's
    row-id entry stages it: a K4-shaped prepare whose record k is row
    pair_tri[k] of hier and tf, its id last, and no coarse class."""
    offsets, pair_tri, supers, blocks, hier, tf = prep
    rec_i, rec_f = tr._gather_records(hier, tf, pair_tri)
    return offsets, rec_i, rec_f, supers, blocks, hier, tf, None


@pytest.mark.parametrize("name", list(INPUTS))
def test_row_id_windows_hold_every_covered_pixel(name):
    (ti, tf), (w, h) = INPUTS[name]()
    prep = tr.prepare_binned_inputs(ti, tf, w, h)
    recs = lists_as_records(prep)
    first, end = int(prep[0][0]), int(prep[0][-1])
    listed = recs[1][first:end]
    assert end - first > 0
    # The staged rows' bboxes are empty: a window from I_JMIN..I_IMAX, or a
    # test of I_VALID, would let no listed row draw.
    assert (listed[:, g.I_JMIN] > listed[:, g.I_JMAX]).all()
    assert (listed[:, g.I_VALID] == 0).all()
    ri, tile = _visited_pairs(recs, w, h)
    covered, outside = _covered_outside(ri, tile, w)
    span_covered, _ = _covered_outside(listed.long(), tile[:end - first], w)
    assert span_covered > 0
    assert covered > 0
    assert outside == 0


def _pair(za_a, za_b):
    """_lit_pair's rows (A submitted before B, B inside A) with the z
    planes ``za_a`` and ``za_b``."""
    return _lit_pair(za_a=za_a, za_b=za_b)


def _lists_frame_shows(prep, recs, item, color, depth, shows):
    """What a K6d, K6 or K6g case's frame (``color``, None for K6d's map;
    ``depth``) must show: A, visited first and of the lower id, keeps its
    zero's sign."""
    assert int((depth < 1.0).sum()) > 0
    items = tr.keyed_work_items(prep[0], item, prep[2].shape[0])
    assert int(prep[0][-1] - prep[0][0]) > 0  # row-id spans
    if shows in ("padding", "split", "split_ties"):
        assert int((items[:, 2] > 1).sum()) > 0  # some tile is split
    if shows == "padding":
        assert (depth[80:] < 1.0).sum() > 0  # rows below the geometry
    elif shows == "leftovers":
        assert int((prep[4][:, g.I_VALID] > 0).sum()) > 0
    elif shows == "split_ties":
        assert _ties_split_across_items(recs, items) > 0
    elif shows == "z_one":  # the (z, row id) test latches z == 1.0
        latched = int(((depth == 1.0) & (color != -(1 << 24))).sum())
        assert latched == 1
    elif shows.endswith("zero"):
        assert int((depth == 0.0).sum()) > 0
        neg = int((torch.signbit(depth) & (depth == 0.0)).sum())
        assert (neg > 0) == (shows == "neg_zero")


# name: (rows, prepare arguments, item size, what the map must show)
LISTS_ITEM_CASES = {
    "padding_soup_item2": (_padding_soup, {}, 2, "padding"),
    "padding_soup_cap1_item5": (_padding_soup, dict(cap=1), 5, "leftovers"),
    "duplicated_soup_item16": (_duplicated_soup, {}, 16, "split_ties"),
    "edge_map_item7": (_edge_map, {}, 7, "split"),
    "lattice20k_item64": (_lattice_narrow, {}, 64, "split"),
    "neg_zero_first_item1": (
        lambda: _pair((-0.0,) * 3, (0.0,) * 3), {}, 1, "neg_zero"),
    "pos_zero_first_item1": (
        lambda: _pair((0.0,) * 3, (-0.0,) * 3), {}, 1, "pos_zero"),
}


@pytest.mark.parametrize("name", list(LISTS_ITEM_CASES))
def test_row_id_items_merged_equal_the_plain_k6d(name):
    build, kw, item, shows = LISTS_ITEM_CASES[name]
    (ti, tf), (w, h) = build()
    prep = tr.prepare_binned_inputs(ti, tf, w, h, **kw)
    z = tr.depth_lists_plain(*prep, w, h)
    recs = lists_as_records(prep)
    kz = keyed_binned_plain(*recs[:7], w, h, True, item)
    _bits(kz.numpy(), z.numpy())
    _lists_frame_shows(prep, recs, item, None, z, shows)


# K6 and K6g: K4's and K4g's keys over the same row-id entry (FlatKeys and
# GbufKeys: a listed row's tag is its row id, staged after its ints, which
# the leftover walk tags its rows by too), the winner resolved from hier.


LISTS_FLAT_CASES = {
    **LISTS_ITEM_CASES,
    "z_one_item1": (lambda: _pair((0.25, 0.0, 0.0), None), {}, 1, "z_one"),
}


@pytest.mark.parametrize("name", list(LISTS_FLAT_CASES))
def test_row_id_items_merged_equal_the_plain_k6(name):
    build, kw, item, shows = LISTS_FLAT_CASES[name]
    (ti, tf), (w, h) = build()
    prep = tr.prepare_binned_inputs(ti, tf, w, h, **kw)
    color, depth = tr.raster_lists_plain(*prep, w, h)
    recs = lists_as_records(prep)
    kc, kd = keyed_binned_plain(*recs[:7], w, h, False, item)
    np.testing.assert_array_equal(kc.numpy(), color.numpy())
    _bits(kd.numpy(), depth.numpy())
    _lists_frame_shows(prep, recs, item, color, depth, shows)


def _lit_lattice_narrow():
    """The 20K lattice at 256x128 with the lit columns."""
    return (_rows(*make_stress_scene(20000), 256, 128, tri_align=256,
                  lit=True, seed=7), (256, 128))


# name: (lit rows, prepare arguments, item size, what the frame must show)
LISTS_GBUFFER_CASES = {
    "lattice20k_item64": (_lit_lattice_narrow, {}, 64, "split"),
    "padding_soup_item2": (_lit_padding_soup, {}, 2, "padding"),
    "padding_soup_cap1_item5": (_lit_padding_soup, dict(cap=1), 5,
                                "leftovers"),
    "duplicated_soup_item16": (_lit_duplicated_soup, {}, 16, "split_ties"),
    "z_one_item1": (lambda: _pair((0.25, 0.0, 0.0), None), {}, 1, "z_one"),
    "neg_zero_first_item1": (
        lambda: _pair((-0.0,) * 3, (0.0,) * 3), {}, 1, "neg_zero"),
    "pos_zero_first_item1": (
        lambda: _pair((0.0,) * 3, (-0.0,) * 3), {}, 1, "pos_zero"),
}


@pytest.mark.parametrize("name", list(LISTS_GBUFFER_CASES))
def test_row_id_items_merged_equal_the_plain_k6g(name):
    build, kw, item, shows = LISTS_GBUFFER_CASES[name]
    (ti, tf), (w, h) = build()
    prep = tr.prepare_binned_inputs(ti, tf, w, h, **kw)
    ref = tr.gbuffer_lists_plain(*prep, w, h)
    recs = lists_as_records(prep)
    got = keyed_binned_plain(*recs[:7], w, h, False, item, gbuffer=True)
    assert len(got) == len(ref) == tr.GBUFFER_PLANES
    for a, b in zip(got, ref):
        _bits(a.numpy(), b.numpy())
    if shows in ("padding", "split_ties"):  # many winners' materials
        assert torch.unique(ref[12][ref[1] < 1.0]).numel() > 50
    _lists_frame_shows(prep, recs, item, ref[0], ref[1], shows)


@pytest.mark.parametrize("gbuffer", [False, True], ids=["k6", "k6g"])
def test_row_id_resolve_reads_the_winner_unchanged_from_hier(gbuffer):
    """The resolve reads each winner back from ``hier``, where the prepare
    emptied the listed rows' bbox and valid flag: the planes equal those
    resolved from the unemptied setup rows, while rows with moved vertices
    would change them (so listed rows win pixels)."""
    (ti, tf), (w, h) = (_lit_padding_soup if gbuffer else _padding_soup)()
    prep = tr.prepare_binned_inputs(ti, tf, w, h)
    offsets, pair_tri, hier = prep[0], prep[1], prep[4]
    setup = tr._pad_rows(ti, tf)[0]
    assert setup.shape == hier.shape
    changed = torch.nonzero((hier != setup).any(0)).flatten().tolist()
    assert changed == sorted([g.I_JMIN, g.I_JMAX, g.I_VALID])
    listed = torch.unique(pair_tri[int(offsets[0]):int(offsets[-1])].long())
    assert (hier[listed, g.I_JMIN] > hier[listed, g.I_JMAX]).all()
    recs = lists_as_records(prep)

    def resolved(rows):
        return keyed_binned_plain(*recs[:7], w, h, False, 4, gbuffer=gbuffer,
                                  resolve_ti=rows)

    from_hier = resolved(None)
    for a, b in zip(from_hier, resolved(setup)):
        _bits(a.numpy(), b.numpy())
    moved = setup.clone()
    moved[listed, g.I_X1] += 8 * tg.SUBPIXEL
    assert not torch.equal(resolved(moved)[1], from_hier[1])


def test_resolve_winner_reads_no_bbox_or_valid_word():
    """csrc/raster_common.cuh ``resolve_winner``, the keyed stores' and the
    register bodies' epilogue, reads a winner's edge, z and colour words,
    never the bbox or valid flag the prepares empty in ``hier``."""
    src = (Path(tr.__file__).resolve().parent.parent / "csrc"
           / "raster_common.cuh").read_text()
    body = src[src.index("void resolve_winner("):]
    body = body[:body.index("\n}\n")]
    assert "I_DX0" in body and "F_ZA0" in body and "F_CR0" in body
    for word in ("I_JMIN", "I_JMAX", "I_IMIN", "I_IMAX", "I_VALID"):
        assert word not in body


def test_row_id_work_items_cover_each_span_once():
    (ti, tf), (w, h) = _lattice_narrow()
    offsets, pair_tri, supers = tr.prepare_binned_inputs(ti, tf, w, h)[:3]
    items = tr.keyed_work_items(offsets, ITEM_SMALL, supers.shape[0])
    # The launch's grid counts every slot of pair_tri (n_head * cap, far
    # more than the spans use): never fewer blocks than items.
    assert pair_tri.shape[0] > 4 * int(offsets[-1])
    assert items.shape[0] <= tr.keyed_items(w, h, pair_tri.shape[0],
                                            ITEM_SMALL)
    for t in range(offsets.shape[0] - 1):
        mine = items[items[:, 0] == t]
        assert mine.shape[0] == max(
            1, -(-int(offsets[t + 1] - offsets[t]) // ITEM_SMALL))
        assert int(mine[0, 3]) == int(offsets[t])
        assert int(mine[-1, 4]) == int(offsets[t + 1])
        assert (mine[1:, 3] == mine[:-1, 4]).all()
        assert ((mine[:, 4] - mine[:, 3]) <= ITEM_SMALL).all()
    assert int((items[:, 4] - items[:, 3]).sum()) == int(offsets[-1]
                                                         - offsets[0])


ITEM_SMALL = 16


def item_bound(offsets, item_records, num_tiles, coffsets=None):
    """csrc/raster_binned.cu ``item_bound``: the tiles plus one item per
    ``item_records`` of every list's records (from its ends; a coarse
    bin's records counted COARSE_CB**2 times)."""
    offs = offsets.reshape(-1, offsets.shape[-1]).long()
    n = int((offs[:, num_tiles] - offs[:, 0]).sum())
    if coffsets is not None:
        n += tr.COARSE_CB**2 * int(coffsets[-1] - coffsets[0])
    return num_tiles + n // item_records


@pytest.mark.parametrize("form", ["one_list", "sources", "coarse"])
@pytest.mark.parametrize("seed", range(4))
def test_item_bound_holds_every_item(seed, form):
    rng = np.random.default_rng(20 + seed)
    tiles_x, tiles_y = (int(x) for x in rng.integers(1, 10, 2))
    tiles = tiles_x * tiles_y
    n_src = int(rng.integers(2, 5)) if form == "sources" else 1

    def spans(n, hi):
        x = rng.integers(0, hi, n)
        x[rng.random(n) < 0.3] = 0
        return torch.from_numpy((int(rng.integers(0, 5)) + np.concatenate(
            [[0], np.cumsum(x)])).astype(np.int32))

    offsets = torch.stack([spans(tiles, 40) for _ in range(n_src)])
    if form != "sources":
        offsets = offsets[0]
    coffsets = None
    if form == "coarse":
        ctiles_x = -(-tiles_x // tr.COARSE_CB)
        coffsets = spans(ctiles_x * -(-tiles_y // tr.COARSE_CB), 60)
    for item in (1, 3, 16, 256):
        items = tr.keyed_work_items(offsets, item, 4, coffsets, tiles_x)
        bound = item_bound(offsets, item, tiles, coffsets)
        assert items.shape[0] <= bound
        records = int(offsets.reshape(-1, tiles + 1)[:, -1].max())
        coarse = 0 if coffsets is None else int(coffsets[-1])
        assert bound <= tr.keyed_items(tr.TILE_W * tiles_x,
                                       tr.TILE_H * tiles_y, n_src * records,
                                       item, coarse)


def test_min_item_records_equals_the_kernels():
    """csrc/raster_binned.cu's MIN_ITEM_RECORDS, which item_size halves
    to, against the mirror that keyed_item_records uses."""
    cu = (Path(tr.__file__).resolve().parent.parent / "csrc"
          / "raster_binned.cu")
    found = re.findall(r"constexpr int MIN_ITEM_RECORDS = (\d+);",
                       cu.read_text())
    assert [int(x) for x in found] == [tr.MIN_ITEM_RECORDS]


@pytest.mark.parametrize("form", ["one_list", "sources", "coarse"])
@pytest.mark.parametrize("seed", range(4))
def test_halved_item_size_stays_within_the_grid(seed, form):
    """The item size the kernel picks from the lists' records: the largest
    item, halved (while even and at least MIN_ITEM_RECORDS) only while the
    lists would make fewer than min_items items; the items at that size fit
    the launch's grid, which the buffers' sizes and min_items give."""
    rng = np.random.default_rng(40 + seed)
    tiles_x, tiles_y = (int(x) for x in rng.integers(1, 17, 2))
    tiles = tiles_x * tiles_y
    n_src = 3 if form == "sources" else 1
    offsets = torch.stack([torch.from_numpy(np.concatenate(
        [[0], np.cumsum(rng.integers(0, 300, tiles))]).astype(np.int32))
        for _ in range(n_src)])
    coffsets = None
    slots = n_src * int(offsets[:, -1].max()) + int(rng.integers(0, 5000))
    coarse_slots = 0
    if form == "coarse":
        ctiles_x = -(-tiles_x // tr.COARSE_CB)
        bins = ctiles_x * -(-tiles_y // tr.COARSE_CB)
        coffsets = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(rng.integers(0, 200, bins))]).astype(np.int32))
        coarse_slots = int(coffsets[-1])
    else:
        offsets = offsets if form == "sources" else offsets[0]
    records = item_bound(offsets, 1, tiles, coffsets) - tiles
    w, h = tr.TILE_W * tiles_x, tr.TILE_H * tiles_y
    for item in (16, 48, 256):
        for min_items in (0, 64, 2048):
            size = tr.keyed_item_records(records, tiles, item, min_items)
            assert tr.MIN_ITEM_RECORDS <= size <= item or size == item
            assert item % size == 0
            if size < item:  # halved: the size above made too few items
                assert tiles + records // (2 * size) < min_items
            if size % 2 == 0 and size // 2 >= tr.MIN_ITEM_RECORDS:
                assert tiles + records // size >= min_items
            items = tr.keyed_work_items(offsets, size, 4, coffsets, tiles_x)
            assert items.shape[0] <= item_bound(offsets, size, tiles,
                                                coffsets)
            assert items.shape[0] <= tr.keyed_items(w, h, slots, item,
                                                    coarse_slots, min_items)
