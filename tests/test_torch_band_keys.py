"""K9 on the keyed record body (zrenderer_tpu_torch/csrc/raster_binned.cu
``keyed_records`` with a row base: the band's tiles, windows and edge
functions in global rows, its planes and key plane band-local), through the
keyed mirror of tests/test_torch_binned_keys.py (``keyed_binned_plain``
with ``row0``) and ``ops/raster.py``'s ``keyed_work_items``:

* each band of 2 and of 4, with the band-local spans and with the frame's
  spans read from the band's first tile, cut into work items of 16
  records (the duplicated soup's exact ties split across items), merged
  and resolved, equals ``raster_binned_band_plain`` bit for bit, and the
  band's rows of the single-device frame (``raster_binned_plain``), so the
  bands laid side by side equal the frame;
* the items of a band, in either span form, stay within the launch's
  bound (``keyed_items`` over the band's rows) and cover each band tile's
  span once;
* K9d (K9's keyed body over each tile's spans of every source shard, laid
  end to end): each band of a 4096-triangle soup from 2 and from 4
  shards, under the default slab and under a 16-record slab (256 after
  rounding) that demotes rows to the owner's hierarchy, cut into items of
  16 records (some reading two sources' spans), merged and resolved,
  equals ``raster_binned_band_plain`` over ``prepare_binned_dist_owner``'s
  outputs bit for bit, and the band's rows of the single-device frame;
  the resolve reads each winner from the canonical rows by the record's
  canonical id; the items cover each source's span of each tile once,
  within both the launch's bound and the kernel's ``item_bound``.

The plain K9 and K9d are held against the JAX package's band kernels by
tests/test_torch_bands.py and tests/test_torch_bands_interpret.py; the CUDA
kernels against the plain versions on the card by chip_smoke.py (phases
4s and 5m).
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_binned_keys import (_duplicated_soup, _edge_map,
                                    _lattice_narrow, _ties_split_across_items,
                                    item_bound, keyed_binned_plain)
from test_torch_raster import _bits
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.scene.procedural import make_triangle_soup
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.parallel import tiles

ITEM = 16
INPUTS = {"duplicated_soup": _duplicated_soup,
          "lattice20k_256x128": _lattice_narrow, "edge_map": _edge_map}
BANDS = [(n, b) for n in (2, 4) for b in range(n)]


@functools.cache
def _rows(name):
    return INPUTS[name]()


@functools.cache
def _single_frame(name):
    (ti, tf), (w, h) = _rows(name)
    return tr.raster_binned_plain(*tr.prepare_binned_hbm_inputs(ti, tf, w, h),
                                  w, h)


def _band_prep(name, n_bands, band, local):
    (ti, tf), (w, h) = _rows(name)
    band_h = h // n_bands
    row0 = band * band_h
    kw = (dict(band_ty0=row0 // tr.TILE_H, band_tiles_y=band_h // tr.TILE_H)
          if local else {})
    prep = tr.prepare_binned_hbm_inputs(
        ti, tf, w, h, pair_budget=tr.band_pair_budget(n_bands), **kw)
    return prep, w, band_h, row0


@pytest.mark.parametrize("local", [True, False], ids=["band_local", "global"])
@pytest.mark.parametrize("n_bands, band", BANDS,
                         ids=[f"band{b}of{n}" for n, b in BANDS])
@pytest.mark.parametrize("name", list(INPUTS))
def test_band_items_merged_equal_the_plain_band(name, n_bands, band, local):
    prep, w, band_h, row0 = _band_prep(name, n_bands, band, local)
    color, depth = tr.raster_binned_band_plain(*prep, w, band_h, row0, local)
    kc, kd = keyed_binned_plain(*prep[:7], w, band_h, False, ITEM, row0=row0,
                                band_local=local)
    np.testing.assert_array_equal(kc.numpy(), color.numpy())
    _bits(kd.numpy(), depth.numpy())
    c1, d1 = _single_frame(name)
    np.testing.assert_array_equal(kc.numpy(),
                                  c1[row0:row0 + band_h].numpy())
    _bits(kd.numpy(), d1[row0:row0 + band_h].numpy())
    assert (d1 < 1.0).float().mean() > 0.02  # a frame, not a few pixels
    if name == "duplicated_soup" and local and n_bands == 2:
        items = tr.keyed_work_items(prep[0], ITEM, prep[3].shape[0])
        assert _ties_split_across_items(prep, items) > 0


@pytest.mark.parametrize("local", [True, False], ids=["band_local", "global"])
@pytest.mark.parametrize("n_bands, band", BANDS,
                         ids=[f"band{b}of{n}" for n, b in BANDS])
def test_band_work_items_cover_the_band_spans(n_bands, band, local):
    prep, w, band_h, row0 = _band_prep("lattice20k_256x128", n_bands, band,
                                       local)
    tiles_x = w // tr.TILE_W
    band_tiles = tiles_x * (band_h // tr.TILE_H)
    base = 0 if local else (row0 // tr.TILE_H) * tiles_x
    offsets = prep[0][base:base + band_tiles + 1]
    items = tr.keyed_work_items(offsets, ITEM, prep[3].shape[0])
    # The launch's bound counts every record the prepare holds, the other
    # bands' too in the global form: never fewer blocks than items.
    assert items.shape[0] <= tr.keyed_items(w, band_h, prep[1].shape[0],
                                            ITEM)
    assert int(items[:, 0].max()) == band_tiles - 1
    for t in range(band_tiles):
        mine = items[items[:, 0] == t]
        assert int(mine[0, 3]) == int(offsets[t])
        assert int(mine[-1, 4]) == int(offsets[t + 1])
        assert (mine[1:, 3] == mine[:-1, 4]).all()
    assert (items[:, 4] - items[:, 3]).sum() == int(offsets[-1] - offsets[0])


# K9d: the band owner's spans of every source shard.  A 4096-triangle soup
# at 256x128 (2 x 4 tiles), set up by the JAX package's NumPy geometry on
# each shard and gathered to the canonical rows as the sharded frame does.
DIST_W, DIST_H = 256, 128
DIST_BANDS = [(n, b, slab) for n in (2, 4) for b in range(n)
              for slab in (16, None)]


@functools.cache
def _dist_shards(n):
    """(every shard's setup rows, the gathered canonical rows, the shard's
    triangles) of the soup in ``n`` shards."""
    w, h = DIST_W, DIST_H
    scene, md = make_triangle_soup(4096, seed=17, extent=2.0,
                                   triangle_size=0.5,
                                   behind_camera_fraction=0.1)
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    s = len(flat.tri_vidx) // n
    locals_ = [tuple(map(torch.from_numpy, g.geometry_pipeline(
        np, flat.positions, flat.attrs, flat.tri_vidx[r * s:(r + 1) * s],
        mats, flat.vert_node, w, h))) for r in range(n)]
    return locals_, *tiles.gather_rows(tiles.InTurnExchange(n), locals_, s), s


@functools.cache
def _dist_received(n, slab):
    locals_, _, _, s = _dist_shards(n)
    return tiles.dist_exchange(tiles.InTurnExchange(n), locals_, DIST_W,
                               DIST_H, s, slab_records=slab)


def _dist_prep(n, band, slab):
    _, ti, tf, _ = _dist_shards(n)
    prep = tr.prepare_binned_dist_owner(ti, tf, *_dist_received(n, slab)[band])
    band_h = DIST_H // n
    return prep, band_h, band * band_h


@functools.cache
def _dist_single_frame(n):
    _, ti, tf, _ = _dist_shards(n)
    return tr.rasterize_setup(ti, tf, DIST_W, DIST_H)


def _sources_read(items, n_src):
    """Sources whose span each item reads records of."""
    ranges = [items[:, 3:5]] + [items[:, 7 + 2 * k:9 + 2 * k]
                                for k in range(n_src - 1)]
    return sum((r[:, 1] > r[:, 0]).long() for r in ranges)


@pytest.mark.parametrize("n_src, band, slab", DIST_BANDS,
                         ids=[f"band{b}of{n}-slab{slab or 'default'}"
                              for n, b, slab in DIST_BANDS])
def test_dist_items_merged_equal_the_plain_band(n_src, band, slab):
    prep, band_h, row0 = _dist_prep(n_src, band, slab)
    assert prep[0].shape == (n_src, DIST_W // tr.TILE_W * band_h // tr.TILE_H
                             + 1)
    color, depth = tr.raster_binned_band_plain(*prep, DIST_W, band_h, row0)
    kc, kd = keyed_binned_plain(*prep[:7], DIST_W, band_h, False, ITEM,
                                row0=row0)
    np.testing.assert_array_equal(kc.numpy(), color.numpy())
    _bits(kd.numpy(), depth.numpy())
    c1, d1 = _dist_single_frame(n_src)
    np.testing.assert_array_equal(kc.numpy(),
                                  c1[row0:row0 + band_h].numpy())
    _bits(kd.numpy(), d1[row0:row0 + band_h].numpy())
    assert int((depth < 1.0).sum()) > 0  # the soup fills the middle bands
    received = _dist_received(n_src, slab)
    sent = sum(int(r[3][:, -1].sum()) for r in received)
    wanted = sum(int(r[3][:, -1].sum()) for r in _dist_received(n_src, None))
    assert (sent < wanted) == (slab == 16)  # rows demoted to the hierarchy
    if band in (1, 2):  # the soup's middle bands: busy tiles of every source
        assert (depth < 1.0).float().mean() > 0.02
        items = tr.keyed_work_items(prep[0], ITEM, prep[3].shape[0])
        assert int((_sources_read(items, n_src) > 1).sum()) > 0


@pytest.mark.parametrize("n_src", [2, 4])
def test_dist_winners_are_canonical_rows(n_src):
    """A record's last int is the canonical id of its row: the gathered
    rows hold the record's ints there, so the resolve re-evaluates the
    winner the record drew."""
    prep, _, _ = _dist_prep(n_src, 1, None)
    offsets, rec_i, rec_f, _, _, hier, tf = prep[:7]
    used = torch.cat([torch.arange(int(o[0]), int(o[-1])) for o in offsets])
    ids = rec_i[used, g.NI32].long()
    assert ids.unique().numel() > 100
    verts = [g.I_X0, g.I_Y0, g.I_X1, g.I_Y1, g.I_X2, g.I_Y2, g.I_DX0,
             g.I_DY0, g.I_DX1, g.I_DY1, g.I_DX2, g.I_DY2, g.I_BIAS0,
             g.I_BIAS1, g.I_BIAS2]
    assert torch.equal(rec_i[used][:, verts], hier[ids][:, verts])
    assert torch.equal(rec_f[used].view(torch.int32),
                       tf[ids].view(torch.int32))


@pytest.mark.parametrize("n_src", [2, 4])
def test_dist_work_items_cover_each_source_span(n_src):
    prep, band_h, _ = _dist_prep(n_src, 1, None)
    offsets = prep[0]
    tiles_n = offsets.shape[1] - 1
    items = tr.keyed_work_items(offsets, ITEM, prep[3].shape[0])
    assert items.shape[1] == 7 + 2 * (n_src - 1)
    assert items.shape[0] <= item_bound(offsets, ITEM, tiles_n)
    assert item_bound(offsets, ITEM, tiles_n) <= tr.keyed_items(
        DIST_W, band_h, prep[1].shape[0], ITEM)
    cols = [(3, 4)] + [(7 + 2 * k, 8 + 2 * k) for k in range(n_src - 1)]
    for t in range(tiles_n):
        mine = items[items[:, 0] == t]
        n = int((offsets[:, t + 1] - offsets[:, t]).sum())
        assert mine.shape[0] == max(1, -(-n // ITEM))
        sizes = sum(mine[:, e] - mine[:, b] for b, e in cols)
        assert int(sizes.sum()) == n
        assert (sizes[:-1] == ITEM).all() and (sizes <= ITEM).all()
        for src, (b, e) in enumerate(cols):
            assert int(mine[0, b]) == int(offsets[src, t])
            assert int(mine[-1, e]) == int(offsets[src, t + 1])
            assert (mine[1:, b] == mine[:-1, e]).all()
        # A source's records come after every earlier source's.
        for k in range(1, n_src):
            starts = mine[:, cols[k][1]] > mine[:, cols[k][0]]
            for b, e in cols[:k]:
                assert (mine[starts, e] == offsets[cols.index((b, e)),
                                                   t + 1]).all()
