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
  span once.

The plain K9 is held against the JAX package's band kernel by
tests/test_torch_bands.py and tests/test_torch_bands_interpret.py; the CUDA
kernel against the plain version on the card by chip_smoke.py (phases 4s
and 5m).
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_binned_keys import (_duplicated_soup, _edge_map,
                                    _lattice_narrow, _ties_split_across_items,
                                    keyed_binned_plain)
from test_torch_raster import _bits
from zrenderer_tpu_torch.ops import raster as tr

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
