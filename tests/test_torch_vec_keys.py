"""K10vec's CUDA rules (zrenderer_tpu_torch/csrc/raster_vec.cu), emulated in
torch by ``raster_vec``'s ``admitted_rows``, ``window_rects``,
``window_keys`` and ``key_planes``, against the plain version
``raster_vec_plain``: each tile's hit blocks (``raster.hier_block_hits``)
cut into work items (``raster.hier_work_items``), every live row of a
subgroup with a hit chunk pended, each over its vertices' pixel bbox in
the tile within its subgroup's hit chunks, one (order bits of z, row id)
key a pixel from the strict clear key (1.0, 0), the items' keys merged by
minimum, the planes resolved from the winners' records.  Packed colour and
depth bits equal in every row, the padding rows included, at 1 and
VEC_ITEMS items a tile: the padded soup (no padding-row pixel), exact
twins (the first row wins), the test scene, a -0.0/+0.0 tie both ways, a
row at z == 1.0 (the pixel stays clear) and the empty scene.  K10vecg's
store (``key_planes(..., gbuffer=True)``: K3g's epilogue covered ? buf *
inv : 0 from the winner's record) on the same cases at 1, 2 and 16
items: its 13 planes bit-equal to ``gbuffer_vec_plain``.  A counter-case
shows why the windows are cut to the hit chunks: over the whole tile the
visible rows stay equal but the padding rows draw, in every G-buffer
plane too.
"""

import pytest
import torch

from test_torch_group8 import _bits
from test_torch_group8_keys import gbuffer_clear, lit_columns
from test_torch_vec import twin_soup_setup
from test_torch_vis_trans import empty_setup, padded_setup, pair_case, setup
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_vec as rv

torch.set_num_threads(1)

T = torch.from_numpy

CASES = {
    "padded_soup_128x64": padded_setup,
    "twin_soup_256x64": twin_soup_setup,
    "test_scene_256x64": lambda: setup("test_scene_256x64"),
    # An exact tie at z == 0: A's -0.0 against B's +0.0, then the other
    # way; the first row, A, keeps its sign.
    "neg_zero_first_128x32": pair_case((-0.0,) * 3, (0.0,) * 3),
    "neg_zero_second_128x32": pair_case((0.0,) * 3, (-0.0,) * 3),
    # A at z = e0 / 4: exactly 1.0 on one covered pixel, which stays clear.
    "z_one_128x32": pair_case((0.25, 0.0, 0.0)),
    "empty_128x32": empty_setup,
}


def kernel_planes(prep, w, h, items, chunks=True, gbuffer=False):
    """K10vec's planes from its rules: each admitted (tile, row) pair over
    its window (within its subgroup's hit chunks unless ``chunks`` is
    False), keyed by its tile's work item of ``items``, the items' keys
    minimum-merged into the key plane, resolved.  Returns (packed, depth,
    admitted rows); with ``gbuffer`` K10vecg's 13 planes in place of the
    two."""
    supers, blocks, rec = prep
    hits = tr.hier_block_hits(supers, blocks, w, h)
    rows, ty, tx = rv.admitted_rows(hits, rec, w)
    rects = rv.window_rects(rec, rows, ty, tx, chunks=chunks)
    item = tr.hier_work_items(hits, items)[ty * (w // tr.TILE_W) + tx,
                                           rows // g.RASTER_BLOCK]
    assert bool((item >= 0).all())
    plane = torch.full((h * w,), rv.KEY_CLEAR, dtype=torch.int64)
    for i in range(items):
        sel = item == i
        keys = torch.full((h * w,), rv.KEY_CLEAR, dtype=torch.int64)
        rv.window_keys(keys, rec, rows[sel], rects[sel], ty[sel], tx[sel], w)
        plane = torch.minimum(plane, keys)
    return (*rv.key_planes(plane, rec, w, h, gbuffer=gbuffer), rows)


# (G-buffer, work items a tile): K10vec at 1 and VEC_ITEMS, K10vecg at 1, 2
# and 16.
FORMS = [(False, 1), (False, rv.VEC_ITEMS), (True, 1), (True, 2), (True, 16)]
FORM_IDS = ["1", str(rv.VEC_ITEMS), "gbuffer-1", "gbuffer-2", "gbuffer-16"]


@pytest.mark.parametrize("gbuffer,items", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_key_plane_equals_plain(case, gbuffer, items):
    ti, tf, w, h = CASES[case]()
    if gbuffer:
        tf = lit_columns(tf)
    prep = rv.prepare_vec_inputs(T(ti), T(tf))
    *planes, rows = kernel_planes(prep, w, h, items, gbuffer=gbuffer)
    plain = (rv.gbuffer_vec_plain if gbuffer
             else rv.raster_vec_plain)(*prep, w, h)
    assert len(planes) == len(plain) == (tr.GBUFFER_PLANES if gbuffer
                                         else 2)
    for got, want in zip(planes, plain):
        assert tuple(got.shape) == (h, w)
        _bits(got, want)
    color, depth = planes[:2]
    if case == "padded_soup_128x64":  # rows 56-63 are padding
        assert int((depth[56:] < 1.0).sum()) == 0
        assert int((depth[:56] < 1.0).sum()) > 1000
        if gbuffer:
            assert bool(gbuffer_clear([p[56:] for p in planes]).all())
    if case.startswith("neg_zero"):
        zero = depth == 0.0
        assert int(zero.sum()) > 100
        assert bool((torch.signbit(depth[zero])
                     == case.startswith("neg_zero_first")).all())
    if case == "z_one_128x32":
        assert not bool(((depth == 1.0) & (color != tr._ALPHA_BITS)).any())
    if case == "twin_soup_256x64":
        assert bool((depth < 1.0).any())
    if case == "empty_128x32":
        assert rows.numel() == 0 and bool((depth == 1.0).all())
        assert bool((color == tr._ALPHA_BITS).all())
        assert not gbuffer or bool(gbuffer_clear(planes).all())
    else:
        assert rows.numel() > 0
    if gbuffer and case not in ("empty_128x32", "z_one_128x32"):
        # Every further plane carries the winners' values.
        assert all(bool((p != 0).any()) for p in planes[2:])


def test_admission_is_the_subgroups_not_the_rows():
    """A live row of a hit subgroup is pended in every tile whose chunks its
    subgroup meets, its own bbox notwithstanding; a dead or empty-bbox row
    never is."""
    ti, tf, w, h = setup("test_scene_256x64")
    supers, blocks, rec = rv.prepare_vec_inputs(T(ti), T(tf))
    hits = tr.hier_block_hits(supers, blocks, w, h)
    rows, ty, tx = rv.admitted_rows(hits, rec, w)
    r = rec[rows].to(torch.int64)
    assert bool(((r[:, g.I_VALID] > 0) & (r[:, g.I_JMIN] <= r[:, g.I_JMAX])
                 & (r[:, g.I_IMIN] <= r[:, g.I_IMAX])).all())
    r0, c0 = ty * tr.TILE_H, tx * tr.TILE_W
    own = ((r[:, g.I_JMAX] >= c0) & (r[:, g.I_JMIN] < c0 + tr.TILE_W)
           & (r[:, g.I_IMAX] >= r0) & (r[:, g.I_IMIN] < r0 + tr.TILE_H))
    assert bool(own.any()) and not bool(own.all())
    lo, hi = rv.hit_chunk_rows(rec, rows, ty, tx)
    assert bool(((lo - r0) % rv.CHUNK_H == 0).all())
    assert bool(((hi + 1 - r0) % rv.CHUNK_H == 0).all())
    assert bool(((lo >= r0) & (hi < r0 + tr.TILE_H) & (lo <= hi)).all())


def test_whole_tile_window_draws_padding_rows():
    """K10vec's windows must stay inside the subgroup's hit chunks: the
    vertices' bbox over the whole tile leaves the visible rows as they were
    but draws in rows 56-63, which no subgroup bbox (clamped at row 55)
    meets."""
    ti, tf, w, h = padded_setup()
    prep = rv.prepare_vec_inputs(T(ti), T(tf))
    plain_c, plain_d = rv.raster_vec_plain(*prep, w, h)
    color, depth, _ = kernel_planes(prep, w, h, 1, chunks=False)
    _bits(color[:56], plain_c[:56])
    _bits(depth[:56], plain_d[:56])
    assert int((plain_d[56:] < 1.0).sum()) == 0
    assert int((depth[56:] < 1.0).sum()) > 0


def test_gbuffer_whole_tile_window_draws_padding_rows():
    """K10vecg's windows too must stay inside the subgroup's hit chunks:
    over the whole tile every plane of the visible rows stays equal to the
    plain version's, but rows 56-63, where the plain planes are all clear,
    draw."""
    ti, tf, w, h = padded_setup()
    prep = rv.prepare_vec_inputs(T(ti), T(lit_columns(tf)))
    plain = rv.gbuffer_vec_plain(*prep, w, h)
    *planes, _ = kernel_planes(prep, w, h, 2, chunks=False, gbuffer=True)
    for got, want in zip(planes, plain):
        _bits(got[:56], want[:56])
    assert bool(gbuffer_clear([p[56:] for p in plain]).all())
    assert int((~gbuffer_clear([p[56:] for p in planes])).sum()) > 0


def test_work_items_cover_the_hit_blocks():
    """At any count each hit block falls to one work item, a run of them in
    row order an item, and the hit words count every hit block."""
    ti, tf, w, h = setup("test_scene_256x64")
    supers, blocks, _ = rv.prepare_vec_inputs(T(ti), T(tf))
    hits = tr.hier_block_hits(supers, blocks, w, h)
    _, before, count = tr.hier_hit_words(hits)
    assert torch.equal(count, hits.sum(1)) and not before[:, 0].any()
    for n in (1, 4, rv.VEC_ITEMS, 64):
        item = tr.hier_work_items(hits, n)
        assert torch.equal(item >= 0, hits) and int(item.max()) < n
        assert bool(((item.cummax(1).values == item) | ~hits).all())

