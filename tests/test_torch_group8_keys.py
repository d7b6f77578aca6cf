"""K10g8's CUDA rules (zrenderer_tpu_torch/csrc/raster_group8.cu), emulated
in torch by ``raster_group8``'s ``list_pairs``, ``leftover_pairs``,
``window_rects``, ``window_keys`` and ``key_planes``, against the plain
version ``raster_group8_plain``: 32x128 key tiles of four 8x128 list
tiles, each list entry over its vertices' pixel bbox in its own list tile,
the leftover rows of each key tile's hit blocks whose bbox meets it over
their vertices' pixel bbox in the gated list tiles their bbox meets, the
key tile's entries and hit blocks cut into work items, one (order bits of
z, row id) key a pixel from (1.0, INT_MAX), the items' keys merged by
minimum, the planes resolved from the winners' setup rows.  Packed colour
and depth bits equal in every row, the padding rows included, at 1 and
G8_ITEMS items a key tile: the padded soup (no padding-row pixel), exact
duplicates (the first row wins), the test scene, a -0.0/+0.0 tie both
ways, a row at z == 1.0 (it latches), the empty scene, the blow-up soup
with both phases drawing and with a 32-row list budget, and a 40-row
target (planes of 64 rows).  K10g8g's store (``key_planes(...,
gbuffer=True)``: GbufKeys, the epilogue buf * (covered ? inv : 0)) on the
same cases at 1, 2 and 16 items: its 13 planes bit-equal to
``gbuffer_group8_plain``.  A counter-case shows why an entry's window is
cut to its own list tile: over the whole key tile the visible rows stay
equal but the padding rows draw, in every G-buffer plane too.
"""

import numpy as np
import pytest
import torch

from test_torch_binned_keys import DEPTH_CLEAR_KEY, depth_key_z, depth_keys
from test_torch_group8 import _bits, empty_setup
from test_torch_group8 import setup as g8_setup
from test_torch_vis_trans import demo_setup, padded_setup, pair_case, setup
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_group8 as g8
from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as h2

torch.set_num_threads(1)

T = torch.from_numpy

CASES = {
    "padded_soup_128x64": (padded_setup, {}),
    "tie_soup_256x128": (lambda: setup("tie_soup_256x128"), {}),
    "test_scene_256x64": (lambda: setup("test_scene_256x64"), {}),
    "neg_zero_first_128x32": (pair_case((-0.0,) * 3, (0.0,) * 3), {}),
    "neg_zero_second_128x32": (pair_case((0.0,) * 3, (-0.0,) * 3), {}),
    # A at z = e0 / 4: exactly 1.0 on one covered pixel, which latches.
    "z_one_128x32": (pair_case((0.25, 0.0, 0.0)), {}),
    "empty_128x32": (empty_setup, {}),
    "blow_up_256x64": (lambda: g8_setup("blow_up_256x64"), dict(chunk=16)),
    "blow_up_256x64_budget32": (lambda: g8_setup("blow_up_256x64"),
                                dict(list_budget=32, chunk=16)),
    "demo_128x40": (lambda: demo_setup(128, 40), {}),
    # A (-0.0) past pair_cap rides the hierarchy, B (+0.0) is listed: at
    # their tie the (z, row id) forms keep A's -0.0, the depth-only pass
    # the first visited row's, B's +0.0.
    "leftover_neg_zero_128x32": (pair_case((-0.0,) * 3, (0.0,) * 3),
                                 dict(pair_cap=3)),
}


def lit_columns(tf, seed=0):
    """``tf`` with a lit frame's further columns, seeded: each uv and
    normal numerator a vertex's value in [0, 1) times its 1/w coefficient
    (so a covered pixel's num / den lies in [0, 1]), and each row's six
    constants in [0, 1)."""
    rng = np.random.default_rng(seed)
    tf = tf.copy()
    n = tf.shape[0]
    for c in (g.F_U0, g.F_V0, g.F_NX0, g.F_NY0, g.F_NZ0):
        tf[:, c:c + 3] = (tf[:, g.F_RW0:g.F_RW0 + 3]
                          * rng.random((n, 3), dtype=np.float32))
    tf[:, g.F_MET:g.F_MET + 6] = rng.random((n, 6), dtype=np.float32)
    return tf


def item_of(rank, count, items):
    """The work item of entry (or hit block) ``rank`` of ``count``: item i
    takes [i * count // items, (i + 1) * count // items)."""
    return ((rank + 1) * items + count - 1) // count - 1


def key_tile_entries(inp, w, h):
    """Each key tile's entries E: its four list tiles' spans (a list tile
    past the target's rows has none), (key tiles,) int64."""
    tiles_x = w // g8.GT_W
    n = (inp.offs[1:] - inp.offs[:-1]).to(torch.int64).view(-1, tiles_x)
    pad = g8.key_height(h) // g8.GT_H - n.shape[0]
    n = torch.cat([n, n.new_zeros(pad, tiles_x)])
    return n.view(-1, g8.LISTS, tiles_x).sum(1).reshape(-1)


def depth_window_keys(keys, inp, rows, tags, rects, tile_y, tile_x, w):
    """K10g8d's ``window_keys``: the (order bits of z, tag, sign of z) key
    (K4d's, ``depth_keys``) of each pair's fragments inside its window."""
    r = inp.hier[rows]
    y0, x0 = tile_y * tr.TILE_H, tile_x * tr.TILE_W
    base, sy, sx = h2.edge_windows(r, y0, x0)
    h2.window_min(keys, w, y0, x0, tr.TILE_H, base, sy, sx,
                  r[:, g.I_BIAS0:g.I_BIAS0 + 3],
                  inp.hier_f[rows, g.F_ZA0:g.F_ZA0 + 3], tags,
                  rows=rects[:, 2:], cols=rects[:, :2], key_of=depth_keys,
                  clear=DEPTH_CLEAR_KEY)


def kernel_planes(inp, w, h, items, entry_windows=None, gbuffer=False,
                  depth=False, row_tags=False):
    """K10g8's planes from its rules: every list entry and admitted
    leftover (key tile, row) pair over its window (an entry's in its own
    list tile, or ``entry_windows(rows, ty, tx)``), keyed by its key tile's
    work item of ``items``, the items' keys minimum-merged into the key
    plane, resolved.  Returns (packed, depth, entries, leftover pairs);
    with ``gbuffer`` K10g8g's 13 planes in place of the two; with
    ``depth`` K10g8d's one plane, decoded from DepthKeys' keys whose tag
    is the visit index (an entry's rank in its key tile, a leftover row's
    the key tile's entries plus its row id), or with ``row_tags`` the row
    id."""
    tiles_x = w // g8.GT_W
    rows_l, ly, tx_l, rank, count = g8.list_pairs(inp, w, h)
    ty_l = ly // g8.LISTS
    rect_l = (g8.window_rects(inp, rows_l, ty_l, tx_l, w, h, list_y=ly)
              if entry_windows is None else entry_windows(rows_l, ty_l, tx_l))
    hits, rows_o, ty_o, tx_o = g8.leftover_pairs(inp, w, h)
    rect_o = g8.window_rects(inp, rows_o, ty_o, tx_o, w, h)
    item_o = tr.hier_work_items(hits, items)[ty_o * tiles_x + tx_o,
                                             rows_o // g.RASTER_BLOCK]
    assert bool((item_o >= 0).all())
    rows = torch.cat([rows_l, rows_o])
    ty, tx = torch.cat([ty_l, ty_o]), torch.cat([tx_l, tx_o])
    rects = torch.cat([rect_l, rect_o])
    item = torch.cat([item_of(rank, count, items), item_o])
    n = g8.key_height(h) * w
    clear = DEPTH_CLEAR_KEY if depth else h2.KEY_CLEAR
    if depth:
        entries = key_tile_entries(inp, w, h)[ty_o * tiles_x + tx_o]
        tags = rows if row_tags else torch.cat([rank, entries + rows_o])
    plane = torch.full((n,), clear, dtype=torch.int64)
    for i in range(items):
        sel = item == i
        keys = torch.full((n,), clear, dtype=torch.int64)
        if depth:
            depth_window_keys(keys, inp, rows[sel], tags[sel], rects[sel],
                              ty[sel], tx[sel], w)
        else:
            g8.window_keys(keys, inp, rows[sel], rects[sel], ty[sel],
                           tx[sel], w)
        plane = torch.minimum(plane, keys)
    if depth:
        return (depth_key_z(plane).view(-1, w)[:h], rows_l.numel(),
                rows_o.numel())
    return (*g8.key_planes(plane, inp, w, h, gbuffer=gbuffer),
            rows_l.numel(), rows_o.numel())


def gbuffer_clear(planes):
    """Each pixel's G-buffer planes hold the clear values: alpha alone,
    depth 1.0, every further plane 0.0."""
    return (planes[0] == tr._ALPHA_BITS) & (planes[1] == 1.0) & torch.stack(
        [p.view(torch.int32) == 0 for p in planes[2:]]).all(0)


# (G-buffer, work items a key tile): K10g8 at 1 and G8_ITEMS, K10g8g at 1,
# 2 and 16.
FORMS = [(False, 1), (False, g8.G8_ITEMS), (True, 1), (True, 2), (True, 16)]
FORM_IDS = ["1", str(g8.G8_ITEMS), "gbuffer-1", "gbuffer-2", "gbuffer-16"]


@pytest.mark.parametrize("gbuffer,items", FORMS, ids=FORM_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_key_plane_equals_plain(case, gbuffer, items):
    build, kw = CASES[case]
    ti, tf, w, h = build()
    if gbuffer:
        tf = lit_columns(tf)
    inp = g8.prepare_group8_inputs(T(ti), T(tf), w, h, **kw)
    *planes, n_list, n_left = kernel_planes(inp, w, h, items,
                                            gbuffer=gbuffer)
    plain = (g8.gbuffer_group8_plain if gbuffer
             else g8.raster_group8_plain)(*inp, w, h)
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
        assert bool(((depth == 1.0) & (color != tr._ALPHA_BITS)).any())
    if case.startswith("blow_up"):  # both phases draw
        assert n_list > 0 and n_left > 0
    if case == "empty_128x32":
        assert n_list + n_left == 0 and bool((depth == 1.0).all())
        assert bool((color == tr._ALPHA_BITS).all())
        assert not gbuffer or bool(gbuffer_clear(planes).all())
    else:
        assert n_list + n_left > 0
    if gbuffer and case != "empty_128x32":
        # Every further plane carries the winners' values.
        assert all(bool((p != 0).any()) for p in planes[2:])


@pytest.mark.parametrize("items", [1, 2, g8.G8_ITEMS])
@pytest.mark.parametrize("case", list(CASES))
def test_depth_key_plane_equals_plain(case, items):
    """K10g8d's rules: DepthKeys over K10g8's windows and items, the tag
    the visit index, give ``depth_group8_plain``'s plane bit for bit."""
    build, kw = CASES[case]
    ti, tf, w, h = build()
    inp = g8.prepare_group8_inputs(T(ti), T(tf), w, h, **kw)
    depth, n_list, n_left = kernel_planes(inp, w, h, items, depth=True)
    plain = g8.depth_group8_plain(*inp, w, h)
    assert tuple(depth.shape) == tuple(plain.shape) == (h, w)
    _bits(depth, plain)
    if case == "padded_soup_128x64":  # rows 56-63 are padding
        assert int((depth[56:] < 1.0).sum()) == 0
        assert int((depth[:56] < 1.0).sum()) > 1000
    if case.startswith("neg_zero"):  # a tie in span order: the first wins
        zero = depth == 0.0
        assert int(zero.sum()) > 100
        assert bool((torch.signbit(depth[zero])
                     == case.startswith("neg_zero_first")).all())
    if case == "leftover_neg_zero_128x32":  # the entry B is visited first
        assert n_list > 0 and n_left > 0
        assert bool((depth == 0.0).any())
        assert not bool(torch.signbit(depth[depth == 0.0]).all())
    if case == "z_one_128x32":  # z == 1.0 never passes the strict-less test
        assert bool((depth <= 1.0).all())
        flat = kernel_planes(inp, w, h, items)
        assert bool(((flat[1] == 1.0)
                     & (flat[0] != tr._ALPHA_BITS)).any())
    if case == "empty_128x32":
        assert n_list + n_left == 0 and bool((depth == 1.0).all())
    else:
        assert n_list + n_left > 0 and bool((depth < 1.0).any())


def test_depth_row_id_key_keeps_the_wrong_zero():
    """Why K10g8d's tag is the visit index: with the row id as its tag, a
    leftover row of lower id (A, -0.0) wins its tie with a listed entry
    visited first (B, +0.0), and the map takes the other sign of zero
    where they overlap."""
    build, kw = CASES["leftover_neg_zero_128x32"]
    ti, tf, w, h = build()
    inp = g8.prepare_group8_inputs(T(ti), T(tf), w, h, **kw)
    plain = g8.depth_group8_plain(*inp, w, h)
    by_id, n_list, n_left = kernel_planes(inp, w, h, 1, depth=True,
                                          row_tags=True)
    assert n_list > 0 and n_left > 0
    assert torch.equal(by_id, plain)  # equal by value
    flipped = torch.signbit(by_id) != torch.signbit(plain)
    assert int(flipped.sum()) > 10
    assert bool((plain[flipped] == 0.0).all())
    assert not bool(torch.signbit(plain[flipped]).any())


def test_each_phase_draws_alone_and_the_budget_moves_rows():
    """On the blow-up soup phase 1 alone and phase 2 alone each draw a frame
    other than both phases', and the 32-row list budget moves entries to
    the leftover rows with the frame unchanged."""
    ti, tf, w, h = g8_setup("blow_up_256x64")
    full = g8.prepare_group8_inputs(T(ti), T(tf), w, h, chunk=16)
    tiny = g8.prepare_group8_inputs(T(ti), T(tf), w, h, list_budget=32,
                                    chunk=16)
    out, out_t = (kernel_planes(x, w, h, g8.G8_ITEMS) for x in (full, tiny))
    assert out_t[2] < out[2] and out_t[3] > out[3]
    _bits(out[0], out_t[0])
    _bits(out[1], out_t[1])
    only1 = kernel_planes(full._replace(tile_any=torch.zeros_like(
        full.tile_any)), w, h, 1)
    only2 = kernel_planes(full._replace(offs=torch.zeros_like(full.offs)),
                          w, h, 1)
    assert int((only1[1] < 1.0).sum()) > 0
    assert int((only2[1] < 1.0).sum()) > 0
    for alone in (only1, only2):  # each phase wins pixels of the frame
        assert not torch.equal(alone[1].view(torch.int32),
                               out[1].view(torch.int32))


def test_entries_are_ranked_per_key_tile():
    """Each key tile's entries are numbered 0..E-1 in the order of its list
    tiles top to bottom, each span in order."""
    ti, tf, w, h = setup("test_scene_256x64")
    inp = g8.prepare_group8_inputs(T(ti), T(tf), w, h, pair_cap=1)
    rows, ly, tx, rank, count = g8.list_pairs(inp, w, h)
    assert rows.numel() > 0
    key = ly // g8.LISTS * (w // g8.GT_W) + tx
    for k in torch.unique(key).tolist():
        sel = key == k
        assert torch.equal(rank[sel], torch.arange(int(sel.sum())))
        assert bool((count[sel] == int(sel.sum())).all())
        assert bool((ly[sel].diff() >= 0).all())


def test_key_tile_window_draws_padding_rows():
    """An entry's window must stay inside its own 8x128 list tile: the
    vertices' bbox over the whole 32x128 key tile leaves the visible rows
    as they were but draws in rows 56-63, which no list tile reaches."""
    ti, tf, w, h = padded_setup()
    inp = g8.prepare_group8_inputs(T(ti), T(tf), w, h)
    plain_c, plain_d = g8.raster_group8_plain(*inp, w, h)

    def key_tile(rows, ty, tx):
        jmin, jmax, imin, imax = tr.vertex_bbox(
            inp.hier[rows].to(torch.int64)).unbind(1)
        r0, c0 = ty * tr.TILE_H, tx * tr.TILE_W
        return torch.stack([torch.maximum(jmin, c0),
                            torch.minimum(jmax, c0 + tr.TILE_W - 1),
                            torch.maximum(imin, r0),
                            torch.minimum(imax, r0 + tr.TILE_H - 1)], 1)

    color, depth, _, _ = kernel_planes(inp, w, h, 1, entry_windows=key_tile)
    _bits(color[:56], plain_c[:56])
    _bits(depth[:56], plain_d[:56])
    assert int((plain_d[56:] < 1.0).sum()) == 0
    assert int((depth[56:] < 1.0).sum()) > 0


def test_gbuffer_key_tile_window_draws_padding_rows():
    """K10g8g's entries too must keep to their own list tile: over the
    whole 32x128 key tile every plane of the visible rows stays equal to
    the plain version's, but rows 56-63, where the plain planes are all
    clear, draw."""
    ti, tf, w, h = padded_setup()
    inp = g8.prepare_group8_inputs(T(ti), T(lit_columns(tf)), w, h)
    plain = g8.gbuffer_group8_plain(*inp, w, h)

    def key_tile(rows, ty, tx):
        jmin, jmax, imin, imax = tr.vertex_bbox(
            inp.hier[rows].to(torch.int64)).unbind(1)
        r0, c0 = ty * tr.TILE_H, tx * tr.TILE_W
        return torch.stack([torch.maximum(jmin, c0),
                            torch.minimum(jmax, c0 + tr.TILE_W - 1),
                            torch.maximum(imin, r0),
                            torch.minimum(imax, r0 + tr.TILE_H - 1)], 1)

    *planes, _, _ = kernel_planes(inp, w, h, 2, entry_windows=key_tile,
                                  gbuffer=True)
    for got, want in zip(planes, plain):
        _bits(got[:56], want[:56])
    assert bool(gbuffer_clear([p[56:] for p in plain]).all())
    drawn = ~gbuffer_clear([p[56:] for p in planes])
    assert int(drawn.sum()) > 0
