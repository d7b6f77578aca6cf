"""The port's scanline-grouped two-class raster (zrenderer_tpu_torch/ops/
experiments/raster_scanline.py: K10scan) against the JAX package, the
port's plain K5 and the NumPy oracle, given shared setup rows.

* ``prepare_scanline_inputs`` equals the reference's (run eagerly with
  ``jnp``): the tables bit for bit (the short block table with the group
  pass counts in lanes 4-7), the wide records' 32 lanes (the reference's
  other 96 are zero) in the same order, and the tall view and the
  coefficients unpacked from the reference's 128-lane rows.
* The plain frame equals the port's plain K5 bit for bit in the visible
  rows; against the oracle coverage and depth exact, u8 within 1 LSB.
* Below the geometry's frame a short row draws only inside its bbox: at
  128x64 with geometry at 128x56, K10scan draws 36 pixels in rows 56-63
  (263 differ from K5's 289).
* Exact ties inside a same-row run and across the classes go to the lower
  row id; z == 1.0 is latched; a short winner's -0.0 is stored +0.0.
* As the CUDA kernel computes it: each tall pair over its window and each
  record over its rectangle in the tile (inside its row's vertices' bbox)
  give the plain key plane; one key plane whose tag carries the class (id
  << 1 | short), each winner re-evaluated from the tall view's row and a
  short one's z plus 0.0, gives the plain frame, a short winner at -0.0
  stored +0.0.

The CUDA kernel is held against the plain version on the card by
chip_smoke.py; here its wrapper must refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_group8 import _bits
from test_torch_hbm2 import RED, k5_frame, pair_setup, setup, view_window_min
from test_torch_raster import _u8
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops.experiments import raster_scanline as rs
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as h2
from zrenderer_tpu_torch.ops.experiments import raster_scanline as sc

torch.set_num_threads(1)

T = torch.from_numpy


def same_row_setup(w=128, h=32):
    """tests/test_raster_scanline.py ``test_scanline_same_row_run_exact_z_
    tie_breaks_by_id``: six short triangles on the same rows, each
    overlapping the next by half its base, every z plane zeroed."""
    n = 6
    positions, tri_vidx = [], []
    for k in range(n):
        x0 = -0.9 + 0.2 * k
        positions += [[x0, -0.1, 0.5, 1.0], [x0 + 0.3, -0.1, 0.5, 1.0],
                      [x0 + 0.15, 0.1, 0.5, 1.0]]
        tri_vidx.append([3 * k, 3 * k + 1, 3 * k + 2])
    attrs = np.zeros((3 * n, 12), np.float32)
    for k in range(n):
        attrs[3 * k:3 * k + 3, 0:3] = [(k + 1) / n, 1.0 - k / n,
                                       0.25 * (k % 4)]
    ti, tf = g.geometry_pipeline(np, np.asarray(positions, np.float32),
                                 attrs, np.asarray(tri_vidx, np.int32),
                                 np.eye(4, dtype=np.float32)[None],
                                 np.zeros(3 * n, np.int32), w, h)
    ti, tf = np.array(ti), np.array(tf)
    tf[:, g.F_ZA0:g.F_ZA0 + 3] = 0.0
    return ti, tf, w, h


PREPARE_CASES = ["stress_256x64", "padded_soup_128x64", "test_scene_256x64",
                 "clipped_soup_384x128", "demo_128x32", "empty_128x32"]


@pytest.mark.parametrize("case", PREPARE_CASES)
def test_prepare_scanline_matches_jax(case):
    ti, tf, _, h = setup(case)
    ours = [x.numpy() for x in sc.prepare_scanline_inputs(T(ti), T(tf), h)]
    ref = [np.asarray(x) for x in rs.prepare_scanline_inputs(
        jnp.asarray(ti), jnp.asarray(tf))]
    supers_s, blocks8, wide, supers_t, blocks_t, ti_tall, tf_p = ours
    for a, b in ((supers_s, ref[0]), (blocks8, ref[1]), (supers_t, ref[3]),
                 (blocks_t, ref[4])):
        assert a.shape == b.shape
        _bits(a, b)
    n = wide.shape[0]
    assert wide.shape == (n, sc.WIDE_LANES) and ref[2].shape == (n, 128)
    _bits(wide, ref[2][:, :sc.WIDE_LANES])
    assert not ref[2][:, sc.WIDE_LANES:].any()
    _bits(ti_tall, ref[5].reshape(n, -1)[:, :g.NI32])
    _bits(tf_p, ref[6].reshape(n, -1)[:, :g.NF32])
    # The permutation: stable by (block, clip(imin, 0, 4095)), in blocks.
    ids = wide[:, sc.WL_IDF].astype(np.int64) - 1
    key = (np.arange(n) // g.RASTER_BLOCK << 12) | np.clip(
        ti_tall[:, g.I_IMIN], 0, 4095)
    np.testing.assert_array_equal(ids, np.argsort(key, kind="stable"))
    assert (ids // g.RASTER_BLOCK == np.arange(n) // g.RASTER_BLOCK).all()
    # The pass counts: per 32-record group, min(max h + 1, 8).
    h_rec = wide[:, sc.WL_H].astype(np.int32)
    passes = np.clip(h_rec + 1, 0, 8).reshape(-1, 4, sc.GROUP).max(axis=2)
    np.testing.assert_array_equal(blocks8[:n // g.RASTER_BLOCK, 4:8], passes)
    assert not blocks8[n // g.RASTER_BLOCK:, 4:8].any()
    if case == "stress_256x64":  # the sort moves rows; groups differ
        assert (ids != np.arange(n)).any()
        assert len(np.unique(passes)) > 2


FRAME_CASES = ["demo_128x32", "stress_256x64", "tie_soup_256x128",
               "clipped_soup_384x128", "empty_128x32"]


@pytest.mark.parametrize("case", FRAME_CASES)
def test_plain_frame_equals_k5_and_oracle(case):
    ti, tf, w, h = setup(case)
    color, depth = sc.rasterize_setup_scanline(T(ti), T(tf), w, h)
    assert color.dtype == torch.int32 and depth.dtype == torch.float32
    c5, d5 = k5_frame(ti, tf, w, h)
    _bits(color, c5)
    _bits(depth, d5)
    rgba, ref_d = raster_cpu.rasterize_setup(ti, tf, w, h)
    np.testing.assert_array_equal(depth.numpy(), ref_d)
    assert np.abs(_u8(color.numpy()).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1
    if case == "empty_128x32":
        assert (depth == 1.0).all() and (color == tr._ALPHA_BITS).all()
    else:
        assert (depth < 1.0).float().mean() > 0.02


def test_padding_rows_rule():
    """Geometry at 128x56, raster at 128x64: the visible rows equal K5's;
    in rows 56-63 a short row draws only inside its bbox rows and
    columns, so K10scan draws 36 pixels there (263 differ from K5's
    frame), K5 289."""
    ti, tf, w, h = setup("padded_soup_128x64")
    color, depth = sc.rasterize_setup_scanline(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    vis, pad = slice(0, 56), slice(56, 64)
    _bits(color[vis], c5[vis])
    _bits(depth[vis], d5[vis])
    assert int((d5[pad] < 1.0).sum()) == 289
    assert int((depth[pad] < 1.0).sum()) == 36
    assert int(((depth[pad] != d5[pad]) | (color[pad] != c5[pad])).sum()) \
        == 263


def test_same_row_run_tie_goes_to_the_lower_id():
    """Six short rows on the same pixel rows with z == 0 everywhere: each
    overlap goes to the earlier row, as K5's strict less gives it."""
    ti, tf, w, h = same_row_setup()
    live = ti[:, g.I_VALID] > 0
    assert tr.classify_short(T(ti))[T(live)].all() and live.sum() == 6
    color, depth = sc.rasterize_setup_scanline(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    _bits(color, c5)
    _bits(depth, d5)
    alone = 0  # pixels each row covers when drawn alone
    for row in np.flatnonzero(live):
        only = ti.copy()
        others = live.copy()
        others[row] = False
        only[others, g.I_VALID] = 0
        only[others, g.I_JMIN], only[others, g.I_JMAX] = 1, 0
        alone += int((sc.rasterize_setup_scanline(T(only), T(tf), w, h)[1]
                      == 0.0).sum())
    assert alone > int((depth == 0.0).sum()) + 10  # the overlaps tie


def test_cross_class_tie_goes_to_the_lower_id():
    ti, tf, w, h, _, _ = pair_setup(za_a=0.0, za_b=0.0)
    color, depth = sc.rasterize_setup_scanline(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    _bits(color, c5)
    _bits(depth, d5)
    assert bool((color[depth == 0.0] == RED).all())


def test_z_equal_one_is_latched():
    """As K10hbm2 (test_torch_hbm2.py): A's one pixel at z == 1.0 is
    latched, K5 leaves it clear."""
    ti, tf, w, h, _, _ = pair_setup(za_a=(0.25, 0.0, 0.0))
    color, depth = sc.rasterize_setup_scanline(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    _bits(depth, d5)
    diff = color != c5
    assert int(diff.sum()) == 1 and int(color[diff]) == RED


def test_short_winner_negative_zero_is_stored_positive():
    """B's z plane (-0.0, -0.0, -0.0): z == -0.0 on its pixels, which win
    over A's z > 0.  K5 and K10hbm2 store -0.0; K10scan stores B's
    winners plus 0.0, +0.0 (the reference's one-hot sum)."""
    ti, tf, w, h, _, b = pair_setup(za_b=(-0.0, -0.0, -0.0))
    color, depth = sc.rasterize_setup_scanline(T(ti), T(tf), w, h)
    c2, d2 = h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    _bits(c2, c5)
    _bits(d2, d5)
    _bits(color, c5)
    neg = torch.signbit(d5) & (d5 == 0.0)
    assert int(neg.sum()) > 10
    assert (depth[neg] == 0.0).all() and not torch.signbit(depth).any()
    assert torch.equal(depth[~neg].view(torch.int32),
                       d5[~neg].view(torch.int32))


def test_prepare_raises_where_the_reference_asserts():
    ti, tf, w, _ = setup("demo_128x32")
    with pytest.raises(ValueError, match="4096"):
        sc.prepare_scanline_inputs(T(ti), T(tf), 4128)
    with pytest.raises(ValueError, match="4096"):
        sc.rasterize_setup_scanline(T(ti), T(tf), w, 4128)
    rows = sc.MAX_ROWS  # a stride-0 view: no memory
    with pytest.raises(ValueError, match="rows"):
        sc.prepare_scanline_inputs(
            torch.zeros((1, g.NI32), dtype=torch.int32).expand(rows, -1),
            torch.zeros((1, g.NF32)).expand(rows, -1))
    sc.prepare_scanline_inputs(T(ti), T(tf), 4096)


def test_kernel_wrapper_takes_cuda_tensors_only():
    ti, tf, w, h = setup("test_scene_256x64")
    prep = sc.prepare_scanline_inputs(T(ti), T(tf))
    with pytest.raises(ValueError, match="CUDA"):
        sc.raster_scanline_kernel(*prep, w, h)
    sc.rasterize_setup_scanline(T(ti), T(tf), w, h)  # CPU: the plain version
    assert sc.raster_scanline_kernel.launches == 0
    assert sc.KERNELS == (sc.raster_scanline_kernel,)
    with pytest.raises(ValueError):
        sc.rasterize_setup_scanline(T(ti), T(tf), 256, 40)


def test_constants_match_reference():
    names = ("GROUP", "WL_A0", "WL_D0", "WL_S0", "WL_B0", "WL_IMIN", "WL_H",
             "WL_JMINF", "WL_JMAXF", "WL_IDF", "WL_ZA0", "WL_RW0", "WL_CR0",
             "WL_CG0", "WL_CB0")
    assert [getattr(sc, n) for n in names] == [getattr(rs, n) for n in names]
    assert sc.WL_CB0 + 3 == sc.WIDE_LANES < rs.WIDE_LANES
    assert sc.GROUP * 4 == g.RASTER_BLOCK


def keyed_scan_frame(prep, w, h):
    """K10scan as the CUDA kernel stores it: the keys of the tall pass
    over its windows and of the short records over their rectangles in one
    plane, the tag each fragment's row id over its class (id << 1 | short,
    in the order of the id), each winner re-evaluated from the tall view's
    row (``kill_rows`` keeps its edge columns), a short winner's z plus
    0.0.  Returns (keys without the class bit, color, depth, the
    re-evaluated depth before the 0.0, the short winners' mask)."""
    supers_s, blocks8, wide, supers_t, blocks_t, ti_tall, tf = prep
    empty = supers_t.clone()
    empty[:, 0], empty[:, 1] = 1, 0  # no tall pair: the records alone
    short = sc.scanline_keys(supers_s, blocks8, wide, empty, blocks_t,
                             ti_tall, tf, w, h)
    tall = torch.full_like(short, h2.KEY_CLEAR)
    view_window_min(tall, ti_tall, tf, blocks_t, supers_t, w, h, False)
    mask = 0xFFFFFFFF

    def tagged(keys, cls):
        return torch.where(keys == h2.KEY_CLEAR, h2.KEY_CLEAR,
                           (keys & ~mask) | ((keys & mask) << 1) | cls)

    keys = torch.minimum(tagged(short, 1), tagged(tall, 0))
    won = keys != h2.KEY_CLEAR
    wid = torch.where(won, (keys & mask) >> 1, 0)
    is_short = (won & ((keys & 1) == 1)).reshape(h, w)
    color, depth = h2.resolve(won, h2.pixel_edges(ti_tall[wid], w, h),
                              tf[wid, g.F_ZA0:g.F_CB2 + 1], w, h)
    return (torch.minimum(short, tall), color,
            torch.where(is_short, depth + 0.0, depth), depth, is_short)


WINDOW_CASES = ["padded_soup_128x64", "stress_256x64", "tie_soup_256x128"]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_rule_gives_the_plain_key_plane(case):
    ti, tf, w, h = setup(case)
    prep = sc.prepare_scanline_inputs(T(ti), T(tf), h)
    keys, color, depth, _, is_short = keyed_scan_frame(prep, w, h)
    assert torch.equal(keys, sc.scanline_keys(*prep, w, h))
    c, d = sc.raster_scanline_plain(*prep, w, h)
    _bits(color, c)
    _bits(depth, d)
    assert bool(is_short.any()) and bool((~is_short & (d < 1.0)).any())
    # A short record's rectangle lies inside its row's vertices' pixel
    # bbox, so the kernel needs no further cut.
    wide = prep[2]
    rect = sc.record_rects(prep[1], wide)
    live = (wide[:, sc.WL_H] >= 0) & (rect[:, 0] <= rect[:, 1])
    box = tr.vertex_bbox(prep[5][wide[live, sc.WL_IDF].long() - 1].long())
    r = rect[live]
    assert bool(live.any())
    assert bool(((r[:, 0] >= box[:, 0]) & (r[:, 1] <= box[:, 1])
                 & (r[:, 2] >= box[:, 2]) & (r[:, 3] <= box[:, 3])).all())


def test_keyed_short_winner_negative_zero_resolved_positive():
    """B's z plane (-0.0, -0.0, -0.0): B's winners, re-evaluated from the
    tall view's row (killed there, its edges and coefficients kept), come
    out -0.0 and are stored +0.0 by their tag's class bit, as the plain
    version stores them; A's pixels keep their bits."""
    ti, tf, w, h, a, b = pair_setup(za_b=(-0.0, -0.0, -0.0))
    prep = sc.prepare_scanline_inputs(T(ti), T(tf), h)
    ti_tall = prep[5]
    assert int(ti_tall[b, g.I_VALID]) == 0 and int(ti_tall[a, g.I_VALID]) == 1
    _, color, depth, raw, is_short = keyed_scan_frame(prep, w, h)
    c, d = sc.raster_scanline_plain(*prep, w, h)
    _bits(color, c)
    _bits(depth, d)
    neg = torch.signbit(raw) & (raw == 0.0)
    assert int(neg.sum()) > 10 and bool((is_short == neg).all())
    assert not torch.signbit(depth).any() and bool((depth[neg] == 0.0).all())
    c2, d2 = h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)
    _bits(raw, d2)  # K10hbm2 keeps the -0.0
