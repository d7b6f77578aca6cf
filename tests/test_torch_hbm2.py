"""The port's two-class windowed raster (zrenderer_tpu_torch/ops/
experiments/raster_hbm2.py: K10hbm2) and the short-row class it shares
with K10scan (zrenderer_tpu_torch/ops/raster.py ``classify_short``,
``kill_rows``) against the JAX package, the port's plain K5 and the NumPy
oracle, given shared setup rows.

* ``classify_short``, ``kill_rows`` and ``prepare_raster_inputs_2class``
  equal the reference's functions (run eagerly with ``jnp``) bit for bit.
* The plain frame equals the port's plain K5 (``raster_hier_plain``) bit
  for bit in the visible rows; against the oracle coverage and depth
  exact, u8 within 1 LSB (RASTER_SPEC §5).
* Below the geometry's frame a short row draws only on its 8-row window:
  at 128x64 with geometry at 128x56, K5 draws 289 pixels in rows 56-63,
  K10hbm2 246 (59 of them differ from K5).
* A cross-class exact depth tie goes to the lower row id; a pixel whose
  least z is exactly 1.0 is latched, where K5 leaves it clear.
* The CUDA kernel's window rule (``raster_hbm2.window_rects``: each
  admitted row's vertices' pixel bbox in the tile, a short row's within
  its 8-row extent) gives the plain version's key plane, padding rows
  included; the tall extent in place of the short one would not.

The CUDA kernel is held against the plain version on the card by
chip_smoke.py; here its wrapper must refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_group8 import _bits, empty_setup
from test_torch_raster import _setup, _u8
from test_torch_vis_trans import demo_setup, padded_setup, rows_at
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.ops.experiments import raster_hbm2 as rh2
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.procedural import make_stress_scene
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as h2

# The plain kernels run many small torch ops: one intra-op thread a test
# worker (see test_torch_gbuffer.py).
torch.set_num_threads(1)

T = torch.from_numpy
RED = -(1 << 24) | 255  # packed RGBA8 (255, 0, 0, 255) as int32


def stress_setup(w=256, h=64):
    """tests/test_raster_pallas.py ``test_hbm2_two_class_matches_hbm1_
    stress_mix``: a 1536-triangle lattice whose rows straddle the 8-row
    class boundary."""
    return (*rows_at(*make_stress_scene(1536), w, h), w, h)


def pair_setup(za_a=None, za_b=None, w=128, h=32):
    """tests/test_raster_pallas.py :556-606: a tall triangle A (rows ~3-28)
    and a short triangle B inside it, submitted after A, through the
    identity matrix; ``za_a``/``za_b`` replace a row's z-plane
    coefficients.  Returns (ti, tf, w, h, row of A, row of B)."""
    positions = np.array([
        [-0.8, -0.8, 0.5, 1.0], [0.8, -0.8, 0.5, 1.0], [0.0, 0.8, 0.5, 1.0],
        [-0.2, -0.1, 0.3, 1.0], [0.2, -0.1, 0.3, 1.0], [0.0, 0.1, 0.3, 1.0],
    ], np.float32)
    attrs = np.zeros((6, 12), np.float32)
    attrs[:3, 0:3] = [1.0, 0.0, 0.0]  # A red
    attrs[3:, 0:3] = [0.0, 1.0, 0.0]  # B green
    ti, tf = g.geometry_pipeline(np, positions, attrs,
                                 np.array([[0, 1, 2], [3, 4, 5]], np.int32),
                                 np.eye(4, dtype=np.float32)[None],
                                 np.zeros(6, np.int32), w, h)
    ti, tf = np.array(ti), np.array(tf)
    a, b = np.flatnonzero(ti[:, g.I_VALID] > 0)
    for row, za in ((a, za_a), (b, za_b)):
        if za is not None:
            tf[row, g.F_ZA0:g.F_ZA0 + 3] = za
    return ti, tf, w, h, a, b


def setup(case):
    return {"demo_128x32": demo_setup, "stress_256x64": stress_setup,
            "padded_soup_128x64": padded_setup,
            "empty_128x32": empty_setup}.get(case, lambda: _setup(case))()


def k5_frame(ti, tf, w, h):
    return tr.raster_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)


CLASS_CASES = ["stress_256x64", "padded_soup_128x64"]


@pytest.mark.parametrize("case", CLASS_CASES)
def test_classify_and_kill_match_jax(case):
    ti = setup(case)[0]
    short = tr.classify_short(T(ti))
    ref = np.asarray(rp._classify_short(jnp, jnp.asarray(ti)))
    np.testing.assert_array_equal(short.numpy(), ref)
    assert 0 < int(short.sum()) < int((ti[:, g.I_VALID] > 0).sum())
    for mask in (short, ~short):
        ours = tr.kill_rows(T(ti), mask)
        _bits(ours.numpy(), rp._kill_rows(jnp, jnp.asarray(ti),
                                          jnp.asarray(mask.numpy())))
        assert ours.dtype == torch.int32
    _bits(T(ti).numpy(), ti)  # kill_rows leaves its input alone


PREPARE_CASES = CLASS_CASES + ["test_scene_256x64", "clipped_soup_384x128",
                               "demo_128x32", "empty_128x32"]


@pytest.mark.parametrize("case", PREPARE_CASES)
def test_prepare_2class_matches_jax(case):
    ti, tf, _, _ = setup(case)
    ours = h2.prepare_raster_inputs_2class(T(ti), T(tf))
    ref = rh2.prepare_raster_inputs_2class(jnp.asarray(ti), jnp.asarray(tf))
    assert len(ours) == len(ref) == 7
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == tuple(b.shape)
        _bits(a.numpy(), np.asarray(b))


FRAME_CASES = ["demo_128x32", "stress_256x64", "tie_soup_256x128",
               "clipped_soup_384x128", "empty_128x32"]


@pytest.mark.parametrize("case", FRAME_CASES)
def test_plain_frame_equals_k5_and_oracle(case):
    ti, tf, w, h = setup(case)
    color, depth = h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)
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
    if case == "stress_256x64":  # both classes draw
        short = tr.classify_short(T(ti))
        assert short.any() and (~short & T(ti[:, g.I_VALID] > 0)).any()


def test_padding_rows_rule():
    """Geometry at 128x56, raster at 128x64 (778 live rows, 678 short):
    the visible rows equal K5's; in rows 56-63 a short row draws only on
    its 8-row window from clamp(imin - row0, 0, 24), so K10hbm2 draws 246
    pixels there (59 differ from K5's frame), K5 289."""
    ti, tf, w, h = setup("padded_soup_128x64")
    live = ti[:, g.I_VALID] > 0
    assert (int(live.sum()), int(tr.classify_short(T(ti)).sum())) == (778,
                                                                      678)
    color, depth = h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    vis, pad = slice(0, 56), slice(56, 64)
    _bits(color[vis], c5[vis])
    _bits(depth[vis], d5[vis])
    assert int((d5[pad] < 1.0).sum()) == 289
    assert int((depth[pad] < 1.0).sum()) == 246
    assert int(((depth[pad] != d5[pad]) | (color[pad] != c5[pad])).sum()) \
        == 59


def test_cross_class_tie_goes_to_the_lower_id():
    """Both rows' z planes zeroed: z == 0 wherever either covers.  The
    short row B lies inside the tall row A and comes after it, so A wins
    every shared pixel, whichever pass runs first: the frame equals K5's
    and no pixel shows B."""
    ti, tf, w, h, a, b = pair_setup(za_a=0.0, za_b=0.0)
    short = tr.classify_short(T(ti))
    assert not short[a] and short[b]
    color, depth = h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    _bits(color, c5)
    _bits(depth, d5)
    assert int((depth == 0.0).sum()) > 100
    assert bool((color[depth == 0.0] == RED).all())
    # Without A, B draws: the shared pixels were a real tie.
    ti_b = ti.copy()
    ti_b[a, g.I_VALID] = 0
    ti_b[a, g.I_JMIN], ti_b[a, g.I_JMAX] = 1, 0
    color_b, _ = h2.rasterize_setup_hbm2(T(ti_b), T(tf), w, h)
    assert int((color_b != tr._ALPHA_BITS).sum()) > 10


def test_z_equal_one_is_latched():
    """A's z plane (1/4, 0, 0): z = e0 / 4, exactly 1.0 on one covered
    pixel and above it on A's others.  The (z, id) test against the clear
    (1.0, INT32_MAX) latches that pixel; K5's strict less does not.  The
    depth planes are equal (1.0 either way), the colour differs there."""
    ti, tf, w, h, _, _ = pair_setup(za_a=(0.25, 0.0, 0.0))
    color, depth = h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)
    c5, d5 = k5_frame(ti, tf, w, h)
    _bits(depth, d5)
    diff = color != c5
    assert int(diff.sum()) == 1
    assert float(depth[diff]) == 1.0 and int(c5[diff]) == tr._ALPHA_BITS
    assert int(color[diff]) == RED


def test_kernel_wrapper_takes_cuda_tensors_only():
    ti, tf, w, h = setup("test_scene_256x64")
    prep = h2.prepare_raster_inputs_2class(T(ti), T(tf))
    with pytest.raises(ValueError, match="CUDA"):
        h2.raster_hbm2_kernel(*prep, w, h)
    h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)  # CPU: the plain version
    assert h2.raster_hbm2_kernel.launches == 0
    assert h2.KERNELS == (h2.raster_hbm2_kernel,)
    with pytest.raises(ValueError):
        h2.rasterize_setup_hbm2(T(ti), T(tf), 256, 40)


def test_constants_match_reference():
    assert tr.SHORT_ROWS == rp.SHORT_ROWS
    assert h2.KEY_CLEAR >> 32 == np.float32(1.0).view(np.int32)
    assert h2.KEY_CLEAR & 0xFFFFFFFF == int(rp._INT_MAX)


def view_window_min(keys, ti, tf, blocks, supers, w, h, short):
    """``raster_hbm2.view_min`` as the CUDA kernels evaluate a view: each
    admitted (tile, row) pair over its window alone
    (``raster_hbm2.window_rects``)."""
    box = [g.I_JMIN, g.I_JMAX, g.I_IMIN, g.I_IMAX]
    rows, ty, tx = h2.rect_pairs(ti[:, box], blocks, supers, w, h)
    rect = h2.window_rects(ti, rows, ty, tx, short)
    r = ti[rows]
    y0, x0 = ty * tr.TILE_H, tx * tr.TILE_W
    base, sy, sx = h2.edge_windows(r, y0, x0)
    h2.window_min(keys, w, y0, x0, tr.TILE_H, base, sy, sx,
                  r[:, g.I_BIAS0:g.I_BIAS0 + 3],
                  tf[rows, g.F_ZA0:g.F_ZA0 + 3], rows, rows=rect[:, 2:],
                  cols=rect[:, :2])
    return rect


def windowed_keys(prep, w, h, short_extent=True):
    """K10hbm2's key plane as the CUDA kernel computes it: both views'
    pairs over their windows (``short_extent=False``: a short row's window
    over the whole tile, a tall row's extent).  Returns (keys, each view's
    window rects)."""
    supers_s, blocks_s, ti_s, supers_t, blocks_t, ti_t, tf = prep
    keys = torch.full((h * w,), h2.KEY_CLEAR, dtype=torch.int64)
    rects = [view_window_min(keys, ti_s, tf, blocks_s, supers_s, w, h,
                             short_extent),
             view_window_min(keys, ti_t, tf, blocks_t, supers_t, w, h, False)]
    return keys, rects


WINDOW_CASES = ["padded_soup_128x64", "stress_256x64", "tie_soup_256x128"]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_rule_gives_the_plain_key_plane(case):
    """Each (tile, row) pair over its window alone, as the CUDA kernel
    evaluates it: the same (z, id) key at every pixel, all rows, and the
    same frame from one resolve over the tall view's rows."""
    ti, tf, w, h = setup(case)
    prep = h2.prepare_raster_inputs_2class(T(ti), T(tf))
    windowed, rects = windowed_keys(prep, w, h)
    assert torch.equal(windowed, h2.hbm2_keys(*prep, w, h))
    won, wid = h2.winners(windowed)
    ti_tall, tf_p = prep[5], prep[6]
    color, depth = h2.resolve(won, h2.pixel_edges(ti_tall[wid], w, h),
                              tf_p[wid, g.F_ZA0:g.F_CB2 + 1], w, h)
    c, d = h2.raster_hbm2_plain(*prep, w, h)
    _bits(color, c)
    _bits(depth, d)
    # The windows hold fewer pixels than the extents they replace.
    for rect, extent in zip(rects, (tr.SHORT_ROWS, tr.TILE_H)):
        area = ((rect[:, 1] - rect[:, 0] + 1).clamp(min=0)
                * (rect[:, 3] - rect[:, 2] + 1).clamp(min=0))
        assert rect.shape[0] > 0
        assert int(area.sum()) < rect.shape[0] * extent * tr.TILE_W


def test_window_rule_keeps_the_short_extent():
    """At 128x64 with geometry at 128x56, a short row's window must stay
    inside its 8 tile rows: the vertices' bbox over the whole tile (a tall
    row's extent) draws more of rows 56-63 than the reference."""
    ti, tf, w, h = setup("padded_soup_128x64")
    prep = h2.prepare_raster_inputs_2class(T(ti), T(tf))
    keys = h2.hbm2_keys(*prep, w, h)
    wrong, _ = windowed_keys(prep, w, h, short_extent=False)
    pad = slice(56 * w, 64 * w)
    assert torch.equal(wrong[:56 * w], keys[:56 * w])
    drawn = int((keys[pad] != h2.KEY_CLEAR).sum())
    assert drawn == 246
    assert int((wrong[pad] != h2.KEY_CLEAR).sum()) > drawn
