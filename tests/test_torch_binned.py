"""The port's large-scene and explicit-binning flat raster
(zrenderer_tpu_torch/ops/raster.py: K4, K4c, K5, K6 and their prepares)
against zrenderer_tpu/ops/raster_pallas.py and the NumPy oracle, given
shared setup rows (the NumPy geometry stage).

Contracts (docs/RASTER_SPEC.md §5):
* ``pair_value_sort`` and the K4/K6 prepares: exact against the JAX
  functions (the port drops the reference's TPU record packing and DMA
  padding, so records are compared column for column over the listed
  spans);
* plain K5/K6 vs the Pallas kernels in interpret mode: coverage exact,
  u8 within 1 LSB, depth within 2e-6 (XLA:CPU contracts the interpret
  kernels' f32 chains); K4/K4c are in test_torch_binned_interpret.py;
* plain K4 = K4c = K5 = K6 = K3 = K1, bit for bit ((z, row id)
  tie-break == sequential strict-less), and K4/K5 vs the oracle:
  coverage and depth bits exact, u8 within 1 LSB (the oracle divides
  where the kernels multiply by 1/den);
* the whole slice: the port's Renderer above 32768 setup rows through
  every binning, bit-equal across binnings and against the oracle.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raster import CASES, _bits, _setup, _u8
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.procedural import make_triangle_soup as make_jax_soup
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.scene.procedural import make_triangle_soup

# Keyword sets of the K4 prepare: the auto cap, a fixed cap, a record
# budget small enough to demote listed rows, and the coarse class under
# its own small budget.
HBM_KW = {
    "auto": {},
    "cap4": dict(cap=4),
    "budget": dict(cap=4, pair_budget=100),
    "coarse": dict(cap=2, pair_budget=60, coarse_cap=8, coarse_budget=12),
}
SOUPS = ["clipped_soup_384x128", "tie_soup_256x128"]


def _t(a):
    return torch.from_numpy(a)


def _rows(hti):
    """The reference's packed HBM rows (4 records of 32 lanes per 128-lane
    row) back to (R, NI32)."""
    return np.asarray(hti).reshape(-1, rp.I32_LANES)[:, :g.NI32]


@pytest.mark.parametrize("force", ["packed", "lex"])
def test_pair_value_sort_matches_jax(force):
    rng = np.random.default_rng(11)
    cap, num_tiles = 4, 37
    keys = rng.integers(0, num_tiles, 300 * cap).astype(np.int32)
    keys[rng.random(keys.shape) < 0.3] = num_tiles  # sentinel slots
    keys[:8] = -1  # off-screen ranges can give negative keys
    ours = tr.pair_value_sort(_t(keys), cap, num_tiles)
    ref = rp._pair_value_sort(jnp.asarray(keys), cap, num_tiles, force=force)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pair_value_sort_matches_jax_at_full_width():
    """Pair counts of a 1M-triangle frame (4 slots a head row, 23 index
    bits over the 1920x1088 frame's 510 tiles): past the reference's
    packed-i32 capacity, where it sorts lexicographically; one int64 sort
    gives the same order."""
    rng = np.random.default_rng(12)
    cap, num_tiles = 4, 510
    keys = rng.integers(0, num_tiles + 1, (1 << 22) + 5).astype(np.int32)
    sorted_tri, offsets = tr.pair_value_sort(_t(keys), cap, num_tiles)
    ref = rp._pair_value_sort(jnp.asarray(keys), cap, num_tiles)
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(ref[1]))
    n = int(offsets[-1])
    np.testing.assert_array_equal(sorted_tri[:n].numpy(),
                                  np.asarray(ref[0])[:n])


@pytest.mark.parametrize("kw", list(HBM_KW))
@pytest.mark.parametrize("case", SOUPS)
def test_prepare_binned_hbm_inputs_matches_jax(case, kw):
    ti, tf, w, h = _setup(case)
    ours = tr.prepare_binned_hbm_inputs(_t(ti), _t(tf), w, h, **HBM_KW[kw])
    ref = rp.prepare_binned_hbm_inputs(jnp.asarray(ti), jnp.asarray(tf), w, h,
                                       **HBM_KW[kw])
    offsets, rec_i, rec_f, supers, blocks, hier, tf_pad, coarse = ours
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(ref[0]))
    n = int(offsets[-1])
    assert n > 0 and rec_i.shape == (rec_i.shape[0], g.NI32 + 1)
    if kw in ("budget", "coarse"):
        assert n == HBM_KW[kw]["pair_budget"]  # the clamp engaged
    prec_i = np.asarray(ref[1]).reshape(-1, rp.I32_LANES)
    prec_f = np.asarray(ref[2]).reshape(-1, rp.F32_LANES)
    np.testing.assert_array_equal(rec_i[:n, :g.NI32].numpy(),
                                  prec_i[:n, :g.NI32])
    np.testing.assert_array_equal(rec_i[:n, g.NI32].numpy(),
                                  prec_i[:n, rp.L_PID])
    _bits(rec_f[:n].numpy(), prec_f[:n, :g.NF32])
    np.testing.assert_array_equal(supers.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(hier.numpy(), _rows(ref[5]))
    _bits(tf_pad.numpy(),
          np.asarray(ref[6]).reshape(-1, rp.F32_LANES)[:, :g.NF32])
    if kw != "coarse":
        assert coarse is None and len(ref) == 7
        return
    coffsets, crec_i, crec_f = coarse
    np.testing.assert_array_equal(coffsets.numpy(), np.asarray(ref[7]))
    cn = int(coffsets[-1])
    assert 0 < cn <= HBM_KW[kw]["coarse_budget"]
    cprec_i = np.asarray(ref[8]).reshape(-1, rp.I32_LANES)
    np.testing.assert_array_equal(crec_i[:cn].numpy(),
                                  cprec_i[:cn, :g.NI32 + 1])
    _bits(crec_f[:cn].numpy(),
          np.asarray(ref[9]).reshape(-1, rp.F32_LANES)[:cn, :g.NF32])


@pytest.mark.parametrize("cap", [None, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_prepare_binned_inputs_matches_jax(case, cap):
    ti, tf, w, h = _setup(case)
    offsets, pair_tri, *rest = tr.prepare_binned_inputs(_t(ti), _t(tf), w, h,
                                                        cap=cap)
    ref = rp.prepare_binned_inputs(jnp.asarray(ti), jnp.asarray(tf), w, h,
                                   cap=cap)
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(ref[0]))
    n = int(offsets[-1])
    assert n > 0
    np.testing.assert_array_equal(pair_tri[:n].numpy(), np.asarray(ref[1])[:n])
    for a, b in zip(rest, ref[2:]):
        _bits(a.numpy(), b)


# Every large-scene and explicit-binning wrapper, with the budgets that
# make phases 1, 1.5 and 2 all run on the soups.
WRAPPERS = {
    "k4": lambda ti, tf, w, h: tr.rasterize_setup_binned_hbm(ti, tf, w, h),
    "k4_budget": lambda ti, tf, w, h: tr.rasterize_setup_binned_hbm(
        ti, tf, w, h, **HBM_KW["budget"]),
    "k4c": lambda ti, tf, w, h: tr.rasterize_setup_binned_hbm(
        ti, tf, w, h, **HBM_KW["coarse"]),
    "k4c_dispatch": tr.rasterize_setup_binned_hbm_coarse,
    "k5": tr.rasterize_setup_hbm,
    "k6": tr.rasterize_setup_binned,
    "k6_cap2": lambda ti, tf, w, h: tr.rasterize_setup_binned(ti, tf, w, h,
                                                              cap=2),
}


def _run(kind, ti, tf, w, h):
    color, depth = WRAPPERS[kind](_t(ti), _t(tf), w, h)
    assert color.dtype == torch.int32 and depth.dtype == torch.float32
    assert tuple(color.shape) == tuple(depth.shape) == (h, w)
    return color.numpy(), depth.numpy()


@pytest.mark.parametrize("kind", list(WRAPPERS))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_plain_k1_and_k3(case, kind):
    ti, tf, w, h = _setup(case)
    color, depth = _run(kind, ti, tf, w, h)
    c3, d3 = tr.rasterize_setup(_t(ti), _t(tf), w, h)
    c1, d1 = tr.rasterize_setup_small(_t(ti), _t(tf), w, h)
    assert (depth < 1.0).mean() > 0.02  # the tie soup covers 3.8%
    np.testing.assert_array_equal(color, c3.numpy())
    _bits(depth, d3.numpy())
    np.testing.assert_array_equal(color, c1.numpy())
    _bits(depth, d1.numpy())


@pytest.mark.parametrize("kind", ["k4_budget", "k4c", "k5"])
@pytest.mark.parametrize("case", SOUPS)
def test_plain_matches_oracle(case, kind):
    ti, tf, w, h = _setup(case)
    color, depth = _run(kind, ti, tf, w, h)
    rgba, ref_d = raster_cpu.rasterize_setup(ti, tf, w, h)
    _bits(depth, ref_d)
    assert np.abs(_u8(color).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("kind", ["k4", "k4c", "k6_cap2"])
def test_ties_resolve_to_the_first_submitted_row(kind):
    """Every triangle duplicated with other colors: the frame equals the
    frame of the originals alone, through each list kernel."""
    ti, tf, w, h = _setup("tie_soup_256x128")
    scene, md = make_jax_soup(60, seed=3, extent=2.0)
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti1, tf1 = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                        w, h)
    c_dup, d_dup = _run(kind, ti, tf, w, h)
    c_one, d_one = _run(kind, ti1, tf1, w, h)
    np.testing.assert_array_equal(c_dup, c_one)
    _bits(d_dup, d_one)


PALLAS = {
    "k5": lambda ti, tf, w, h: rp.rasterize_setup_pallas_hbm(
        ti, tf, w, h, interpret=True),
    "k6_cap2": lambda ti, tf, w, h: rp.rasterize_setup_pallas_binned(
        ti, tf, w, h, interpret=True, cap=2),
}


@pytest.mark.parametrize("kind", list(PALLAS))
def test_plain_matches_pallas_interpret(kind):
    ti, tf, w, h = _setup("clipped_soup_384x128")
    color, depth = _run(kind, ti, tf, w, h)
    ref_c, ref_d = PALLAS[kind](jnp.asarray(ti), jnp.asarray(tf), w, h)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)
    assert (depth < 1.0).mean() > 0.1
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    np.testing.assert_allclose(depth, ref_d, rtol=0, atol=2e-6)
    assert np.abs(_u8(color).astype(np.int32)
                  - _u8(ref_c.view(np.int32)).astype(np.int32)).max() <= 1


def test_constants_match_reference():
    assert tr.HBM_PAIR_BUDGET == rp.HBM_PAIR_BUDGET
    assert tr.BIN_PAIR_BUDGET == rp.BIN_PAIR_BUDGET
    assert tr.MAX_RESIDENT_ROWS == rp.VMEM_RESIDENT_MAX_TRIS
    default = inspect.signature(rp.prepare_binned_hbm_inputs).parameters
    assert tr.COARSE_CB == default["coarse_cb"].default
    for n in (1, 120, 4096, 4097, 65536, 10**6):
        assert tr.bin_cap_for(n) == rp.bin_cap_for(n)


def _big_soup():
    """27 000 triangles (33 144 setup rows, above the 32768-row bound),
    nearly all pushed behind the camera so the frame stays cheap on the
    CPU; the rest are small, some clipped by the near plane."""
    scene, md = make_triangle_soup(27000, seed=5, extent=2.0,
                                   behind_camera_fraction=0.985,
                                   triangle_size=0.4)
    v = md.vertex_data.reshape(-1, 16)
    v[3 * 26600:3 * 26630:3, 2] += 15.0
    return scene, md


def test_renderer_above_the_row_bound_matches_oracle():
    """The whole slice above 32768 rows: the port's Renderer through K4
    (auto), K5 (hierarchy) and K4c (tile_lists) gives one frame, which
    equals the oracle's."""
    w, h = 256, 64
    scene, md = _big_soup()
    frames = {}
    for binning in ("auto", "hierarchy", "tile_lists"):
        r = Renderer(RenderConfig(width=w, height=h, binning=binning),
                     device="cpu")
        r.load_scene(scene, md)
        assert len(r.flat.tri_vidx) > 27000
        frames[binning] = r.render_and_read()
    img, depth = frames["auto"]
    assert (depth < 1.0).mean() > 0.05
    for other in ("hierarchy", "tile_lists"):
        np.testing.assert_array_equal(frames[other][0], img)
        _bits(frames[other][1], depth)
    ref_img, ref_depth = raster_cpu.render_scene_cpu(scene, md, w, h)
    _bits(depth, ref_depth)
    assert np.abs(img.astype(np.int32) - ref_img.astype(np.int32)).max() <= 1


def test_kernels_refuse_cpu_tensors():
    """The new kernel launchers never fall back to the plain versions."""
    ti, tf, w, h = _setup("clipped_soup_384x128")
    ti, tf = _t(ti), _t(tf)
    before = [k.launches for k in tr.KERNELS]
    hbm = tr.prepare_binned_hbm_inputs(ti, tf, w, h)
    coarse = tr.prepare_binned_hbm_inputs(ti, tf, w, h, coarse_cap=8)
    calls = [
        lambda: tr.raster_binned_kernel(*hbm, w, h),
        lambda: tr.raster_binned_coarse_kernel(*coarse, w, h),
        lambda: tr.raster_hbm_kernel(*tr.prepare_raster_inputs(ti, tf), w, h),
        lambda: tr.raster_lists_kernel(*tr.prepare_binned_inputs(ti, tf, w, h),
                                       w, h),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="coarse"):
        tr.raster_binned_kernel(*coarse, w, h)
    with pytest.raises(ValueError, match="coarse"):
        tr.raster_binned_coarse_kernel(*hbm, w, h)
    assert [k.launches for k in tr.KERNELS] == before


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card raises; it is never run
    through the plain versions."""
    ti, tf, w, h = _setup("clipped_soup_384x128")
    ti, tf = _t(ti).to("meta"), _t(tf).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tr.rasterize_setup_hbm(ti, tf, w, h)
    with pytest.raises(ValueError, match="unsupported device"):
        tr.rasterize_setup_binned(ti, tf, w, h)


def test_padding_rows_follow_the_reference():
    """Rows whose bbox clamps to empty below the last visible row get a
    one-tile footprint in the reference's prepares, so K4 and K6 list them
    and draw them into the padding rows, where K5's bbox test skips them;
    the visible frame is the same bits through all three."""
    scene, md = make_jax_soup(200, seed=2, extent=6.0)
    w, h, pad_h = 256, 80, 96
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                      w, h)
    below = (ti[:, g.I_VALID] > 0) & (ti[:, g.I_IMIN] > ti[:, g.I_IMAX])
    assert below.sum() > 0
    ours = tr.prepare_binned_hbm_inputs(_t(ti), _t(tf), w, pad_h)
    ref = rp.prepare_binned_hbm_inputs(jnp.asarray(ti), jnp.asarray(tf), w,
                                       pad_h)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    c5, d5 = _run("k5", ti, tf, w, pad_h)
    for kind in ("k4", "k6"):
        color, depth = _run(kind, ti, tf, w, pad_h)
        np.testing.assert_array_equal(color[:h], c5[:h])
        _bits(depth[:h], d5[:h])
        assert (depth[h:] < 1.0).sum() > (d5[h:] < 1.0).sum()


def test_record_budget_holds_with_empty_bboxes():
    """Valid rows whose bbox clamps to empty can have a negative
    footprint.  The reference's prefix clamp sums it as negative, so its
    listed pairs pass the record budget (269 for 268 here); the port
    counts it 0, stays within the budget, and its frame is still K5's."""
    w, h, budget = 256, 64, 268
    scene, md = make_jax_soup(600, seed=3, extent=6.0)
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                      w, h)
    head = ti[:g.head_count(ti.shape[0])]
    foot = ((head[:, g.I_JMAX] // tr.TILE_W - head[:, g.I_JMIN] // tr.TILE_W
             + 1)
            * (head[:, g.I_IMAX] // tr.TILE_H - head[:, g.I_IMIN] // tr.TILE_H
               + 1))
    assert ((head[:, g.I_VALID] > 0) & (foot < 0)).any()
    ref = rp.prepare_binned_hbm_inputs(jnp.asarray(ti), jnp.asarray(tf), w, h,
                                       cap=4, pair_budget=budget)
    assert int(ref[0][-1]) > budget
    ours = tr.prepare_binned_hbm_inputs(_t(ti), _t(tf), w, h, cap=4,
                                        pair_budget=budget)
    assert int(ours[0][-1]) <= budget == ours[1].shape[0]
    color, depth = tr.raster_binned_plain(*ours, w, h)
    c5, d5 = _run("k5", ti, tf, w, h)
    assert (d5 < 1.0).mean() > 0.05
    np.testing.assert_array_equal(color.numpy(), c5)
    _bits(depth.numpy(), d5)
