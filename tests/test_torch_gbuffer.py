"""The port's G-buffer raster (zrenderer_tpu_torch/ops/raster.py and the lit
inputs of ops/geometry.py) against the JAX package on shared inputs.

* The lit geometry columns (normal transform, material constants) are
  bit-exact against ``geometry_pipeline_cols(np, ...)``.
* The plain K2g, K3g, K4g, K5g and K6g are held against
  ``raster_xla.rasterize_gbuffer_xla`` under the parity contract
  (docs/RASTER_SPEC.md §5): coverage and the six constant planes exact,
  u8 within 1 LSB, depth within 2e-6, u/v/normals within rtol 1e-5, atol
  1e-6.  The slack is XLA:CPU's: it may contract the f32 chains that eager
  torch rounds op by op.
* ``select_gbuffer_raster`` follows ``render_gbuffer_pallas`` branch for
  branch (not the flat dispatch).

Every material table is random per triangle, so a wrong winner shows in
the constant planes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raster import CASES, _u8
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.ops import raster_xla as rx
from zrenderer_tpu.scene.procedural import make_test_scene
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr

# The plain kernels run thousands of small torch ops.  Under xdist every
# worker imports this module; one intra-op thread a worker keeps six
# workers from oversubscribing the cores, which slowed such ops 10-100x.
torch.set_num_threads(1)

LIT_CASES = dict(CASES, procedural_cubes_256x96=(make_test_scene, 256, 96, 16))


def lit_inputs(case, per_draw=False, seed=0):
    """(ccols, tri_node, matrices, normal matrices, material table, w, h):
    random normal matrices per draw and a random material table, per
    triangle unless ``per_draw``.  Scenes without uv and normals (the
    soups) get random ones per corner."""
    build, w, h, tri_align = LIT_CASES[case]
    scene, md = build()
    flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ccols, tri_node = flat.expand_corner_cols()
    rng = np.random.default_rng(seed)
    uv_normal = np.array([c * 16 + j for c in range(3) for j in range(8, 13)])
    if not ccols[uv_normal].any():
        ccols[uv_normal] = rng.standard_normal(
            (len(uv_normal), ccols.shape[1])).astype(np.float32)
    nm = rng.standard_normal((len(mats), 3, 3)).astype(np.float32)
    rows = len(mats) if per_draw else ccols.shape[1]
    table = rng.random((rows, g.MATERIAL_COLS), dtype=np.float32)
    return ccols, tri_node, mats, nm, table, w, h


def lit_setup(case, seed=0):
    """Shared setup rows with the lit columns (the NumPy geometry, which
    the port equals bit for bit)."""
    ccols, tri_node, mats, nm, table, w, h = lit_inputs(case, seed=seed)
    ti, tf = g.geometry_pipeline_cols(np, ccols, tri_node, mats, w, h,
                                      normal_matrices=nm,
                                      material_table=table)
    return ti, tf, w, h


# kind -> the port's wrapper (plain version on CPU tensors)
WRAPPERS = {"k2g": tr.rasterize_gbuffer_small, "k3g": tr.rasterize_gbuffer,
            "k4g": tr.rasterize_gbuffer_binned_hbm,
            "k5g": tr.rasterize_gbuffer_hbm,
            "k6g": tr.rasterize_gbuffer_binned}


def plain_gbuffer(kind, ti, tf, w, h, **kw):
    planes = WRAPPERS[kind](torch.from_numpy(ti), torch.from_numpy(tf), w, h,
                            **kw)
    assert len(planes) == tr.GBUFFER_PLANES == 13
    assert planes[0].dtype == torch.int32
    assert all(p.dtype == torch.float32 for p in planes[1:])
    assert all(tuple(p.shape) == (h, w) for p in planes)
    return [p.numpy() for p in planes]


def assert_gbuffer_close(ours, ref_u8, ref):
    """The contract against a JAX G-buffer: ``ours`` the port's 13 planes
    (packed color first), ``ref_u8`` the reference's (H, W, 4) u8 color,
    ``ref`` its 12 f32 planes (depth, u, v, nx, ny, nz, constants)."""
    depth, ref_depth = ours[1], np.asarray(ref[0])
    covered = depth < 1.0
    assert covered.mean() > 0.02
    np.testing.assert_array_equal(covered, ref_depth < 1.0)
    np.testing.assert_allclose(depth, ref_depth, rtol=0, atol=2e-6)
    assert np.abs(_u8(ours[0]).astype(np.int32)
                  - np.asarray(ref_u8).astype(np.int32)).max() <= 1
    for a, b in zip(ours[2:7], ref[1:6]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(ours[7:], ref[6:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    # Distinct per-triangle constants reached the frame.
    assert np.unique(ours[7][covered]).size > 1


@pytest.mark.parametrize("per_draw", [False, True])
@pytest.mark.parametrize("case", list(LIT_CASES))
def test_lit_geometry_cols_bit_exact_vs_numpy(case, per_draw):
    ccols, tri_node, mats, nm, table, w, h = lit_inputs(case, per_draw)
    ti_ref, tf_ref = g.geometry_pipeline_cols(
        np, ccols, tri_node, mats, w, h, normal_matrices=nm,
        material_table=table)
    t = torch.from_numpy
    ti, tf = tg.geometry_pipeline_cols(
        t(ccols), t(tri_node), t(mats), w, h, normal_matrices=t(nm),
        material_table=t(table))
    ti, tf = ti.numpy(), tf.numpy()
    live = ti[:, g.I_VALID] > 0
    assert live.any()
    assert np.unique(tf[live, g.F_MET]).size >= (1 if per_draw else 6)
    assert (tf[live, g.F_NX0:g.F_NZ0 + 3] != 0).any()
    np.testing.assert_array_equal(ti, ti_ref)
    np.testing.assert_array_equal(tf.view(np.uint32), tf_ref.view(np.uint32))


def test_lit_columns_layout_matches_reference():
    assert (tg.F_U0, tg.F_V0, tg.F_NX0, tg.F_NY0, tg.F_NZ0) == (
        g.F_U0, g.F_V0, g.F_NX0, g.F_NY0, g.F_NZ0)
    assert (tg.F_MET, tg.F_RGH, tg.F_EMR, tg.F_EMG, tg.F_EMB, tg.F_TEX) == (
        g.F_MET, g.F_RGH, g.F_EMR, g.F_EMG, g.F_EMB, g.F_TEX) == tuple(
        range(30, 36))
    assert tg.MATERIAL_COLS == g.MATERIAL_COLS


def test_flat_columns_unchanged_without_lit_inputs():
    """Without normal matrices and a table the constant columns stay zero
    and the rows equal the flat rows."""
    ccols, tri_node, mats, _, _, w, h = lit_inputs("clipped_soup_384x128")
    t = torch.from_numpy
    ti, tf = tg.geometry_pipeline_cols(t(ccols), t(tri_node), t(mats), w, h)
    ti_ref, tf_ref = g.geometry_pipeline_cols(np, ccols, tri_node, mats, w, h)
    np.testing.assert_array_equal(ti.numpy(), ti_ref)
    np.testing.assert_array_equal(tf.numpy().view(np.uint32),
                                  tf_ref.view(np.uint32))
    assert not tf[:, tg.F_MET:tg.F_TEX + 1].any()


@pytest.mark.parametrize("case", list(LIT_CASES))
@pytest.mark.parametrize("kind", list(WRAPPERS))
def test_plain_gbuffer_matches_xla(kind, case):
    ti, tf, w, h = lit_setup(case)
    ours = plain_gbuffer(kind, ti, tf, w, h)
    ref = rx.rasterize_gbuffer_xla(jnp.asarray(ti), jnp.asarray(tf), w, h)
    assert_gbuffer_close(ours, ref[0], ref[1:])


@pytest.mark.parametrize("case", list(LIT_CASES))
def test_plain_gbuffer_kinds_agree(case):
    """The five traversals give the same G-buffer (the two epilogue forms
    differ only where a row passed with den <= 0, which these scenes do
    not have)."""
    ti, tf, w, h = lit_setup(case, seed=1)
    base = plain_gbuffer("k3g", ti, tf, w, h)
    for kind in ("k2g", "k4g", "k5g", "k6g"):
        for a, b in zip(plain_gbuffer(kind, ti, tf, w, h), base):
            np.testing.assert_array_equal(a, b)


def test_plain_k4g_under_small_budgets_matches_xla():
    """Records, budget clamp and leftover hierarchy all draw pixels."""
    ti, tf, w, h = lit_setup("clipped_soup_384x128", seed=2)
    prep = tr.prepare_binned_hbm_inputs(torch.from_numpy(ti),
                                        torch.from_numpy(tf), w, h, cap=4,
                                        pair_budget=100)
    assert int(prep[0][-1]) == 100
    assert (prep[5][:, tg.I_VALID] > 0).any()
    ours = plain_gbuffer("k4g", ti, tf, w, h, cap=4, pair_budget=100)
    ref = rx.rasterize_gbuffer_xla(jnp.asarray(ti), jnp.asarray(tf), w, h)
    assert_gbuffer_close(ours, ref[0], ref[1:])


def test_gbuffer_ties_resolve_to_the_first_submitted_row():
    """Every triangle duplicated with other colors and other constants:
    the G-buffer equals that of the originals alone, through all five."""
    ti, tf, w, h = lit_setup("tie_soup_256x128", seed=3)
    ccols, tri_node, mats, nm, table, _, _ = lit_inputs("tie_soup_256x128",
                                                        seed=3)
    build, _, _, tri_align = LIT_CASES["tie_soup_256x128"]
    originals = flatten_scene(*build(), pad=True,
                              tri_align=tri_align).num_triangles // 2
    one = np.arange(ccols.shape[1]) < originals
    ti1, tf1 = g.geometry_pipeline_cols(
        np, ccols[:, one], tri_node[one], mats, w, h, normal_matrices=nm,
        material_table=table[one])
    for kind in WRAPPERS:
        dup = plain_gbuffer(kind, ti, tf, w, h)
        alone = plain_gbuffer(kind, ti1, tf1, w, h)
        assert (dup[1] < 1.0).mean() > 0.02
        for a, b in zip(dup, alone):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))


def test_gbuffer_epilogue_forms():
    """K3g writes where(covered, buf * inv, 0), K2g/K4g/K5g buf *
    where(covered, inv, 0): they differ in the sign of zero and in NaN
    where a row passed with den <= 0; the constants stay as latched."""
    planes, _, _ = tr._tile_planes(1, 1, False, "cpu", gbuffer=True)
    planes["den"][0, 0, 0, :3] = torch.tensor([2.0, 0.0, -1.0])
    planes["u"][0, 0, 0, :3] = torch.tensor([-3.0, -3.0, float("inf")])
    planes["met"][0, 0, 0, :3] = torch.tensor([0.25, 0.5, 0.75])
    masked = tr._resolve_gbuffer(planes, masked_inv=True)
    where = tr._resolve_gbuffer(planes, masked_inv=False)
    um, uw = masked[2][0, :3], where[2][0, :3]
    assert um[0] == uw[0] == -1.5
    assert torch.signbit(um[1]) and not torch.signbit(uw[1])
    assert torch.isnan(um[2]) and uw[2] == 0.0
    for p in (masked, where):
        np.testing.assert_array_equal(p[7][0, :3].numpy(), [0.25, 0.5, 0.75])


def _expected_route(binning, rows):
    """``render_gbuffer_pallas``'s branches (raster_pallas.py:1059-1077),
    each mapped to the port's wrapper of the same kernel."""
    big = rows > rp.VMEM_RESIDENT_MAX_TRIS
    if rp._use_tile_lists(binning, rows):
        return (tr.rasterize_gbuffer_binned_hbm if big
                else tr.rasterize_gbuffer_binned)
    if big:
        return (tr.rasterize_gbuffer_hbm if binning == "hierarchy"
                else tr.rasterize_gbuffer_binned_hbm)
    if rp._use_small_bins(binning, rows):
        return tr.rasterize_gbuffer_small
    return tr.rasterize_gbuffer


@pytest.mark.parametrize("binning", list(tr.BINNINGS))
@pytest.mark.parametrize("tris", [120, 1024, 1025, 20000, 26000, 40000,
                                  1000000])
def test_gbuffer_dispatch_routes_like_render_gbuffer_pallas(tris, binning):
    rows = g.capped_rows(tris)
    assert (tr.select_gbuffer_raster(binning, rows)
            is _expected_route(binning, rows))


def test_gbuffer_dispatch_differs_from_flat():
    """Above the row bound tile_lists takes K4g without the coarse class
    (the flat dispatch takes K4c); unknown binnings raise."""
    big = g.capped_rows(40000)
    assert (tr.select_gbuffer_raster("tile_lists", big)
            is tr.rasterize_gbuffer_binned_hbm)
    assert (tr.select_raster("tile_lists", big)
            is tr.rasterize_setup_binned_hbm_coarse)
    with pytest.raises(ValueError, match="unknown binning"):
        tr.select_gbuffer_raster("dist", big)
    with pytest.raises(ValueError, match="coarse"):
        tr.gbuffer_binned_plain(*[None] * 7, object(), 128, 32)


def test_gbuffer_kernels_refuse_cpu_tensors():
    """The G-buffer launchers never fall back to the plain versions."""
    ti, tf, w, h = lit_setup("test_scene_256x64")
    ti, tf = torch.from_numpy(ti), torch.from_numpy(tf)
    before = [k.launches for k in tr.GBUFFER_KERNELS]
    hier = tr.prepare_raster_inputs(ti, tf)
    with pytest.raises(ValueError, match="CUDA"):
        tr.gbuffer_small_kernel(*tr.prepare_binned_small(ti, tf, w, h), w, h)
    with pytest.raises(ValueError, match="CUDA"):
        tr.gbuffer_hier_kernel(*hier, w, h)
    with pytest.raises(ValueError, match="CUDA"):
        tr.gbuffer_hbm_kernel(*hier, w, h)
    with pytest.raises(ValueError, match="CUDA"):
        tr.gbuffer_binned_kernel(*tr.prepare_binned_hbm_inputs(ti, tf, w, h),
                                 w, h)
    tr.rasterize_gbuffer_small(ti, tf, w, h)  # CPU: plain version, no launch
    assert [k.launches for k in tr.GBUFFER_KERNELS] == before
