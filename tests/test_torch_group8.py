"""The port's group-tile raster (zrenderer_tpu_torch/ops/experiments/
raster_group8.py: K10g8, K10g8g, K10g8d) against the JAX package, the
port's production plain versions and the NumPy oracle, given shared
setup rows.

* The prepare equals ``prepare_group8_inputs`` (XLA on the CPU) exactly:
  spans, gate, list rows (the lanes in use), the three bbox tables and the
  leftover rows.  A valid head row whose bbox clamps to empty is dead in
  the port (unlisted, valid flag cleared), so the reference is given the
  same rows with those rows' valid flag cleared; where a scene has none,
  that is the reference's own input.
* The plain frames equal bit for bit the production plain versions of
  the same traversal rule: K5 (``raster_hier_plain``) for the flat frame,
  K5g (``gbuffer_hbm_plain``, the same epilogue form) for the G-buffer,
  K3d (``depth_hier_plain``) for the depth plane; against the oracle
  coverage and depth exact, u8 within 1 LSB (the oracle divides where the
  kernels multiply by 1/den).
* The reference's list budget counts rows clamped to an empty bbox
  (ROADMAP Queue 3): it overruns its budget and lists rows in tiles their
  bbox misses; the port lists neither, and its frame is still K5's.

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py; here their wrappers must refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gbuffer import lit_setup
from test_torch_raster import _setup, _u8
from test_torch_shadow import edge_setup
from zrenderer_tpu.engine.upload import flatten_scene as ref_flatten_scene
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.ops.experiments import raster_group8 as rg8
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.procedural import make_triangle_soup
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_group8 as g8

# The plain kernels run thousands of small torch ops: one intra-op thread
# a test worker (see test_torch_gbuffer.py).
torch.set_num_threads(1)

T = torch.from_numpy


def soup_setup(w, h, n, seed, blow_up=False, materials=False):
    """The reference experiment tests' soup (tests/test_raster_group8.py
    ``_setup_soup``): ``blow_up`` scales triangles 20-29 ten times (past
    the pair cap: leftover rows) and pushes a corner of 30-39 through the
    near plane (clipped fan rows); ``materials`` sets draw 0's constants."""
    scene, md = make_triangle_soup(n, seed=seed, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    if blow_up:
        for t in range(20, 30):
            tri = v[3 * t:3 * t + 3, 0:3]
            c = tri.mean(axis=0)
            v[3 * t:3 * t + 3, 0:3] = c + (tri - c) * 10.0
        for t in range(30, 40):
            v[3 * t, 2] += 15.0
    flat = ref_flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    table = None
    if materials:
        table = np.zeros((flat.draw_count, g.MATERIAL_COLS), np.float32)
        table[0] = (1.0, 0.2, 0.0, 0.1, 0.0, 1.0)
    ti, tf = g.geometry_pipeline(np, flat.positions, flat.attrs,
                                 flat.tri_vidx, mats, flat.vert_node, w, h,
                                 material_table=table)
    return ti, tf, w, h


def empty_setup(w=128, h=32):
    """No live row (tests/test_raster_group8.py ``test_group8_empty_scene``)."""
    t = g.capped_rows(64)
    ti = np.zeros((t + (-t) % 64, g.NI32), np.int32)
    ti[:, g.I_JMIN] = 1
    ti[:, g.I_BIAS0:g.I_BIAS2 + 1] = 2**31 - 1
    return ti, np.zeros((ti.shape[0], g.NF32), np.float32), w, h


def setup(case):
    if case == "blow_up_256x64":
        return soup_setup(256, 64, 150, 3, blow_up=True)
    if case == "edge_clamped_128":
        return edge_setup()
    if case == "empty_128x32":
        return empty_setup()
    return _setup(case)


def empty_bbox_rows(ti):
    """Valid head rows whose bbox clamps to empty."""
    head = ti[:g.head_count(ti.shape[0])]
    return np.nonzero((head[:, g.I_VALID] > 0)
                      & ((head[:, g.I_JMIN] > head[:, g.I_JMAX])
                         | (head[:, g.I_IMIN] > head[:, g.I_IMAX])))[0]


def _bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  np.asarray(b).view(np.int32))


PREPARE_CASES = {
    "tie_soup_256x128": {},
    "test_scene_256x64": {},
    "edge_clamped_128": {},
    "blow_up_256x64": dict(list_budget=32, chunk=16),
    "clipped_soup_384x128": dict(pair_cap=2, list_budget=96, chunk=32),
}


@pytest.mark.parametrize("case", list(PREPARE_CASES))
def test_prepare_group8_matches_jax(case):
    ti, tf, w, h = setup(case)
    kw = PREPARE_CASES[case]
    dead = empty_bbox_rows(ti)
    if case in ("tie_soup_256x128", "test_scene_256x64", "edge_clamped_128"):
        assert (len(dead) > 0) == (case != "tie_soup_256x128")
    ti_ref = ti.copy()
    ti_ref[dead, g.I_VALID] = 0
    ref = rg8.prepare_group8_inputs(jnp.asarray(ti_ref), jnp.asarray(tf), w,
                                    h, **kw)
    ours = g8.prepare_group8_inputs(T(ti), T(tf), w, h, **kw)
    L = ours.rows.shape[0]
    assert L == ref.rows.shape[0] - kw.get("chunk", g8.CHUNK)
    assert int(ours.offs[-1]) > 0 and int(ours.tile_any.sum()) > 0
    _bits(ours.offs.numpy(), ref.offs)
    _bits(ours.tile_any.numpy(), ref.tile_any)
    _bits(ours.rows.numpy(), np.asarray(ref.rows)[:L, :g8.ROW_LANES])
    assert not np.asarray(ref.rows)[:, g8.ROW_LANES:].any()
    for name in ("megas", "supers", "blocks"):
        _bits(getattr(ours, name).numpy(), getattr(ref, name))
    packed = rp._hbm_flat_inputs(jnp.asarray(ours.hier.numpy()),
                                 jnp.asarray(ours.hier_f.numpy()))
    _bits(packed[0], ref.ti_hbm)
    _bits(packed[1], ref.tf_hbm)


FRAME_CASES = {
    "clipped_soup_384x128": {},
    "tie_soup_256x128": {},
    "blow_up_256x64": dict(chunk=16),
    "blow_up_256x64_tiny_budget": dict(chunk=16, list_budget=32),
    "edge_clamped_128": {},
    "test_scene_256x64_cap1": dict(pair_cap=1),
}


def frame_setup(name):
    case = name.removesuffix("_tiny_budget").removesuffix("_cap1")
    return setup(case), FRAME_CASES[name]


@pytest.mark.parametrize("name", list(FRAME_CASES))
def test_plain_group8_flat_and_depth_equal_k5_and_oracle(name):
    (ti, tf, w, h), kw = frame_setup(name)
    inp = g8.prepare_group8_inputs(T(ti), T(tf), w, h, **kw)
    # Both phases draw: the lists hold pairs and live rows are left over.
    assert int(inp.offs[-1]) > 0
    assert ((inp.hier[:, g.I_VALID] > 0)
            & (inp.hier[:, g.I_JMIN] <= inp.hier[:, g.I_JMAX])).any()
    color, depth = g8.rasterize_setup_group8(T(ti), T(tf), w, h, **kw)
    assert (depth < 1.0).float().mean() > 0.02
    k5 = tr.raster_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)
    _bits(color, k5[0])
    _bits(depth, k5[1])
    d_only = g8.rasterize_depth_group8(T(ti), T(tf), w, h, **kw)
    _bits(d_only, tr.depth_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)),
                                      w, h))
    rgba, ref_d = raster_cpu.rasterize_setup(ti, tf, w, h)
    np.testing.assert_array_equal(depth.numpy(), ref_d)
    np.testing.assert_array_equal(d_only.numpy(), ref_d)
    assert np.abs(_u8(color.numpy()).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("kw", [{}, dict(pair_cap=1, list_budget=64,
                                         chunk=32)])
@pytest.mark.parametrize("case", ["clipped_soup_384x128", "tie_soup_256x128",
                                  "procedural_cubes_256x96"])
def test_plain_group8_gbuffer_equals_k5g(case, kw):
    """13 planes bit-equal to K5g's (random per-triangle materials, so a
    wrong winner shows in the constant planes)."""
    ti, tf, w, h = lit_setup(case, seed=4)
    ours = g8.rasterize_gbuffer_group8(T(ti), T(tf), w, h, **kw)
    ref = tr.gbuffer_hbm_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)
    assert len(ours) == tr.GBUFFER_PLANES
    assert (ours[1] < 1.0).float().mean() > 0.02
    assert torch.unique(ours[7][ours[1] < 1.0]).numel() > 1
    for a, b in zip(ours, ref):
        _bits(a, b)


def test_duplicates_resolve_to_the_first_row():
    """Every triangle of the tie soup repeats with other colors: phase 1
    and phase 2 both keep the first-submitted row."""
    ti, tf, w, h = setup("tie_soup_256x128")
    assert g.head_count(ti.shape[0]) == 128
    assert not (ti[128:, g.I_VALID] > 0).any()  # no clipped fan rows
    one = ti.copy()
    one[60:120, g.I_VALID] = 0  # the 60 duplicates after 60 originals
    one[60:120, g.I_JMIN] = 1
    one[60:120, g.I_JMAX] = 0
    for kw in ({}, dict(pair_cap=1, list_budget=48, chunk=16)):
        color, depth = g8.rasterize_setup_group8(T(ti), T(tf), w, h, **kw)
        c1, d1 = g8.rasterize_setup_group8(T(one), T(tf), w, h, **kw)
        _bits(color, c1)
        _bits(depth, d1)


def test_empty_scene():
    ti, tf, w, h = setup("empty_128x32")
    color, depth = g8.rasterize_setup_group8(T(ti), T(tf), w, h)
    assert (depth == 1.0).all() and (color == tr._ALPHA_BITS).all()
    assert (g8.rasterize_depth_group8(T(ti), T(tf), w, h) == 1.0).all()
    planes = g8.rasterize_gbuffer_group8(T(ti), T(tf), w, h)
    assert (planes[0] == tr._ALPHA_BITS).all() and (planes[1] == 1.0).all()
    assert not any(p.any() for p in planes[2:])


def test_gbuffer_epilogue_form():
    """Rows that pass with 1/w interpolating to den <= 0: K10g8g writes
    buf * where(covered, inv, 0) (K2g/K4g/K5g's form), so a negative
    numerator gives -0.0 and an infinite one NaN, bit-equal to K5g and
    unlike K3g's where(covered, buf * inv, 0)."""
    ti, tf, w, h = lit_setup("clipped_soup_384x128", seed=5)
    tf = tf.copy()
    tf[:, g.F_RW0:g.F_RW0 + 3] *= -1.0
    tf[::7, g.F_U0:g.F_U0 + 3] = np.inf
    ours = g8.rasterize_gbuffer_group8(T(ti), T(tf), w, h)
    prep = tr.prepare_raster_inputs(T(ti), T(tf))
    masked = tr.gbuffer_hbm_plain(*prep, w, h)
    where = tr.gbuffer_hier_plain(*prep, w, h)
    for a, b in zip(ours, masked):
        _bits(a, b)
    u = ours[2]
    drawn = ours[1] < 1.0
    assert drawn.any() and not (ours[0][drawn] & 0xFFFFFF).any()
    assert torch.signbit(u[drawn]).any() and torch.isnan(u[drawn]).any()
    assert not torch.signbit(where[2]).any()
    assert not torch.isnan(where[2]).any()


def test_kernel_wrappers_take_cuda_tensors_only():
    ti, tf, w, h = setup("test_scene_256x64")
    inp = g8.prepare_group8_inputs(T(ti), T(tf), w, h)
    for kern in g8.KERNELS:
        with pytest.raises(ValueError, match="CUDA"):
            kern(*inp, w, h)
    g8.rasterize_setup_group8(T(ti), T(tf), w, h)  # CPU: the plain version
    assert all(k.launches == 0 for k in g8.KERNELS)
    with pytest.raises(ValueError):
        g8.rasterize_setup_group8(T(ti), T(tf), 200, 64)


def edge_soup_256x64():
    """The wide soup at 256x64: 20 valid rows clamp to an empty bbox with a
    negative 8x128-tile footprint, right of or below the frame."""
    scene, md = make_triangle_soup(600, seed=3, extent=6.0)
    flat = ref_flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, 256, 64)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                      256, 64)
    return ti, tf, 256, 64


def test_list_budget_counts_no_empty_bbox_row():
    """The reference sums where(listed, ntx * nty, 0) over rows admitted
    by ``foot <= pair_cap`` alone (raster_group8.py:121-132): a row clamped
    empty on one axis has a negative footprint and lowers the sum, so 167
    pairs pass a 160-row budget.  The port's spans fit its budget, and its
    frame is K5's."""
    ti, tf, w, h = edge_soup_256x64()
    head = ti[:g.head_count(ti.shape[0])]
    foot = ((head[:, g.I_JMAX] // g8.GT_W - head[:, g.I_JMIN] // g8.GT_W + 1)
            * (head[:, g.I_IMAX] // g8.GT_H - head[:, g.I_IMIN] // g8.GT_H
               + 1))
    assert ((head[:, g.I_VALID] > 0) & (foot < 0)).sum() == 20
    kw = dict(list_budget=160, chunk=16)
    ref = rg8.prepare_group8_inputs(jnp.asarray(ti), jnp.asarray(tf), w, h,
                                    **kw)
    assert int(ref.offs[-1]) == 167 > 160
    ours = g8.prepare_group8_inputs(T(ti), T(tf), w, h, **kw)
    assert int(ours.offs[-1]) <= 160 == ours.rows.shape[0]
    color, depth = g8.raster_group8_plain(*ours, w, h)
    k5 = tr.raster_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)
    assert (depth < 1.0).float().mean() > 0.1
    _bits(color, k5[0])
    _bits(depth, k5[1])


def test_no_row_listed_in_a_tile_its_bbox_misses():
    """The reference lists rows whose bbox clamps to empty (a sliver
    between pixel centres, or a row past the frame in the guard band with
    both tile ranges reversed, whose footprint is positive): it keys them
    into tiles their bbox misses.  Every row the port lists meets each
    tile it is listed in."""
    def misses(inp, ti, w):
        offs = np.asarray(inp.offs)
        ids = np.asarray(inp.rows)[:, g8.C_ID]
        tiles_x = w // g8.GT_W
        count = 0
        for t in range(len(offs) - 1):
            row0, col0 = t // tiles_x * g8.GT_H, t % tiles_x * g8.GT_W
            for r in ids[offs[t]:offs[t + 1]]:
                jmin, jmax, imin, imax = ti[r, g.I_JMIN:g.I_IMAX + 1]
                count += not (jmax >= col0 and jmin < col0 + g8.GT_W
                              and imax >= row0 and imin < row0 + g8.GT_H
                              and jmin <= jmax and imin <= imax)
        return count

    for ti, tf, w, h in (setup("test_scene_256x64"), edge_soup_256x64()):
        ref = rg8.prepare_group8_inputs(jnp.asarray(ti), jnp.asarray(tf), w,
                                        h)
        ours = g8.prepare_group8_inputs(T(ti), T(tf), w, h)
        assert misses(ref, ti, w) > 0
        assert misses(ours, ti, w) == 0


def test_constants_match_reference():
    assert (g8.GT_H, g8.GT_W, g8.GROUP, g8.CHUNK, g8.PAIR_CAP) == (
        rg8.GT_H, rg8.GT_W, rg8.GROUP, rg8.CHUNK, rg8.PAIR_CAP)
    lanes = ("C_DX0", "C_DY0", "C_C0", "C_DX1", "C_DY1", "C_C1", "C_DX2",
             "C_DY2", "C_C2", "C_BIAS", "C_ID", "C_ZA", "C_RW", "C_CR",
             "C_CG", "C_CB", "C_U", "C_V", "C_NX", "C_NY", "C_NZ", "C_MET",
             "C_RGH", "C_EMR", "C_EMG", "C_EMB", "C_TEX")
    assert [getattr(g8, n) for n in lanes] == [getattr(rg8, n) for n in lanes]
    assert g8.ROW_LANES == rg8.C_TEX + 1 < rg8.ROW_LANES
    assert g8.list_budget_for(1000) == rg8.list_budget_for(1000)
    assert g8.list_budget_for(50000, 16) == rg8.list_budget_for(50000, 16)
