"""The port's lane-parallel raster (zrenderer_tpu_torch/ops/experiments/
raster_vec.py: K10vec, K10vecg) against the JAX package, the port's
production plain versions and the NumPy oracle, given shared setup rows.

* The prepare equals ``prepare_vec_inputs`` (XLA on the CPU) exactly: the
  superblock and block tables, and the records' lanes in use (the
  reference's lanes [0, REC_LANES); the rest of its 128 are zero).
* The plain frames equal bit for bit the production plain versions of the
  same rule (strict less in row order): K5 (``raster_hier_plain``) for the
  flat frame, K3g (``gbuffer_hier_plain``, the same epilogue form) for the
  G-buffer; against the oracle coverage and depth exact, u8 within 1 LSB.

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py; here their wrappers must refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gbuffer import lit_setup
from test_torch_group8 import _bits, setup
from test_torch_raster import _u8
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops.experiments import raster_vec as rrv
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.procedural import make_triangle_soup
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_vec as rv

torch.set_num_threads(1)

T = torch.from_numpy


def twin_soup_setup(w=256, h=64):
    """The reference's tie case (tests/test_raster_vec.py), a 500-triangle
    soup with clipped fan rows, whose triangles 74-83 repeat 64-73 exactly:
    one 32-row subgroup holds both.  (The reference repeats 0-9 as 10-19,
    but the soup's first 50 triangles lie behind the camera, so its rows
    0-19 are dead and its ties never meet.)"""
    scene, md = make_triangle_soup(500, seed=7, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(74, 84):
        v[3 * t:3 * t + 3, 0:3] = v[3 * (t - 10):3 * (t - 10) + 3, 0:3]
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    return (*g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats, w,
                                      h), w, h)


def vec_setup(case):
    return twin_soup_setup() if case == "twin_soup_256x64" else setup(case)


CASES = ["test_scene_256x64", "clipped_soup_384x128", "tie_soup_256x128",
         "twin_soup_256x64", "edge_clamped_128", "empty_128x32"]


@pytest.mark.parametrize("case", CASES)
def test_prepare_vec_matches_jax(case):
    ti, tf, _, _ = vec_setup(case)
    ours = rv.prepare_vec_inputs(T(ti), T(tf))
    ref = rrv.prepare_vec_inputs(jnp.asarray(ti), jnp.asarray(tf))
    _bits(ours[0].numpy(), ref[0])
    _bits(ours[1].numpy(), ref[1])
    ref_rec = np.asarray(ref[2])
    assert ours[2].shape == (ref_rec.shape[0], rv.REC_LANES)
    _bits(ours[2].numpy(), ref_rec[:, :rv.REC_LANES])
    assert not ref_rec[:, rv.REC_LANES:].any()


@pytest.mark.parametrize("case", CASES)
def test_plain_vec_equals_k5_and_oracle(case):
    ti, tf, w, h = vec_setup(case)
    color, depth = rv.rasterize_setup_vec(T(ti), T(tf), w, h)
    k5 = tr.raster_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)
    _bits(color, k5[0])
    _bits(depth, k5[1])
    rgba, ref_d = raster_cpu.rasterize_setup(ti, tf, w, h)
    np.testing.assert_array_equal(depth.numpy(), ref_d)
    assert np.abs(_u8(color.numpy()).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1
    if case == "empty_128x32":
        assert (depth == 1.0).all() and (color == tr._ALPHA_BITS).all()
    else:
        assert (depth < 1.0).float().mean() > 0.02


@pytest.mark.parametrize("case", ["clipped_soup_384x128", "tie_soup_256x128",
                                  "procedural_cubes_256x96"])
def test_plain_vec_gbuffer_equals_k3g(case):
    """13 planes bit-equal to K3g's, random per-triangle materials."""
    ti, tf, w, h = lit_setup(case, seed=6)
    ours = rv.rasterize_gbuffer_vec(T(ti), T(tf), w, h)
    ref = tr.gbuffer_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)
    assert len(ours) == tr.GBUFFER_PLANES
    assert (ours[1] < 1.0).float().mean() > 0.02
    assert torch.unique(ours[7][ours[1] < 1.0]).numel() > 1
    for a, b in zip(ours, ref):
        _bits(a, b)


def test_twins_resolve_to_the_first_row():
    """Triangles 74-83 of the twin soup repeat 64-73 with other colors, in
    one subgroup: the frame equals the one without the repeats, and
    differs from the one without the originals."""
    ti, tf, w, h = vec_setup("twin_soup_256x64")
    assert ((ti[64:74, g.I_VALID] > 0) & (ti[74:84, g.I_VALID] > 0)).sum() >= 4

    def without(rows):
        dead = ti.copy()
        dead[rows, g.I_VALID] = 0
        dead[rows, g.I_JMIN] = 1
        dead[rows, g.I_JMAX] = 0
        return rv.rasterize_setup_vec(T(dead), T(tf), w, h)

    color, depth = rv.rasterize_setup_vec(T(ti), T(tf), w, h)
    c1, d1 = without(slice(74, 84))
    _bits(color, c1)
    _bits(depth, d1)
    assert not torch.equal(color, without(slice(64, 74))[0])


def test_gbuffer_epilogue_form():
    """Rows that pass with den <= 0: K10vecg writes where(covered,
    buf * inv, 0) (K3g's form, the reference's :341): 0.0 where K5g's
    form gives -0.0 or NaN."""
    ti, tf, w, h = lit_setup("clipped_soup_384x128", seed=5)
    tf = tf.copy()
    tf[:, g.F_RW0:g.F_RW0 + 3] *= -1.0
    tf[::7, g.F_U0:g.F_U0 + 3] = np.inf
    ours = rv.rasterize_gbuffer_vec(T(ti), T(tf), w, h)
    prep = tr.prepare_raster_inputs(T(ti), T(tf))
    where = tr.gbuffer_hier_plain(*prep, w, h)
    masked = tr.gbuffer_hbm_plain(*prep, w, h)
    for a, b in zip(ours, where):
        _bits(a, b)
    drawn = ours[1] < 1.0
    assert drawn.any() and (ours[2][drawn] == 0.0).all()
    assert not torch.signbit(ours[2]).any()
    assert torch.signbit(masked[2][drawn]).any()
    assert torch.isnan(masked[2][drawn]).any()


def test_record_layout():
    """Records carry the setup ints, the folded constants, the subgroup
    bboxes on every 32nd row and the setup floats, bit for bit."""
    ti, tf, _, _ = vec_setup("clipped_soup_384x128")
    _, _, rec = rv.prepare_vec_inputs(T(ti), T(tf))
    rec = rec.numpy()
    n = ti.shape[0]
    assert rec.shape[0] % g.RASTER_BLOCK == 0
    np.testing.assert_array_equal(rec[:n, :g.NI32], ti)
    _bits(rec[:n, rv._F_BASE:], tf)
    a0 = ti[:, g.I_DY0] * ti[:, g.I_X1] - ti[:, g.I_DX0] * ti[:, g.I_Y1]
    np.testing.assert_array_equal(rec[:n, rv._A_BASE], a0)
    alive = rec[:, g.I_VALID] > 0
    for s in range(rec.shape[0] // rv.SUBGROUP):
        rows = slice(s * rv.SUBGROUP, (s + 1) * rv.SUBGROUP)
        bb = rec[s * rv.SUBGROUP, rv._SG_BBOX:rv._SG_BBOX + 4]
        if not alive[rows].any():
            assert bb[0] > bb[1] and bb[2] > bb[3]
            continue
        live = rec[rows][alive[rows]]
        assert tuple(bb) == (live[:, g.I_JMIN].min(), live[:, g.I_JMAX].max(),
                             live[:, g.I_IMIN].min(), live[:, g.I_IMAX].max())


def test_kernel_wrappers_take_cuda_tensors_only():
    ti, tf, w, h = vec_setup("test_scene_256x64")
    prep = rv.prepare_vec_inputs(T(ti), T(tf))
    for kern in rv.KERNELS:
        with pytest.raises(ValueError, match="CUDA"):
            kern(*prep, w, h)
    rv.rasterize_gbuffer_vec(T(ti), T(tf), w, h)  # CPU: the plain version
    assert all(k.launches == 0 for k in rv.KERNELS)
    with pytest.raises(ValueError):
        rv.rasterize_setup_vec(T(ti), T(tf), 256, 40)


def test_constants_match_reference():
    assert (rv.SUBGROUP, rv.CHUNK_H, rv._A_BASE, rv._SG_BBOX, rv._F_BASE,
            rv.BIG_Z) == (rrv.SUBGROUP, rrv.CHUNK_H, rrv._A_BASE,
                          rrv._SG_BBOX, rrv._F_BASE, rrv.BIG_Z)
    assert rv.REC_LANES == rrv._F_BASE + g.NF32 < rrv.REC_LANES
