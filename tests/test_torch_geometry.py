"""The port's column geometry (zrenderer_tpu_torch/ops/geometry.py) against
zrenderer_tpu/ops/geometry.py on shared inputs.

Contract (docs/RASTER_SPEC.md §5): against the NumPy path the port's CPU
rows are bit-exact, i32 and f32 (eager torch rounds after every op, like
NumPy); against the jnp path i32 rows are exact and f32 rows within 4 ulp
(the f32 setup row of the parity table).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.scene.mesh import MeshData
from zrenderer_tpu.scene.procedural import make_test_scene, make_triangle_soup
from zrenderer_tpu.scene.scene import Scene
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import geometry as tg

SCENE_DIR = os.path.join(os.path.dirname(__file__), "..", "content",
                         "scenes", "test_scene")


def _content_scene():
    return (Scene.load(os.path.join(SCENE_DIR, "scene.bin")),
            MeshData.load(os.path.join(SCENE_DIR, "meshes.bin")))


def _clipped_soup():
    """Soup with 20 triangles pushed through the near plane (fan rows)."""
    scene, md = make_triangle_soup(300, seed=7, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(40, 60):
        v[3 * t, 2] += 15.0
    return scene, md


def _wide_soup():
    """Soup spread past the guard band and behind the camera."""
    return make_triangle_soup(96, seed=7, extent=8.0,
                              behind_camera_fraction=0.5)


# name -> (scene factory, width, height, tri_align)
CASES = {
    "test_scene_256x64": (_content_scene, 256, 64, 256),
    "clipped_soup_384x128": (_clipped_soup, 384, 128, 64),
    "wide_soup_128x96": (_wide_soup, 128, 96, 32),
    "procedural_cubes_200x120": (make_test_scene, 200, 120, 16),
}


def _inputs(case):
    build, w, h, tri_align = CASES[case]
    scene, md = build()
    flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ccols, tri_node = flat.expand_corner_cols()
    return ccols, tri_node, mats, w, h


def _port(ccols, tri_node, mats, w, h, **kw):
    ti, tf = tg.geometry_pipeline_cols(
        torch.from_numpy(ccols), torch.from_numpy(tri_node),
        torch.from_numpy(mats), w, h, **kw)
    assert ti.dtype == torch.int32 and tf.dtype == torch.float32
    return ti.numpy(), tf.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_geometry_cols_bit_exact_vs_numpy(case):
    ccols, tri_node, mats, w, h = _inputs(case)
    ti_ref, tf_ref = g.geometry_pipeline_cols(np, ccols, tri_node, mats, w, h)
    ti, tf = _port(ccols, tri_node, mats, w, h)
    assert (ti[:, g.I_VALID] > 0).any(), "nothing survived setup"
    np.testing.assert_array_equal(ti, ti_ref)
    np.testing.assert_array_equal(tf.view(np.uint32), tf_ref.view(np.uint32))


def test_clipped_case_has_live_fan_rows():
    ccols, tri_node, mats, w, h = _inputs("clipped_soup_384x128")
    ti, _ = _port(ccols, tri_node, mats, w, h)
    n_head = g.head_count(ti.shape[0])
    assert (ti[n_head:, g.I_VALID] > 0).sum() > 0


@pytest.mark.parametrize("case", list(CASES))
def test_geometry_cols_vs_jnp(case):
    ccols, tri_node, mats, w, h = _inputs(case)
    ti_ref, tf_ref = g.geometry_pipeline_cols(
        jnp, jnp.asarray(ccols), jnp.asarray(tri_node), jnp.asarray(mats),
        w, h)
    ti_ref, tf_ref = np.asarray(ti_ref), np.asarray(tf_ref)
    ti, tf = _port(ccols, tri_node, mats, w, h)
    np.testing.assert_array_equal(ti, ti_ref)
    ulp = np.spacing(np.maximum(np.abs(tf), np.abs(tf_ref)).astype(np.float32))
    assert (np.abs(tf - tf_ref) <= 4 * ulp).all()


@pytest.mark.parametrize("clip_cap", [1, 4])
def test_capped_clipper_overflow_matches_numpy(clip_cap):
    """Fewer clip slots than crossing triangles: the same overflow is
    dropped and the same subset is clipped."""
    ccols, tri_node, mats, w, h = _inputs("clipped_soup_384x128")
    ti_ref, tf_ref = g.geometry_pipeline_cols(np, ccols, tri_node, mats, w, h,
                                              clip_cap=clip_cap)
    ti, tf = _port(ccols, tri_node, mats, w, h, clip_cap=clip_cap)
    assert ti.shape[0] == tri_node.shape[0] + g.FAN_SLOTS * clip_cap
    np.testing.assert_array_equal(ti, ti_ref)
    np.testing.assert_array_equal(tf.view(np.uint32), tf_ref.view(np.uint32))


def test_clip_triangles_cols_matches_dense_clipper():
    """The clipper alone, on random corners crossing every plane, against
    the reference's dense Sutherland-Hodgman (``clip_triangles``)."""
    rng = np.random.default_rng(11)
    cap = 64
    sub = rng.uniform(-3.0, 3.0, (3, g.ATTR_FLOATS, cap)).astype(np.float32)
    sub[:, 3] = rng.uniform(-0.5, 2.0, (3, cap)).astype(np.float32)  # w
    ref_fan, ref_valid = g.clip_triangles(np, sub.transpose(2, 0, 1), 160, 90)
    fan, valid = tg.clip_triangles_cols(torch.from_numpy(sub), 160, 90)
    assert 0 < int(valid.sum()) < valid.numel()
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    got = fan.numpy().transpose(2, 0, 1)  # (FAN_SLOTS*cap, corner, channel)
    # Only the valid fan slots carry data the pipeline consumes.
    np.testing.assert_array_equal(got[ref_valid].view(np.uint32),
                                  ref_fan[ref_valid].view(np.uint32))


def test_middle_vertex_clip_matches_indexed_pipeline():
    """Triangles whose second corner is behind the near plane: the port
    keeps the third corner, as the indexed (dense-clipper) pipeline and the
    oracle do.  (The reference's column clipper drops it here, a fault
    recorded in ROADMAP.md Queue 3.)"""
    scene, md = make_triangle_soup(128, seed=5, extent=2.0)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(10, 30):
        v[3 * t + 1, 2] += 15.0
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    w, h = 256, 128
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti_ref, tf_ref = g.geometry_pipeline(
        np, flat.positions, flat.attrs, flat.tri_vidx, mats, flat.vert_node,
        w, h)
    ti, tf = _port(*flat.expand_corner_cols(), mats, w, h)
    n_head = g.head_count(ti.shape[0])
    assert (ti[n_head:, g.I_VALID] > 0).sum() > 0
    np.testing.assert_array_equal(ti, ti_ref)
    np.testing.assert_array_equal(tf.view(np.uint32), tf_ref.view(np.uint32))


@pytest.mark.parametrize("case", list(CASES))
def test_compact_and_bounds_match_numpy(case):
    ccols, tri_node, mats, w, h = _inputs(case)
    ti_np, tf_np = g.geometry_pipeline_cols(np, ccols, tri_node, mats, w, h)
    pad = (-ti_np.shape[0]) % g.RASTER_BLOCK
    ti_np = np.concatenate([ti_np, np.tile(ti_np[-1:], (pad, 1))])
    tf_np = np.concatenate([tf_np, np.tile(tf_np[-1:], (pad, 1))])

    ci_ref, cf_ref = g.compact_triangles(np, ti_np, tf_np)
    ci, cf = tg.compact_triangles(torch.from_numpy(ti_np),
                                  torch.from_numpy(tf_np))
    np.testing.assert_array_equal(ci.numpy(), ci_ref)
    np.testing.assert_array_equal(cf.numpy().view(np.uint32),
                                  cf_ref.view(np.uint32))

    blocks_ref = g.block_bounds(np, ci_ref)
    blocks = tg.block_bounds(ci)
    np.testing.assert_array_equal(blocks.numpy(), blocks_ref)
    pb_ref, sup_ref = g.super_bounds(np, blocks_ref)
    pb, sup = tg.super_bounds(blocks)
    np.testing.assert_array_equal(pb.numpy(), pb_ref)
    np.testing.assert_array_equal(sup.numpy(), sup_ref)


def test_block_bounds_rejects_unpadded_rows():
    with pytest.raises(ValueError):
        tg.block_bounds(torch.zeros((100, g.NI32), dtype=torch.int32))


def _overflowing_soup():
    """1400 triangles, 1200 of them with one corner pushed through the near
    plane: past clip_cap_for(1400) = 1024 crossing triangles."""
    scene, md = make_triangle_soup(1400, seed=5, extent=2.0)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(1200):
        v[3 * t, 2] += 15.0
    return scene, md


@pytest.mark.parametrize("clip_cap", ["auto", 64, 5000])
def test_clip_overflow_count_matches_reference(clip_cap):
    """The capped clipper's drop count, max(n_crossing - cap, 0), equals the
    reference's column-mode clip_overflow_count and the cumsum the
    pipeline selects its subset with."""
    scene, md = _overflowing_soup()
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    w, h = 256, 128
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ccols, tri_node = flat.expand_corner_cols()
    ref = int(g.clip_overflow_count(np, ccols, None, None, mats, tri_node, w,
                                    h, clip_cap=clip_cap))
    ours = tg.clip_overflow_count(torch.from_numpy(ccols),
                                  torch.from_numpy(tri_node),
                                  torch.from_numpy(mats), w, h,
                                  clip_cap=clip_cap)
    assert ours.dtype == torch.int32 and int(ours) == ref
    assert tg.clip_cap_for(ccols.shape[1]) == 1024
    if clip_cap == "auto":
        assert ref > 0
    if clip_cap == 5000:
        assert ref == 0


def test_debug_renderer_reports_and_raises_on_clip_drops():
    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import Renderer

    scene, md = _overflowing_soup()
    r = Renderer(RenderConfig(width=256, height=128), device="cpu")
    r.load_scene(scene, md)
    r.render()  # no debug layer: no check, no signal
    assert r.stats.clip_dropped == 0
    dropped = r.clip_overflow(r.camera_matrices())
    assert dropped > 0
    rd = Renderer(RenderConfig(width=256, height=128, debug=True),
                  device="cpu")
    rd.load_scene(scene, md)
    with pytest.raises(RuntimeError, match=f"dropped {dropped} "):
        rd.render()
    assert rd.stats.clip_dropped == dropped
    assert f"clip_dropped={dropped}" in rd.stats.format_line()
    ok = Renderer(RenderConfig(width=256, height=128, debug=True,
                               pipeline="lit"), device="cpu")
    ok.load_scene(*_content_scene())
    ok.render()  # nothing crosses a plane: no drop, no raise
    assert ok.stats.clip_dropped == 0
    assert "clip_dropped" not in ok.stats.format_line()
