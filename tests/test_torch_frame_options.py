"""The flat path's frame options in the port (zrenderer_tpu_torch:
ops/raster.py's ``ssaa_resolve``, ``cull_meshlets`` and the indexed flat
entry, ops/geometry.py's ``meshlet_keep_mask``, the Renderer's
``supersample`` and ``meshlet_cull``) against the JAX package on the CPU.

Contract:

* the SSAA resolve, the meshlet keep mask and the killed rows are
  bit-exact against the reference's functions on the same inputs (NumPy
  for the keep mask, its ``meshlet_keep_mask(np, ...)``);
* whole frames against the JAX Renderer with Pallas kernels in interpret
  mode: coverage exact, depth within 2e-6, u8 within 1 LSB
  (docs/RASTER_SPEC.md §5);
* a culled frame against the unculled one: at most max(2, pixels // 1000)
  pixels differ (tests/test_meshlet_cull.py's bound: the cone test is
  conservative for float geometry, not for the snapped winding).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.engine.config import RenderConfig as JaxConfig
from zrenderer_tpu.engine.renderer import Renderer as JaxRenderer
from zrenderer_tpu.ops import geometry as jg
from zrenderer_tpu.ops import raster_pallas, raster_xla
from zrenderer_tpu.scene.procedural import make_sphere_field as jax_spheres
from zrenderer_tpu.scene.procedural import make_test_scene as jax_test_scene
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer, rgba_digest
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster
from zrenderer_tpu_torch.scene.procedural import (
    make_sphere_field,
    make_test_scene,
)
from zrenderer_tpu_torch.scene.scene import Camera

torch.set_num_threads(1)

W, H = 96, 64
SPHERES = dict(num_triangles=8192, stacks=32, slices=64)  # 2 spheres


def _assert_frames_close(img, depth, ref_img, ref_depth):
    assert img.shape == ref_img.shape and img.dtype == np.uint8
    assert (depth < 1.0).mean() > 0.02
    np.testing.assert_array_equal(depth < 1.0, ref_depth < 1.0)
    np.testing.assert_allclose(depth, ref_depth, rtol=0, atol=2e-6)
    assert np.abs(img.astype(np.int32) - ref_img.astype(np.int32)).max() <= 1


def _jax_renderer(scene_md, **kw):
    """The JAX Renderer on Pallas in interpret mode; an identity vertex
    shader routes it through the indexed geometry stage, whose rows are
    the column stage's (tests/test_torch_renderer.py)."""
    r = JaxRenderer(JaxConfig(width=W, height=H, backend="pallas",
                              debug=True, **kw))
    r.load_scene(*scene_md)
    r.set_vertex_shader(lambda p, a: (p, a), name="identity")
    return r


def _port(scene_md, **kw):
    r = Renderer(RenderConfig(width=W, height=H, **kw), device="cpu")
    r.load_scene(*scene_md)
    return r


# -- SSAA ---------------------------------------------------------------------


@pytest.mark.parametrize("s", [2, 3, 4])
def test_ssaa_resolve_matches_reference(s):
    rng = np.random.default_rng(s)
    color = rng.integers(0, 256, (H * s, W * s, 4), dtype=np.uint8)
    depth = rng.random((H * s, W * s), dtype=np.float32)
    depth[rng.random(depth.shape) < 0.3] = 1.0
    out, d = raster.ssaa_resolve(torch.from_numpy(color),
                                 torch.from_numpy(depth), s)
    ref, ref_d = raster_xla.ssaa_resolve(jnp.asarray(color),
                                         jnp.asarray(depth), s)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (H, W, 4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(d.numpy().view(np.int32),
                                  np.asarray(ref_d).view(np.int32))


def test_ssaa_flat_frame_matches_jax():
    img, depth = _port(make_test_scene(), tri_align=64,
                       supersample=2).render_and_read()
    ref_img, ref_depth = _jax_renderer(jax_test_scene(), tri_align=64,
                                       supersample=2).render_and_read()
    _assert_frames_close(img, depth, np.asarray(ref_img),
                         np.asarray(ref_depth))


def test_ssaa_frame_is_the_resolve_of_the_large_frame():
    """supersample=2 equals the resolve of the 2x frame a supersample=1
    Renderer renders, bit for bit; render_animation digests each resolved
    frame."""
    r = _port(make_test_scene(), tri_align=64, supersample=2)
    img, depth = r.render_and_read()
    big = Renderer(RenderConfig(width=2 * W, height=2 * H, tri_align=64),
                   device="cpu")
    big.load_scene(*make_test_scene())
    big_img, big_depth = big.render_and_read()
    want, want_depth = raster.ssaa_resolve(torch.from_numpy(big_img),
                                           torch.from_numpy(big_depth), 2)
    np.testing.assert_array_equal(img, want.numpy())
    np.testing.assert_array_equal(depth, want_depth.numpy())
    cam = r.scene.active_camera
    moved = Camera(position=cam.position + np.float32([0.5, 0.2, -0.4]),
                   forward=cam.forward, yfov=cam.yfov, znear=cam.znear,
                   zfar=cam.zfar)
    digests, (last, _) = r.render_animation(cameras=[cam, moved])
    assert digests[0].item() == rgba_digest(torch.from_numpy(img)).item()
    assert digests[1].item() == rgba_digest(last).item()
    assert digests[0] != digests[1]


def test_ssaa_is_the_flat_pipelines_only():
    assert RenderConfig(supersample=2).supersample == 2
    for pipeline in ("lit", "shadowed", "deferred"):
        with pytest.raises(NotImplementedError, match="supersample"):
            RenderConfig(pipeline=pipeline, supersample=2)
    for bad in (0, -1, 1.5):
        with pytest.raises(ValueError, match="supersample"):
            RenderConfig(supersample=bad)
    with pytest.raises(ValueError, match="extent"):
        RenderConfig(width=1920, height=1080, supersample=3)


# -- meshlet culling ----------------------------------------------------------


def _orbit_cameras(scene):
    """The field's camera and two orbit positions around it."""
    base = scene.active_camera
    d = float(np.linalg.norm(base.position))
    cams = [base]
    for ang in (0.7, 2.4):
        eye = np.array([d * math.cos(ang), d * 0.4, d * math.sin(ang)],
                       np.float32)
        cams.append(Camera(position=eye, forward=-eye / np.linalg.norm(eye),
                           yfov=0.9, znear=0.5, zfar=base.zfar))
    return cams


def _cull_renderer():
    return _port(make_sphere_field(**SPHERES), tri_align=128,
                 meshlet_cull=True)


@pytest.mark.parametrize("cam_index", [0, 1, 2])
def test_meshlet_keep_mask_matches_reference(cam_index):
    r = _cull_renderer()
    cam = _orbit_cameras(r.scene)[cam_index]
    # Draws moved too: two transform sets, one the identity.
    for transforms in (None, [r.flat.node_to_world[0] @ np.float32(
            [[0.9, 0.1, 0, 0], [-0.1, 0.9, 0, 0], [0, 0, 1.1, 0],
             [0.3, -0.2, 0.4, 1]])]):
        mats = r.camera_matrices(cam, transforms)
        cam_local = r.cam_local_constants(cam, transforms)
        bounds, mdraw, enabled = (t.numpy() for t in r._meshlet_table)
        keep = tg.meshlet_keep_mask(
            *(torch.from_numpy(x) for x in (bounds, mdraw, enabled, mats,
                                            cam_local)))
        ref = jg.meshlet_keep_mask(np, bounds, mdraw, enabled, mats,
                                   cam_local)
        np.testing.assert_array_equal(keep.numpy(), ref)
        assert 0 < ref.sum() < len(ref)  # some kept, some culled


def test_cam_local_constants_match_reference():
    scene_md = make_sphere_field(**SPHERES)
    r = _port(scene_md, tri_align=128)
    ref = JaxRenderer(JaxConfig(width=W, height=H, backend="pallas",
                                tri_align=128))
    ref.load_scene(*jax_spheres(**SPHERES))
    for cam in _orbit_cameras(r.scene):
        np.testing.assert_array_equal(r.cam_local_constants(cam),
                                      ref.cam_local_constants(cam))


def test_killed_rows_match_jax():
    """cull_meshlets kills the head rows of the culled meshlets, as the
    reference's ``_kill_rows`` does with the same mask; the fan rows
    stay."""
    r = _cull_renderer()
    cam = _orbit_cameras(r.scene)[1]
    b = r._buffers()
    mats = torch.from_numpy(r.camera_matrices(cam))
    cam_local = torch.from_numpy(r.cam_local_constants(cam))
    ti, _ = tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"], mats,
                                      W, H)
    killed = raster.cull_meshlets(ti, mats, (*r._meshlet_table, cam_local))
    keep = tg.meshlet_keep_mask(*r._meshlet_table, mats, cam_local).numpy()
    kill = np.concatenate([np.repeat(~keep, tg.RASTER_BLOCK),
                           np.zeros(ti.shape[0] - keep.size * 128, bool)])
    ref = raster_pallas._kill_rows(jnp, jnp.asarray(ti.numpy()),
                                   jnp.asarray(kill))
    np.testing.assert_array_equal(killed.numpy(), np.asarray(ref))
    assert kill.any() and (killed[~torch.from_numpy(kill)] ==
                           ti[~torch.from_numpy(kill)]).all()
    assert (killed[torch.from_numpy(kill), tg.I_VALID] == 0).all()
    with pytest.raises(ValueError, match="head rows"):
        raster.cull_meshlets(ti[:-128 * 7], mats,
                             (*r._meshlet_table, cam_local))


def test_meshlet_cull_frame_is_bounded_and_engaged():
    scene_md = make_sphere_field(**SPHERES)
    off = _port(scene_md, tri_align=128)
    on = _port(scene_md, tri_align=128, meshlet_cull=True)
    npx = W * H
    for cam in _orbit_cameras(off.scene):
        img_off, depth_off = off.render_and_read(camera=cam)
        img_on, depth_on = on.render_and_read(camera=cam)
        assert (depth_off < 1).mean() > 0.02
        d_diff = int((depth_on != depth_off).sum())
        c_diff = int((img_on != img_off).any(-1).sum())
        assert d_diff <= max(2, npx // 1000), d_diff
        assert c_diff <= max(2, npx // 1000), c_diff
        keep = tg.meshlet_keep_mask(
            *on._meshlet_table, torch.from_numpy(on.camera_matrices(cam)),
            torch.from_numpy(on.cam_local_constants(cam)))
        assert not keep.all()
    cams = _orbit_cameras(off.scene)[:2]
    d_off, _ = off.render_animation(cameras=cams)
    d_on, _ = on.render_animation(cameras=cams)
    # Frame sums of u32 packed pixels: the few sliver pixels bound them.
    assert torch.all((d_off - d_on).abs() <= 4 * 2**32)


def test_meshlet_cull_frame_matches_jax():
    """The culled frame against the JAX Renderer's culled frame (Pallas,
    interpret mode), which kills the same rows before its dispatch."""
    img, depth = _cull_renderer().render_and_read()
    ref = _jax_renderer(jax_spheres(**SPHERES), tri_align=128,
                        meshlet_cull=True)
    ref_img, ref_depth = ref.render_and_read()
    _assert_frames_close(img, depth, np.asarray(ref_img),
                         np.asarray(ref_depth))


def test_meshlet_cull_needs_whole_meshlets_and_the_flat_pipeline():
    with pytest.raises(NotImplementedError, match="meshlet_cull"):
        RenderConfig(pipeline="lit", meshlet_cull=True)
    r = Renderer(RenderConfig(width=W, height=H, tri_align=64,
                              meshlet_cull=True), device="cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        r.load_scene(*make_test_scene())


def test_indexed_entry_equals_the_column_entry():
    """render_frame_indexed without a shader gives render_frame's planes,
    cull and raw planes included."""
    r = _cull_renderer()
    b = r._buffers()
    mats = torch.from_numpy(r.camera_matrices())
    cull = (*r._meshlet_table,
            torch.from_numpy(r.cam_local_constants()))
    target = (W, H, r.config.pad_height, r.config.pad_width)
    for kw in (dict(), dict(meshlet_cull=cull, raw_packed=True)):
        a = raster.render_frame(b["corner_cols"], b["tri_node"], mats,
                                *target, **kw)
        c = raster.render_frame_indexed(b["positions"], b["attrs"],
                                        b["tri_vidx"], b["vert_node"], mats,
                                        *target, **kw)
        for x, y in zip(a, c):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
