"""The port's host modules against the reference's: the setup-row layout
and size rules, the camera math, the scene loaders and procedural
scenes, PNG I/O and the NumPy oracle.

The port carries its own copies so that it runs where the JAX package
cannot be imported; these tests hold each copy equal to the reference,
bit for bit or byte for byte.
"""

import os

import numpy as np
import pytest
import torch

from zrenderer_tpu.math import zmath as ref_zm
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.raster_ref import raster_cpu as ref_oracle
from zrenderer_tpu.raster_ref import render_scene_cpu as ref_render_scene_cpu
from zrenderer_tpu.scene import mesh as ref_mesh
from zrenderer_tpu.scene import procedural as ref_proc
from zrenderer_tpu.scene import scene as ref_scene
from zrenderer_tpu.utils import png as ref_png
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.math import zmath as zm
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.raster_ref import raster_cpu as oracle
from zrenderer_tpu_torch.scene import mesh as port_mesh
from zrenderer_tpu_torch.scene import procedural as proc
from zrenderer_tpu_torch.scene import scene as port_scene
from zrenderer_tpu_torch.utils import png

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCENE_DIR = os.path.join(ROOT, "content", "scenes", "test_scene")

LAYOUT_CONSTANTS = [
    "SUBPIXEL_BITS", "SUBPIXEL", "GUARD_PX", "MAX_SPAN_PX", "CLIP_MAX_VERTS",
    "FAN_SLOTS", "CLIP_CAP_MIN", "ATTR_FLOATS", "RASTER_BLOCK", "SUPER_BLOCK",
    "I_X0", "I_Y0", "I_X1", "I_Y1", "I_X2", "I_Y2",
    "I_DX0", "I_DY0", "I_DX1", "I_DY1", "I_DX2", "I_DY2",
    "I_BIAS0", "I_BIAS1", "I_BIAS2", "I_JMIN", "I_JMAX", "I_IMIN", "I_IMAX",
    "I_VALID", "NI32",
    "F_ZA0", "F_ZA1", "F_ZA2", "F_RW0", "F_RW1", "F_RW2",
    "F_CR0", "F_CR1", "F_CR2", "F_CG0", "F_CG1", "F_CG2",
    "F_CB0", "F_CB1", "F_CB2", "NF32",
]


@pytest.mark.parametrize("name", LAYOUT_CONSTANTS)
def test_layout_constants_match_reference(name):
    assert getattr(tg, name) == getattr(g, name)


def test_size_rules_match_reference():
    for extent in (64, 96, 144, 720, 1080, 1920, 2160, 3840):
        assert tg.guard_px(extent) == g.guard_px(extent)
    for t in list(range(1, 3000, 7)) + [20000, 65536, 1_000_000]:
        assert tg.clip_cap_for(t) == g.clip_cap_for(t)
        assert tg.capped_rows(t) == g.capped_rows(t)
        assert tg.head_count(g.capped_rows(t)) == t


def _scene_files(mod_scene, mod_mesh):
    return (mod_scene.Scene.load(os.path.join(SCENE_DIR, "scene.bin")),
            mod_mesh.MeshData.load(os.path.join(SCENE_DIR, "meshes.bin")))


CAMERAS = {
    "test_scene_file": lambda m: _scene_files(m[0], m[1])[0].active_camera,
    "lattice": lambda m: m[2].make_stress_scene(3000)[0].active_camera,
    "soup": lambda m: m[2].make_triangle_soup(10)[0].active_camera,
    "procedural_test_scene": lambda m: m[2].make_test_scene()[0].active_camera,
}
PORT_MODS = (port_scene, port_mesh, proc)
REF_MODS = (ref_scene, ref_mesh, ref_proc)


@pytest.mark.parametrize("size", [(256, 64), (256, 144), (1920, 1080)])
@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_view_proj_matches_reference(camera, size):
    ours = tg.view_proj_from_camera(CAMERAS[camera](PORT_MODS), *size)
    ref = g.view_proj_from_camera(CAMERAS[camera](REF_MODS), *size)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_zmath_matches_reference():
    rng = np.random.default_rng(11)
    q0 = rng.uniform(-1, 1, 4).astype(np.float32)
    v = rng.uniform(-5, 5, 3).astype(np.float32)
    a, b = (rng.uniform(-2, 2, (4, 4)).astype(np.float32) for _ in range(2))
    pairs = [
        (zm.mul(a, b), ref_zm.mul(a, b)),
        (zm.look_at_rh(zm.load_vec3(v), zm.load_vec3(q0),
                       zm.f32x4(0, 1, 0, 0)),
         ref_zm.look_at_rh(ref_zm.load_vec3(v), ref_zm.load_vec3(q0),
                           ref_zm.f32x4(0, 1, 0, 0))),
        (zm.perspective_fov_rh(0.7, 1.5, 0.1, 300.0),
         ref_zm.perspective_fov_rh(0.7, 1.5, 0.1, 300.0)),
        (zm.translation(*v), ref_zm.translation(*v)),
        (zm.qmul(q0, q0[::-1]), ref_zm.qmul(q0, q0[::-1])),
        (zm.mat_from_quat(q0), ref_zm.mat_from_quat(q0)),
        (zm.rotate_vec3(q0, v), ref_zm.rotate_vec3(q0, v)),
        (np.float32(zm.quat_to_euler(q0)),
         np.float32(ref_zm.quat_to_euler(q0))),
    ]
    for pitch, yaw, roll in ((0.0, 0.0, 0.0), (0.3, -1.2, 0.0),
                             (-1.5, 2.9, 0.7), (1.55, 0.7, -3.0)):
        pairs.append((zm.quat_from_roll_pitch_yaw(pitch, yaw, roll),
                      ref_zm.quat_from_roll_pitch_yaw(pitch, yaw, roll)))
        axis = (v / np.linalg.norm(v)).astype(np.float32)
        pairs.append((zm.quat_from_norm_axis_angle(axis, yaw),
                      ref_zm.quat_from_norm_axis_angle(axis, yaw)))
    for ours, ref in pairs:
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_shadow_zmath_matches_reference():
    """vec3 and orthographic_rh, which the shadow pass's light frustum
    uses."""
    pairs = [(zm.vec3(0.25, -1.5, 3.0), ref_zm.vec3(0.25, -1.5, 3.0))]
    for w, h, near, far in ((4.4, 4.4, 0.1, 9.0), (13.7, 2.9, 0.1, 28.35),
                            (2.2 * 7.123456, 2.2 * 7.123456, 0.1,
                             4.5 * 7.123456)):
        pairs.append((zm.orthographic_rh(w, h, near, far),
                      ref_zm.orthographic_rh(w, h, near, far)))
    for ours, ref in pairs:
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def test_scene_files_load_like_reference():
    scene, md = _scene_files(port_scene, port_mesh)
    ref, ref_md = _scene_files(ref_scene, ref_mesh)
    assert scene.serialize() == ref.serialize()
    assert md.serialize() == ref_md.serialize()
    assert [n.name for n in scene.nodes] == [n.name for n in ref.nodes]
    np.testing.assert_array_equal(md.vertex_data, ref_md.vertex_data)
    np.testing.assert_array_equal(md.index_data, ref_md.index_data)


PROCEDURAL = {
    "lattice3000": lambda p: p.make_stress_scene(3000, seed=2),
    "soup": lambda p: p.make_triangle_soup(
        60, seed=5, extent=2.0, behind_camera_fraction=0.1),
    "test_scene": lambda p: p.make_test_scene(),
    "sphere_field": lambda p: p.make_sphere_field(8192, seed=3, stacks=32,
                                                  slices=64),
    "sphere_field_ring_major": lambda p: p.make_sphere_field(
        3000, seed=1, stacks=12, slices=20),
    "material_scene": lambda p: p.make_material_scene(),
}


@pytest.mark.parametrize("name", sorted(PROCEDURAL))
def test_procedural_scenes_match_reference(name):
    scene, md = PROCEDURAL[name](proc)
    ref, ref_md = PROCEDURAL[name](ref_proc)
    assert scene.serialize() == ref.serialize()
    assert md.serialize() == ref_md.serialize()


def test_material_scene_materials_match_reference():
    _, md = proc.make_material_scene()
    _, ref_md = ref_proc.make_material_scene()
    assert md.mesh_material == ref_md.mesh_material
    assert [m.pack() for m in md.materials] == [
        m.pack() for m in ref_md.materials]


@pytest.mark.parametrize("name", ["sphere_field", "lattice3000",
                                  "test_scene"])
def test_meshlet_table_matches_reference(name):
    """FlatScene.build_meshlet_table's bounds, draws and enabled flags,
    bit for bit, on the port's and the reference's flattening of the same
    scene (the test scene's two draws share a block: disabled)."""
    from zrenderer_tpu.engine.upload import flatten_scene as ref_flatten

    scene, md = PROCEDURAL[name](proc)
    ref_scene_, ref_md = PROCEDURAL[name](ref_proc)
    out = flatten_scene(scene, md, pad=True, tri_align=128).build_meshlet_table(
        128)
    ref = ref_flatten(ref_scene_, ref_md, pad=True,
                      tri_align=128).build_meshlet_table(128)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert out[0].shape[1] == 8 and out[2].dtype == bool
    with pytest.raises(ValueError, match="multiple of 96"):
        flatten_scene(scene, md, pad=True,
                      tri_align=64).build_meshlet_table(96)


def test_png_matches_reference(tmp_path):
    rgba = np.random.default_rng(4).integers(0, 256, (37, 53, 4), np.uint8)
    assert png.encode_png(rgba) == ref_png.encode_png(rgba)
    png.write_png(str(tmp_path / "a.png"), rgba)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "a.png")), rgba)
    np.testing.assert_array_equal(
        ref_png.read_png(str(tmp_path / "a.png")), rgba)


def test_oracle_loop_matches_reference():
    """Same setup rows (a soup with clipped fans) through both loops."""
    scene, md = proc.make_triangle_soup(
        40, seed=9, extent=2.0, behind_camera_fraction=0.1)
    w, h = 96, 64
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    ccols, tri_node = flat.expand_corner_cols()
    vp = tg.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = tg.geometry_pipeline_cols(
        torch.from_numpy(ccols), torch.from_numpy(tri_node),
        torch.from_numpy(mats), w, h)
    ti, tf = ti.numpy(), tf.numpy()
    assert (ti[:, tg.I_VALID] > 0).sum() > 0
    rgba, depth = oracle.rasterize_setup(ti, tf, w, h)
    ref_rgba, ref_depth = ref_oracle.rasterize_setup(ti, tf, w, h)
    np.testing.assert_array_equal(rgba.view(np.int32), ref_rgba.view(np.int32))
    np.testing.assert_array_equal(depth.view(np.int32),
                                  ref_depth.view(np.int32))
    np.testing.assert_array_equal(oracle.pack_u8(rgba),
                                  ref_oracle.pack_u8(ref_rgba))


def test_oracle_render_matches_reference():
    """bench.py's parity frame: the port's oracle render (column geometry
    on CPU tensors) equals the reference's (NumPy indexed geometry)."""
    w, h = 256, 144
    img, depth = oracle.render_scene_cpu(*_scene_files(port_scene, port_mesh),
                                         w, h)
    ref_img, ref_depth = ref_render_scene_cpu(
        *_scene_files(ref_scene, ref_mesh), w, h)
    assert (depth < 1.0).mean() > 0.05
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(depth.view(np.int32),
                                  ref_depth.view(np.int32))
