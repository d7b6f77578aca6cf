"""The port's scene upload (zrenderer_tpu_torch/engine/upload.py) against
the JAX package's (zrenderer_tpu/engine/upload.py): identical host arrays,
and a lossless carry onto the port's device."""

import os

import numpy as np
import pytest
import torch

from zrenderer_tpu.engine import upload as ref_upload
from zrenderer_tpu.scene.mesh import MeshData
from zrenderer_tpu.scene.procedural import (
    make_material_scene,
    make_test_scene,
    make_triangle_soup,
)
from zrenderer_tpu.scene.scene import Scene
from zrenderer_tpu_torch.engine import upload as port_upload

SCENE_DIR = os.path.join(os.path.dirname(__file__), "..", "content",
                         "scenes", "test_scene")


def _content_scene():
    return (Scene.load(os.path.join(SCENE_DIR, "scene.bin")),
            MeshData.load(os.path.join(SCENE_DIR, "meshes.bin")))


SCENES = {
    "content_test_scene": _content_scene,
    "procedural_test_scene": make_test_scene,
    "soup": lambda: make_triangle_soup(100, seed=1),
    "materials": make_material_scene,
}
FLATTEN_KW = {
    "default": {},
    "unpadded": {"pad": False},
    "small_align": {"vert_align": 32, "tri_align": 64},
    "materials": {"apply_materials": True},
}


@pytest.mark.parametrize("kw", list(FLATTEN_KW))
@pytest.mark.parametrize("scene", list(SCENES))
def test_flatten_scene_matches_reference(scene, kw):
    s, md = SCENES[scene]()
    ref = ref_upload.flatten_scene(s, md, **FLATTEN_KW[kw])
    port = port_upload.flatten_scene(s, md, **FLATTEN_KW[kw])
    for field in ("positions", "attrs", "tri_vidx", "vert_node",
                  "node_to_world", "draw_mesh"):
        a, b = getattr(ref, field), getattr(port, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert port.num_triangles == ref.num_triangles
    assert port.num_vertices == ref.num_vertices
    assert port.draw_count == ref.draw_count
    ref_cc, ref_tn = ref.expand_corner_cols()
    cc, tn = port.expand_corner_cols()
    np.testing.assert_array_equal(cc.view(np.uint32), ref_cc.view(np.uint32))
    np.testing.assert_array_equal(tn, ref_tn)


def _reference_arrays():
    s, md = _content_scene()
    flat = ref_upload.flatten_scene(s, md)
    ccols, tri_node = flat.expand_corner_cols()
    return {
        "positions": flat.positions, "attrs": flat.attrs,
        "tri_vidx": flat.tri_vidx, "vert_node": flat.vert_node,
        "node_to_world": flat.node_to_world,
        "corner_cols": ccols, "tri_node": tri_node,
    }


def test_flat_scene_to_device_round_trips():
    arrays = _reference_arrays()
    out = port_upload.flat_scene_to_device(arrays, torch.device("cpu"))
    assert set(out) == set(port_upload.DEVICE_FIELDS)
    for name, a in arrays.items():
        t = out[name]
        assert t.device.type == "cpu" and t.is_contiguous()
        back = t.numpy()
        assert back.dtype == a.dtype and back.shape == a.shape, name
        np.testing.assert_array_equal(back.view(np.uint32 if a.dtype ==
                                                np.float32 else np.int32),
                                      a.view(np.uint32 if a.dtype ==
                                             np.float32 else np.int32))
        # A copy, not a view of the caller's array.
        assert t.data_ptr() != a.ctypes.data, name


def test_host_arrays_feed_flat_scene_to_device():
    s, md = _content_scene()
    flat = port_upload.flatten_scene(s, md)
    out = port_upload.flat_scene_to_device(flat.host_arrays(), "cpu")
    np.testing.assert_array_equal(out["corner_cols"].numpy(),
                                  flat.expand_corner_cols()[0])


def test_flat_scene_to_device_rejects_bad_input():
    arrays = _reference_arrays()
    with pytest.raises(KeyError):
        port_upload.flat_scene_to_device(
            {k: v for k, v in arrays.items() if k != "tri_node"}, "cpu")
    bad = dict(arrays, positions=arrays["positions"].astype(np.float64))
    with pytest.raises(TypeError):
        port_upload.flat_scene_to_device(bad, "cpu")
