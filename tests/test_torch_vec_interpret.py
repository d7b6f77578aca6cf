"""Plain K10vec and K10vecg (zrenderer_tpu_torch/ops/experiments/
raster_vec.py) against the reference's lane-parallel kernels in interpret
mode (zrenderer_tpu/ops/experiments/raster_vec.py), at the reference
tests' own sizes: the procedural test scene at 128x32 (flat and G-buffer)
and the 500-triangle soup with clipped fan rows and exact ties at 256x64.

Kept apart from test_torch_vec.py so the two files' runs land on
different test workers.  Contract (docs/RASTER_SPEC.md §5, as
test_torch_binned_interpret.py): coverage exact, u8 within 1 LSB, depth
within 2e-6, the G-buffer's uv and normals within rtol 1e-5, atol 1e-6
(test_torch_gbuffer.py's contract); the colour and the constant planes
are in fact bit-equal and asserted so.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_group8 import _bits
from test_torch_raster import _u8
from test_torch_vec import twin_soup_setup
from zrenderer_tpu.engine.upload import flatten_scene
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops.experiments import raster_vec as rrv
from zrenderer_tpu.scene.procedural import make_test_scene
from zrenderer_tpu_torch.ops.experiments import raster_vec as rv

torch.set_num_threads(1)

T = torch.from_numpy


def demo_setup(w=128, h=32):
    """tests/test_raster_vec.py ``_demo``: the procedural test scene."""
    scene, md = make_test_scene()
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline(np, flat.positions, flat.attrs,
                                 flat.tri_vidx, mats, flat.vert_node, w, h)
    return ti, tf, w, h


CASES = {  # name -> (setup, G-buffer)
    "flat_demo_128x32": (demo_setup, False),
    "flat_twin_soup_256x64": (twin_soup_setup, False),
    "gbuffer_demo_128x32": (demo_setup, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_vec_matches_pallas_interpret(name):
    build, gbuffer = CASES[name]
    ti, tf, w, h = build()
    fn = (rrv.rasterize_gbuffer_pallas_vec if gbuffer
          else rrv.rasterize_setup_pallas_vec)
    ref = [np.asarray(x) for x in fn(jnp.asarray(ti), jnp.asarray(tf), w, h,
                                     interpret=True)]
    ours = [x.numpy() for x in (rv.rasterize_gbuffer_vec if gbuffer
                                else rv.rasterize_setup_vec)(
        T(ti), T(tf), w, h)]
    assert len(ours) == len(ref) == (13 if gbuffer else 2)
    depth, ref_d = ours[1], ref[1]
    assert (depth < 1.0).mean() > 0.03
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    np.testing.assert_allclose(depth, ref_d, rtol=0, atol=2e-6)
    assert np.abs(_u8(ours[0]).astype(np.int32)
                  - _u8(ref[0].view(np.int32)).astype(np.int32)).max() <= 1
    _bits(ours[0], ref[0])
    for a, b in zip(ours[2:7], ref[2:7]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for a, b in zip(ours[7:], ref[7:]):
        _bits(a, b)
