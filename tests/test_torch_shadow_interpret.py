"""Plain K2d, K3d, K4d, K6d and K6g (zrenderer_tpu_torch/ops/raster.py)
against the reference's Pallas kernels in interpret mode on shared setup
rows, and the port's ``render_depth`` against ``render_depth_pallas``
(geometry and the depth dispatch) for every binning at a 128x128 map.

Kept apart from test_torch_shadow.py so that the interpret runs land on
their own test worker.  Contract (docs/RASTER_SPEC.md §5): coverage exact
and depth within 2e-6 (XLA:CPU contracts the interpret kernels' f32
chains; eager torch rounds op by op); K6g under the G-buffer contract of
test_torch_gbuffer_interpret.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gbuffer import assert_gbuffer_close, lit_setup, plain_gbuffer
from test_torch_raster import _setup, _u8
from test_torch_shadow import plain_depth
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.scene.procedural import make_triangle_soup
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import raster as tr

PALLAS = {"k2d": rp.rasterize_depth_pallas_small,
          "k3d": rp.rasterize_depth_pallas,
          "k4d": rp.rasterize_depth_pallas_binned_hbm,
          "k6d": rp.rasterize_depth_pallas_binned}


def assert_depth_close(depth, ref):
    ref = np.asarray(ref)
    assert (depth < 1.0).mean() > 0.1
    np.testing.assert_array_equal(depth < 1.0, ref < 1.0)
    np.testing.assert_allclose(depth, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("kind", list(PALLAS))
def test_plain_depth_matches_pallas_interpret(kind):
    ti, tf, w, h = _setup("clipped_soup_384x128")
    ref = PALLAS[kind](jnp.asarray(ti), jnp.asarray(tf), w, h, interpret=True)
    assert_depth_close(plain_depth(kind, ti, tf, w, h), ref)


def test_plain_k6g_matches_pallas_interpret():
    ti, tf, w, h = lit_setup("clipped_soup_384x128", seed=6)
    ours = plain_gbuffer("k6g", ti, tf, w, h)
    ref = rp.rasterize_gbuffer_pallas_binned(jnp.asarray(ti), jnp.asarray(tf),
                                             w, h, interpret=True)
    assert_gbuffer_close(ours, _u8(np.asarray(ref[0]).view(np.int32)),
                         ref[1:])


@pytest.mark.parametrize("binning", list(tr.BINNINGS))
def test_render_depth_matches_render_depth_pallas(binning):
    """A clipped soup seen from its camera into a 128x128 map: column
    geometry at the map's viewport, then K2d (auto, small), K3d
    (hierarchy) or K6d (tile_lists)."""
    size = 128
    scene, md = make_triangle_soup(200, seed=4, extent=2.0,
                                   behind_camera_fraction=0.1)
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, size, size)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ccols, tri_node = flat.expand_corner_cols()
    t = torch.from_numpy
    ours = tr.render_depth(t(ccols), t(tri_node), t(mats), size,
                           binning=binning)
    assert tuple(ours.shape) == (size, size)
    ref = rp.render_depth_pallas(jnp.asarray(ccols), None, None,
                                 jnp.asarray(mats), jnp.asarray(tri_node),
                                 size, size, interpret=True, binning=binning)
    assert_depth_close(ours.numpy(), ref)
