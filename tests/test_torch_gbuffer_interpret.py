"""Plain K2g, K3g, K4g and K5g (zrenderer_tpu_torch/ops/raster.py) against
the reference's Pallas G-buffer kernels in interpret mode, given shared
setup rows with random per-triangle materials, and the port's
``render_gbuffer`` against ``render_gbuffer_pallas`` (geometry, dispatch
and crop).

Kept apart from test_torch_gbuffer.py so that the interpret runs land on
their own test worker.  Contract (docs/RASTER_SPEC.md §5): coverage and
the six constant planes exact, u8 within 1 LSB, depth within 2e-6, u/v and
normals within rtol 1e-5, atol 1e-6 (XLA:CPU contracts the interpret
kernels' f32 chains; eager torch rounds op by op).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gbuffer import (
    assert_gbuffer_close,
    lit_inputs,
    lit_setup,
    plain_gbuffer,
)
from test_torch_raster import _u8
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu_torch.ops import raster as tr

PALLAS = {"k2g": rp.rasterize_gbuffer_pallas_small,
          "k3g": rp.rasterize_gbuffer_pallas,
          "k4g": rp.rasterize_gbuffer_pallas_binned_hbm,
          "k5g": rp.rasterize_gbuffer_pallas_hbm}


@pytest.mark.parametrize("kind", list(PALLAS))
def test_plain_gbuffer_matches_pallas_interpret(kind):
    ti, tf, w, h = lit_setup("clipped_soup_384x128", seed=4)
    ours = plain_gbuffer(kind, ti, tf, w, h)
    ref = PALLAS[kind](jnp.asarray(ti), jnp.asarray(tf), w, h,
                       interpret=True)
    ref_u8 = _u8(np.asarray(ref[0]).view(np.int32))
    assert_gbuffer_close(ours, ref_u8, ref[1:])


def test_render_gbuffer_matches_render_gbuffer_pallas():
    """The test scene at 256x60 on a 256x64 target: column geometry with
    normals and a per-draw table, the K2g dispatch and the crop."""
    ccols, tri_node, mats, nm, table, w, _ = lit_inputs("test_scene_256x64",
                                                        per_draw=True)
    h, pad_h = 60, 64
    t = torch.from_numpy
    ours = tr.render_gbuffer(t(ccols), t(tri_node), t(mats), t(nm),
                             t(table), w, h, pad_h, w)
    assert all(tuple(p.shape) == (h, w) for p in ours)
    ref = rp.render_gbuffer_pallas(
        jnp.asarray(ccols), None, None, jnp.asarray(mats),
        jnp.asarray(tri_node), jnp.asarray(nm), w, h, pad_h, w,
        interpret=True, material_table=jnp.asarray(table))
    ref_u8 = _u8(np.asarray(ref[0]).view(np.int32))
    assert_gbuffer_close([p.numpy() for p in ours], ref_u8, ref[1:])
