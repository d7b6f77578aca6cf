"""K8's plain version (zrenderer_tpu_torch/ops/overlay.py
``rasterize_overlay_plain``) against the reference's Pallas kernel in
interpret mode, ``rasterize_overlay_pallas(..., interpret=True)``, on the
busy draw list of tests/test_overlay_raster.py, a seeded random soup and
the reference's overflow stack, at 128x64 (one tile wide, two tall).

Kept apart from test_torch_overlay.py so that the interpret runs land on
their own test worker.  Contract, as found:

* the count and the overflow are int32-equal, DEFAULT_K + 3 stacked rects
  give count K and overflow 3;
* the layers hold the same draws in the same slots: colours within 1 per
  channel, u and v within 2**-20 (XLA:CPU contracts the interpolation's
  multiply-adds in interpret mode as in its XLA form, docs/RASTER_SPEC.md
  §5; 2**-22 seen);
* interpret mode and the reference's XLA form agree bit for bit, so the
  port's distance to either is the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.ops import overlay_raster as rov
from zrenderer_tpu_torch.app.draw_list import DrawList
from zrenderer_tpu_torch.app.font import UIAtlas
from zrenderer_tpu_torch.ops import overlay as ov

from test_torch_overlay import (
    H,
    W,
    _assert_layers_match_xla,
    busy_draw_list,
    random_verts,
    stacked_draw_list,
)

torch.set_num_threads(1)

T = torch.from_numpy


def _rows(case):
    if case == "busy":
        return busy_draw_list(DrawList, UIAtlas()).setup()
    if case == "stacked":
        return stacked_draw_list(DrawList, UIAtlas()).setup()
    return ov.setup_overlay_triangles(*random_verts(3), W, H)


@pytest.mark.parametrize("case", ["busy", "stacked", "random"])
def test_plain_k8_matches_pallas_interpret(case):
    ti, tf = _rows(case)
    assert len(ti) <= 256
    ref = rov.rasterize_overlay_pallas(jnp.asarray(ti), jnp.asarray(tf), W, H,
                                       interpret=True)
    port = ov.rasterize_overlay(T(ti), T(tf), W, H)
    _assert_layers_match_xla(port, ref)
    xla = rov.rasterize_overlay_xla(jnp.asarray(ti), jnp.asarray(tf), W, H)
    for a, b in zip(ref[:2] + tuple(ref[2]), xla[:2] + tuple(xla[2])):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                      np.asarray(b).view(np.int32))
    if case == "stacked":
        assert int(port[0][20, 20]) == ov.DEFAULT_K
        assert int(port[1][20, 20]) == 3
