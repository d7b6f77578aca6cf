"""Plain K10g8, K10g8g and K10g8d (zrenderer_tpu_torch/ops/experiments/
raster_group8.py) against the reference's group8 kernels in interpret mode
(zrenderer_tpu/ops/experiments/raster_group8.py), at the reference tests'
own sizes: the 150-triangle blow-up soup at 256x64 with chunk=16 (both
phases draw; also under a 32-row list budget), and 128x32 soups with
pair_cap=2 for the G-buffer and the depth plane.

Kept apart from test_torch_group8.py so the two files' runs land on
different test workers; each interpret run happens once (lru_cache).
Contract (docs/RASTER_SPEC.md §5, as test_torch_binned_interpret.py):
coverage exact, u8 within 1 LSB, depth within 2e-6; the planes that are
in fact bit-equal are asserted bit-equal.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_group8 import _bits, edge_soup_256x64, soup_setup
from test_torch_raster import _u8
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops.experiments import raster_group8 as rg8
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_group8 as g8

torch.set_num_threads(1)

T = torch.from_numpy

# name -> (setup, mode, keyword arguments of both sides)
CASES = {
    "flat_blow_up": (lambda: soup_setup(256, 64, 150, 3, blow_up=True),
                     "flat", dict(chunk=16)),
    "flat_tiny_budget": (lambda: soup_setup(256, 64, 150, 3, blow_up=True),
                         "flat", dict(chunk=16, list_budget=32)),
    "gbuffer": (lambda: soup_setup(128, 32, 60, 7, materials=True),
                "gbuffer", dict(chunk=16, pair_cap=2)),
    "depth": (lambda: soup_setup(128, 32, 40, 9), "depth",
              dict(chunk=16, pair_cap=2)),
}
REF = {"flat": rg8.rasterize_setup_pallas_group8,
       "gbuffer": rg8.rasterize_gbuffer_pallas_group8,
       "depth": rg8.rasterize_depth_pallas_group8}
OURS = {"flat": g8.rasterize_setup_group8,
        "gbuffer": g8.rasterize_gbuffer_group8,
        "depth": g8.rasterize_depth_group8}


@lru_cache(maxsize=None)
def _run(name):
    build, mode, kw = CASES[name]
    ti, tf, w, h = build()
    ref = REF[mode](jnp.asarray(ti), jnp.asarray(tf), w, h, interpret=True,
                    **kw)
    ours = OURS[mode](T(ti), T(tf), w, h, **kw)
    if mode == "depth":
        ref, ours = [ref], [ours]
    return ([np.asarray(x) for x in ref], [x.numpy() for x in ours],
            g8.prepare_group8_inputs(T(ti), T(tf), w, h, **kw))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_group8_matches_pallas_interpret(name):
    ref, ours, inp = _run(name)
    mode = CASES[name][1]
    assert int(inp.offs[-1]) > 0
    if mode == "flat":  # the blow-up soup leaves live rows to phase 2
        hier = inp.hier
        assert ((hier[:, g.I_VALID] > 0)
                & (hier[:, g.I_JMIN] <= hier[:, g.I_JMAX])).sum() > 10
    depth, ref_d = (ours[0], ref[0]) if mode == "depth" else (ours[1], ref[1])
    assert (depth < 1.0).mean() > 0.01
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    np.testing.assert_allclose(depth, ref_d, rtol=0, atol=2e-6)
    if mode == "depth":
        return
    assert np.abs(_u8(ours[0]).astype(np.int32)
                  - _u8(ref[0].view(np.int32)).astype(np.int32)).max() <= 1
    # In fact bit-equal: the colour, and the G-buffer's interpolants and
    # constants (only the depth chain is contracted by XLA:CPU here).
    _bits(ours[0], ref[0])
    for a, b in zip(ours[2:], ref[2:]):
        _bits(a, b)


def test_reference_frame_breaks_past_its_list_budget():
    """With the budget overrun of test_torch_group8.py (167 pairs for 160
    rows), the reference's spans reach the zero rows past its lists: an
    all-zero row covers every pixel of its tile at z = 0, so a whole 8x128
    tile reads depth 0.  The port's frame is K5's."""
    ti, tf, w, h = edge_soup_256x64()
    kw = dict(list_budget=160, chunk=16)
    _, ref_d = rg8.rasterize_setup_pallas_group8(
        jnp.asarray(ti), jnp.asarray(tf), w, h, interpret=True, **kw)
    k5 = tr.raster_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)
    ref_d = np.asarray(ref_d)
    assert (ref_d == 0.0).sum() == g8.GT_H * g8.GT_W
    assert (ref_d != k5[1].numpy()).sum() > g8.GT_H * g8.GT_W
    color, depth = g8.rasterize_setup_group8(T(ti), T(tf), w, h, **kw)
    _bits(color, k5[0])
    _bits(depth, k5[1])
