"""Plain K10hbm2 (zrenderer_tpu_torch/ops/experiments/raster_hbm2.py)
against the reference's kernel in interpret mode
(zrenderer_tpu/ops/experiments/raster_hbm2.py), every row of the padded
frame: the reference tests' cases (the procedural test scene at 128x32,
the 1536-triangle stress mix at 256x64, the cross-class exact tie at
128x32) and the soup rasterized at 128x64 with geometry at 128x56, whose
rows 56-63 a short row draws only on its 8-row window.

Contract (test_torch_binned_interpret.py's): coverage exact, u8 within 1
LSB, depth within 2e-6, because XLA:CPU contracts the interpret kernels'
f32 chains into FMAs and eager torch does not.

The reference's kernel reads ``_INT_MAX``, ``I32_LANES``, ``F32_LANES``
and ``_tri_unroll``, which its module never imports (ROADMAP Queue 3):
the tests set them on the module from ``raster_pallas`` for their run
only, and one test shows the ``NameError`` without them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hbm2 import pair_setup, stress_setup
from test_torch_raster import _u8
from test_torch_vis_trans import demo_setup, padded_setup
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.ops.experiments import raster_hbm2 as rh2
from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as h2

torch.set_num_threads(1)

T = torch.from_numpy
DEPTH_ATOL = 2e-6
MISSING = ("_INT_MAX", "I32_LANES", "F32_LANES", "_tri_unroll")


@pytest.fixture
def names(monkeypatch):
    """The four names the reference's kernel reads, for this test only."""
    for name in MISSING:
        monkeypatch.setattr(rh2, name, getattr(rp, name), raising=False)


def assert_within_contract(ours, ref):
    (color, depth), (ref_c, ref_d) = ours, ref
    depth = depth.numpy()
    ref_d = np.asarray(ref_d)
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    np.testing.assert_allclose(depth, ref_d, rtol=0, atol=DEPTH_ATOL)
    ref_u8 = _u8(np.asarray(ref_c).view(np.int32)).astype(np.int32)
    assert np.abs(_u8(color.numpy()).astype(np.int32) - ref_u8).max() <= 1
    assert (depth < 1.0).mean() > 0.02


CASES = {"demo_128x32": demo_setup, "stress_256x64": stress_setup,
         "padded_soup_128x64": padded_setup,
         "cross_class_tie_128x32": lambda: pair_setup(0.0, 0.0)[:4]}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case, names):
    ti, tf, w, h = CASES[case]()
    ref = rh2.rasterize_setup_pallas_hbm2(jnp.asarray(ti), jnp.asarray(tf),
                                          w, h, interpret=True)
    ours = h2.rasterize_setup_hbm2(T(ti), T(tf), w, h)
    assert_within_contract(ours, ref)
    if case == "padded_soup_128x64":  # rows 56-63: the short rows' windows
        assert int((np.asarray(ref[1])[56:] < 1.0).sum()) == 246
        assert int((ours[1][56:] < 1.0).sum()) == 246


def test_reference_hbm2_lacks_four_names():
    """Without the run-time patch the reference's K10hbm2 fails
    (tests/test_raster_pallas.py::test_hbm2_two_class_matches_oracle_demo_
    scene): its kernel reads names defined in raster_pallas.py that its
    module does not import."""
    assert not any(hasattr(rh2, name) for name in MISSING)
    ti, tf, w, h = demo_setup()
    with pytest.raises(NameError, match="_INT_MAX"):
        rh2.rasterize_setup_pallas_hbm2(jnp.asarray(ti), jnp.asarray(tf), w,
                                        h, interpret=True)
