"""Plain K4 and K4c (zrenderer_tpu_torch/ops/raster.py) against the
reference's record-streaming kernel in interpret mode
(``rasterize_setup_pallas_binned_hbm``), given shared setup rows.

Kept apart from test_torch_binned.py so the two files' interpret runs
land on different test workers.  Contract (docs/RASTER_SPEC.md §5):
coverage exact, u8 within 1 LSB, depth within 2e-6 (XLA:CPU contracts
the interpret kernels' f32 chains; eager torch does not).  The budgets
make phase 1 (records), phase 1.5 (coarse bins) and phase 2 (leftover
hierarchy) all draw pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_binned import HBM_KW
from test_torch_raster import _setup, _u8
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu_torch.ops import raster as tr

CASES = {
    "records_and_leftovers": ("clipped_soup_384x128", HBM_KW["budget"]),
    "coarse_class": ("clipped_soup_384x128", HBM_KW["coarse"]),
    "auto_cap_ties": ("tie_soup_256x128", HBM_KW["auto"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_k4_matches_pallas_interpret(name):
    case, kw = CASES[name]
    ti, tf, w, h = _setup(case)
    color, depth = tr.rasterize_setup_binned_hbm(
        torch.from_numpy(ti), torch.from_numpy(tf), w, h, **kw)
    color, depth = color.numpy(), depth.numpy()
    ref_c, ref_d = rp.rasterize_setup_pallas_binned_hbm(
        jnp.asarray(ti), jnp.asarray(tf), w, h, interpret=True, **kw)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)
    assert (depth < 1.0).mean() > 0.02
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    np.testing.assert_allclose(depth, ref_d, rtol=0, atol=2e-6)
    assert np.abs(_u8(color).astype(np.int32)
                  - _u8(ref_c.view(np.int32)).astype(np.int32)).max() <= 1
