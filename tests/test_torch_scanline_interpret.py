"""Plain K10scan (zrenderer_tpu_torch/ops/experiments/raster_scanline.py)
against the reference's kernel in interpret mode
(zrenderer_tpu/ops/experiments/raster_scanline.py), every row of the
padded frame: the reference tests' cases (the procedural test scene at
128x32, the 1536-triangle stress mix at 256x64, the same-row run and the
cross-class exact ties at 128x32), the soup rasterized at 128x64 with
geometry at 128x56 (rows 56-63 drawn only inside the short rows' bboxes)
and a short row whose z is -0.0, which the reference's one-hot sum stores
as +0.0.

Contract (test_torch_binned_interpret.py's): coverage exact, u8 within 1
LSB, depth within 2e-6 (XLA:CPU contracts the interpret kernel's f32
chains into FMAs; eager torch does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_hbm2 import pair_setup, stress_setup
from test_torch_hbm2_interpret import assert_within_contract
from test_torch_scanline import same_row_setup
from test_torch_vis_trans import demo_setup, padded_setup
from zrenderer_tpu.ops.experiments import raster_scanline as rs
from zrenderer_tpu_torch.ops.experiments import raster_scanline as sc

torch.set_num_threads(1)

T = torch.from_numpy

CASES = {"demo_128x32": demo_setup, "stress_256x64": stress_setup,
         "padded_soup_128x64": padded_setup,
         "same_row_tie_128x32": same_row_setup,
         "cross_class_tie_128x32": lambda: pair_setup(0.0, 0.0)[:4],
         "negative_zero_128x32": lambda: pair_setup(
             za_b=(-0.0, -0.0, -0.0))[:4]}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(case):
    ti, tf, w, h = CASES[case]()
    ref = rs.rasterize_setup_pallas_scanline(jnp.asarray(ti),
                                             jnp.asarray(tf), w, h,
                                             interpret=True)
    ours = sc.rasterize_setup_scanline(T(ti), T(tf), w, h)
    assert_within_contract(ours, ref)
    ref_d = np.asarray(ref[1])
    if case == "padded_soup_128x64":  # rows 56-63: inside the short bboxes
        assert int((ref_d[56:] < 1.0).sum()) == 36
        assert int((ours[1][56:] < 1.0).sum()) == 36
    if case == "negative_zero_128x32":  # the short winners' z: +0.0
        zero = ref_d == 0.0
        assert zero.sum() > 10 and not np.signbit(ref_d[zero]).any()
        assert not torch.signbit(ours[1]).any()
