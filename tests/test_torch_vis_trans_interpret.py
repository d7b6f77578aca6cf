"""Plain K10vis and K10trans (zrenderer_tpu_torch/ops/experiments/
raster_vis_trans.py) against the reference's kernels in interpret mode
(zrenderer_tpu/ops/experiments/raster_vis_trans.py), every row of the
padded frame: the reference tests' own cases (the procedural test scene
at 128x32 for K10vis, the 500-triangle soup with exact ties at 256x64 for
K10trans) and the soup rasterized at 128x64 with geometry at 128x56, whose
rows 56-63 each kernel draws by its own extent.

The reference's entry points return no id plane, so each case calls the
reference's kernel with the arguments its entry point builds
(``rasterize_setup_pallas_vis`` :401-433, ``rasterize_setup_pallas_trans``
:663-691) and resolves the colour with the reference's
``resolve_flat_vis``.  The id plane and the colour are bit-equal; depth
coverage is exact and the depth within 2 ulp (XLA:CPU contracts the
interpret kernels' z chains into FMAs, as in test_torch_raster.py).

The reference's K10vis reads ``I32_LANES`` and ``F32_LANES``, which its
module never imports (ROADMAP Queue 3): the tests set them on the module
for their run only, and one test shows the ``NameError`` without them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from test_torch_vis_trans import demo_setup, padded_setup, rows_at
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.ops.experiments import raster_vis_trans as rvt
from zrenderer_tpu.scene.procedural import make_triangle_soup
from zrenderer_tpu_torch.ops.experiments import raster_vis_trans as vt

torch.set_num_threads(1)

T = torch.from_numpy
DEPTH_MAX_ULP = 2


def tie_soup_setup(w=256, h=64):
    """tests/test_raster_pallas.py ``test_trans_group_raster_matches_hbm_
    kernel``: 500 triangles, 10-19 repeating 0-9."""
    scene, md = make_triangle_soup(500, seed=7, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(10, 20):
        v[3 * t:3 * t + 3, 0:3] = v[3 * (t - 10):3 * (t - 10) + 3, 0:3]
    return (*rows_at(scene, md, w, h), w, h)


def _tile_spec():
    return pl.BlockSpec((rp.TILE_H, rp.TILE_W), lambda i, j: (i, j),
                        memory_space=pltpu.VMEM)


def _vis_out(w, h):
    return [jax.ShapeDtypeStruct((h, w), jnp.float32),
            jax.ShapeDtypeStruct((h, w), jnp.int32)]


def reference_vis(ti, tf, w, h):
    """``rasterize_setup_pallas_vis``'s body, interpret mode, with the
    id plane: (color, depth, idx)."""
    supers, _, ti, tf = rp.prepare_raster_inputs(jnp.asarray(ti),
                                                 jnp.asarray(tf),
                                                 compact=True)
    table = rvt._vis_resolve_table(ti, tf)
    bits = rvt.prepare_group_bits(ti, w, h)
    depth, idx = rp._pallas_call(
        rvt._hbm_vis_bits_kernel,
        grid=(h // rp.TILE_H, w // rp.TILE_W),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[_tile_spec(), _tile_spec()],
        out_shape=_vis_out(w, h),
        scratch_shapes=[
            pltpu.VMEM((rp.TILE_H, rp.TILE_W), jnp.float32),
            pltpu.VMEM((rp.TILE_H, rp.TILE_W), jnp.int32),
            pltpu.VMEM((g.RASTER_BLOCK // 4, 128), jnp.int32),
            pltpu.VMEM((g.RASTER_BLOCK // 2, 128), jnp.float32),
            pltpu.SMEM((bits.shape[1],), jnp.int32),
            pltpu.SemaphoreType.DMA((3,)),
        ],
        interpret=True,
    )(bits.reshape(-1), supers, *rp._hbm_flat_inputs(ti, tf))
    return rvt.resolve_flat_vis(depth, idx, table), depth, idx


def reference_trans(ti, tf, w, h):
    """``rasterize_setup_pallas_trans``'s body, interpret mode, with the
    id plane: (color, depth, idx)."""
    supers, blocks, ti128, gbounds, table = rvt.prepare_trans_inputs(
        jnp.asarray(ti), jnp.asarray(tf))
    depth, idx = rp._pallas_call(
        rvt._trans_vis_kernel,
        grid=(h // rp.TILE_H, w // rp.TILE_W),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[_tile_spec(), _tile_spec()],
        out_shape=_vis_out(w, h),
        scratch_shapes=[
            pltpu.VMEM((rp.TILE_H, rp.TILE_W), jnp.float32),
            pltpu.VMEM((rp.TILE_H, rp.TILE_W), jnp.int32),
            pltpu.VMEM((g.RASTER_BLOCK, 128), jnp.int32),
            pltpu.VMEM((1, (g.RASTER_BLOCK // rvt.TRANS_GROUP) * 8),
                       jnp.int32),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        interpret=True,
    )(supers, blocks, ti128, gbounds)
    return rvt.resolve_flat_vis(depth, idx, table), depth, idx


@pytest.fixture
def lanes(monkeypatch):
    """The two names the reference's K10vis reads, for this test only."""
    monkeypatch.setattr(rvt, "I32_LANES", rp.I32_LANES, raising=False)
    monkeypatch.setattr(rvt, "F32_LANES", rp.F32_LANES, raising=False)


CASES = {  # name: (setup, reference, plain, prepare)
    "vis_demo_128x32": (demo_setup, reference_vis, vt.raster_vis_plain,
                        lambda ti, tf, w, h: vt.prepare_vis_inputs(ti, tf, w,
                                                                   h)),
    "vis_padded_soup_128x64": (padded_setup, reference_vis,
                               vt.raster_vis_plain,
                               lambda ti, tf, w, h: vt.prepare_vis_inputs(
                                   ti, tf, w, h)),
    "trans_tie_soup_256x64": (tie_soup_setup, reference_trans,
                              vt.raster_trans_plain,
                              lambda ti, tf, w, h: vt.prepare_trans_inputs(
                                  ti, tf)),
    "trans_padded_soup_128x64": (padded_setup, reference_trans,
                                 vt.raster_trans_plain,
                                 lambda ti, tf, w, h: vt.prepare_trans_inputs(
                                     ti, tf)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name, lanes):
    build, reference, plain, prepare = CASES[name]
    ti, tf, w, h = build()
    ref_c, ref_d, ref_i = (np.asarray(x) for x in reference(ti, tf, w, h))
    *args, table = prepare(T(ti), T(tf), w, h)
    depth, idx = plain(*args, w, h)
    color = vt.resolve_flat_vis(depth, idx, table).numpy()
    depth, idx = depth.numpy(), idx.numpy()
    assert (depth < 1.0).mean() > 0.05
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_array_equal(color.view(np.uint32),
                                  ref_c.view(np.uint32))
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    ulp = np.abs(depth.view(np.int32).astype(np.int64)
                 - ref_d.view(np.int32).astype(np.int64))
    assert ulp.max() <= DEPTH_MAX_ULP
    if "padded" in name:  # rows 56-63: K10vis draws there, K10trans not
        drawn = int((depth[56:] < 1.0).sum())
        assert drawn == (451 if name.startswith("vis") else 0)


def test_reference_vis_lacks_its_lane_constants():
    """Without the run-time patch, the reference's K10vis fails: its
    kernel reads I32_LANES, defined in raster_pallas.py and not imported
    (tests/test_raster_pallas.py::test_vis_buffer_matches_hbm_kernel)."""
    assert not hasattr(rvt, "I32_LANES") and not hasattr(rvt, "F32_LANES")
    ti, tf, w, h = demo_setup()
    with pytest.raises(NameError, match="I32_LANES"):
        rvt.rasterize_setup_pallas_vis(jnp.asarray(ti), jnp.asarray(tf), w,
                                       h, interpret=True)
