"""Plain K7 (zrenderer_tpu_torch/ops/light_kernel.py ``tiled_light_plain``,
through ``tiled_deferred_lighting``) against the reference's
``tiled_deferred_lighting(interpret=True)`` on shared seeded inputs: f32
and bf16 planes, scalar and per-pixel materials, and a band of a taller
frame (``row_offset``, ``full_height``).

Kept apart from test_torch_deferred.py so that the interpret runs land on
their own test worker.  Contract, as found at 64x256 with 40 lights:

* the culling is the same: bounds and lists are int32-equal
  (test_torch_deferred.py), so every pixel sums the same lights in the
  same order;
* f32 output within 2.5e-2 relative on every value and 1e-3 on 99.9% of
  them (about half the values are bit-equal);
* the u8 tonemap of the output within 2 LSB, over 0 LSB on at most 0.05%
  of the pixels.

Why not bit-equal: interpret mode lowers ``pl.reciprocal(denom,
approx=True)`` to ``1 / bf16(denom)``, as the port does, but XLA:CPU's
``rsqrt`` is up to 2 ulp from the port's IEEE ``1 / sqrt``; an ulp of
``denom`` can move its bf16 rounding to the neighbouring value, 2^-8
relative on that light's specular term, and a few such lights add up on
rare pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import light_kernel as jl
from zrenderer_tpu.scene.procedural import make_test_scene
from zrenderer_tpu_torch.ops import light_kernel as tl

torch.set_num_threads(1)

H, W, L = 64, 256, 40
MAX_REL = 2.5e-2
MAX_REL_Q999 = 1e-3
MAX_LSB = 2
MAX_LSB_SHARE = 5e-4

T = torch.from_numpy


def _inputs(seed, intensity):
    rng = np.random.default_rng(seed)
    return {
        "albedo": rng.random((H, W, 3), dtype=np.float32),
        "normal": rng.standard_normal((H, W, 3)).astype(np.float32),
        "world": rng.uniform([-4, 0, -4], [4, 3, 4], (H, W, 3)).astype(
            np.float32),
        "covered": rng.random((H, W)) < 0.85,
        "light_pos": rng.uniform([-6, 0.5, -6], [6, 6, 6], (L, 3)).astype(
            np.float32),
        "light_color": (rng.uniform(0.1, 1.0, (L, 3))
                        * intensity).astype(np.float32),
        "metallic": rng.random((H, W), dtype=np.float32),
        "roughness": rng.uniform(0.05, 1.0, (H, W)).astype(np.float32),
    }


def _u8(x):
    return np.floor(np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.int32)


CASES = {  # name: (plane dtype, per-pixel materials, band, intensity)
    "f32_scalar": ("f32", False, False, 1.0),
    "f32_planes": ("f32", True, False, 1.0),
    "bf16_scalar": ("bf16", False, False, 1.0),
    "bf16_planes": ("bf16", True, False, 1.0),
    "f32_band_culled": ("f32", True, True, 0.008),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_light_matches_pallas_interpret(case):
    dtype, planes, band, intensity = CASES[case]
    x = _inputs(1, intensity)
    if not planes:
        del x["metallic"], x["roughness"]  # the defaults 0.0 and 0.4
    camera = make_test_scene()[0].active_camera
    full = 4 * H if band else H
    vp = g.view_proj_from_camera(camera, W, full)
    cam = np.asarray(camera.position, np.float32)
    kw = {"row_offset": 2 * H, "full_height": full} if band else {}
    ref = np.asarray(jl.tiled_deferred_lighting(
        **{k: jnp.asarray(v) for k, v in x.items()}, cam_pos=jnp.asarray(cam),
        view_proj=jnp.asarray(vp), interpret=True,
        plane_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32, **kw))
    ours = tl.tiled_deferred_lighting(
        **{k: T(v) for k, v in x.items()}, cam_pos=T(cam), view_proj=T(vp),
        plane_dtype=torch.bfloat16 if dtype == "bf16" else torch.float32,
        **kw)
    assert ours.shape == (H, W, 3) and ours.dtype == torch.float32
    ours = ours.numpy()
    if band:  # the culling engaged: some tile lists part of the lights
        bounds = tl.light_screen_bounds(T(x["light_pos"]),
                                        T(x["light_color"]), T(vp), W, full)
        counts, _ = tl.tile_light_lists(bounds, H // 32, W // 128, 2 * H)
        assert 0 < int(counts.min()) < L or 0 < int(counts.max()) < L
    rel = np.abs(ours - ref) / np.maximum(np.abs(ref), 1e-30)
    assert (ours == ref).mean() > 0.4
    assert rel.max() <= MAX_REL
    assert np.quantile(rel, 0.999) <= MAX_REL_Q999
    lsb = np.abs(_u8(ours) - _u8(ref))
    assert lsb.max() <= MAX_LSB
    assert (lsb > 0).any(-1).mean() <= MAX_LSB_SHARE
    assert ref[~x["covered"]].max(initial=0.0) == 0.0
    np.testing.assert_array_equal(ours[~x["covered"]], 0.0)
