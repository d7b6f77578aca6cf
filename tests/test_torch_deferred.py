"""The port's deferred pipeline (zrenderer_tpu_torch: ops/light_kernel.py's
light bounds, per-tile lists and the plain K7, ops/shading.py's
``ggx_shade_many_lights``, engine/passes.py's ``build_deferred_frame`` and
the deferred Renderer) against the JAX package on the CPU.  K7's plain
version against the Pallas kernel in interpret mode is in
test_torch_deferred_interpret.py.

Contract:

* ``light_screen_bounds`` is int32-equal to the reference's, lights
  behind the camera, on its plane and far away included, at unpadded,
  padded and band sizes; the per-tile counts equal a NumPy hit test and
  the lists hold each tile's lights first, in id order;
* ``ggx_shade_many_lights`` is within rtol 1e-4 / atol 1e-6 of the
  reference's: its ``rsqrt`` is XLA:CPU's, up to 2 ulp from the port's
  1/sqrt, and at low roughness the distribution term's
  ``ndoth^2 (a^2 - 1) + 1`` cancels, which magnifies an ulp of the half
  vector (5e-5 relative seen); pow(x, 5) and the sums differ too;
* the 160x96 deferred frame is within 1 LSB of
  ``tests/goldens/deferred_160x96.png`` (0 LSB with this JAX), its bf16
  planes within 2 LSB of its f32 planes;
* the light bounds use the padded frame's size, as the reference's do:
  at 160x96 (padded 256x96) the lists of some tiles differ from those at
  the unpadded size, and the port lights them with the padded lists.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import light_kernel as jl
from zrenderer_tpu.ops import shading as jsh
from zrenderer_tpu.utils.png import read_png
from zrenderer_tpu_torch.app.main import main as app_main
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.ops import light_kernel as tl
from zrenderer_tpu_torch.ops import shading
from zrenderer_tpu_torch.scene.procedural import make_test_scene

# The plain kernels run thousands of small torch ops.  Under xdist every
# worker imports this module; one intra-op thread a worker keeps six
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TEST_SCENE = os.path.join(ROOT, "content", "scenes", "test_scene")
DEFERRED_GOLDEN = os.path.join(ROOT, "tests", "goldens",
                               "deferred_160x96.png")

T = torch.from_numpy


def baseline_lights(intensity=1.0):
    """BASELINE config 3's 256 lights (benchmarks/configs.py:121-126):
    intensity 1.0 is the "wide" set, 0.008 the "r2" set."""
    rng = np.random.default_rng(3)
    pos = rng.uniform([-6, 0.5, -6], [6, 6, 6], (256, 3)).astype(np.float32)
    col = rng.uniform(0.1, 1.0, (256, 3)).astype(np.float32)
    return pos, (col * np.float32(intensity)).astype(np.float32)


def golden_lights():
    """The 8 lights of tests/test_golden.py::test_png_golden_deferred."""
    rng = np.random.default_rng(5)
    pos = rng.uniform([-5, 0.5, -5], [5, 5, 5], (8, 3)).astype(np.float32)
    col = rng.uniform(0.2, 2.0, (8, 3)).astype(np.float32)
    return pos, col


def awkward_lights():
    """Lights behind the camera, on its plane (|w| < 1e-6 and < 1e-3),
    just in front of it, far away, and with colour 0, around the test
    scene's camera."""
    cam = make_test_scene()[0].active_camera
    eye = np.asarray(cam.position, np.float32)
    fwd = np.asarray(cam.forward, np.float32)
    fwd = fwd / np.linalg.norm(fwd)
    side = np.cross(fwd, [0.0, 1.0, 0.0]).astype(np.float32)
    rng = np.random.default_rng(8)
    pos = [eye - fwd * d for d in (0.5, 3.0, 40.0)]  # behind
    pos += [eye + side * s for s in (0.0, 1.5, -7.0)]  # on the camera plane
    pos += [eye + fwd * d + side * 0.3 for d in (2e-4, 5e-4, 2e-3, 0.11)]
    pos += [eye + fwd * 500.0, eye + fwd * 3.0 + side * 400.0]  # far
    pos += list(rng.uniform([-6, 0.5, -6], [6, 6, 6], (20, 3)))
    pos = np.asarray(pos, np.float32)
    col = rng.uniform(0.0, 1.5, pos.shape).astype(np.float32)
    col[-3:] = 0.0
    return pos, col


LIGHT_SETS = {"wide": lambda: baseline_lights(1.0),
              "r2": lambda: baseline_lights(0.008),
              "golden": golden_lights, "awkward": awkward_lights}
# (viewport for the projection, size the bounds are computed at): the
# 160x96 golden frame and 1080p, unpadded and padded.
SIZES = {"160x96": ((160, 96), (160, 96)),
         "160x96_pad": ((160, 96), (256, 96)),
         "1080p": ((1920, 1080), (1920, 1080)),
         "1080p_pad": ((1920, 1080), (1920, 1088))}


def _view_proj(w, h):
    return g.view_proj_from_camera(make_test_scene()[0].active_camera, w, h)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("lights", list(LIGHT_SETS))
def test_light_screen_bounds_match_reference(lights, size):
    pos, col = LIGHT_SETS[lights]()
    (vw, vh), (w, h) = SIZES[size]
    vp = _view_proj(vw, vh)
    ours = tl.light_screen_bounds(T(pos), T(col), T(vp), w, h)
    ref = np.asarray(jl.light_screen_bounds(jnp.asarray(pos), jnp.asarray(col),
                                            jnp.asarray(vp), w, h))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    if lights == "awkward":
        # The behind/near-plane lights got the whole frame, the far ones
        # clamped boxes.
        full = np.array([0, w - 1, 0, h - 1])
        assert (ref == full).all(axis=1).sum() >= 6


def _numpy_hits(bounds, tiles_y, tiles_x, row_offset):
    hits = np.zeros((tiles_y * tiles_x, len(bounds)), bool)
    for t in range(tiles_y * tiles_x):
        r0 = (t // tiles_x) * 32 + row_offset
        c0 = (t % tiles_x) * 128
        for i, (jmin, jmax, imin, imax) in enumerate(bounds):
            hits[t, i] = (jmax >= c0 and jmin < c0 + 128 and imax >= r0
                          and imin < r0 + 32)
    return hits


@pytest.mark.parametrize("row_offset", [0, 64])
@pytest.mark.parametrize("lights", ["r2", "awkward"])
def test_tile_light_lists_match_numpy_hit_test(lights, row_offset):
    pos, col = LIGHT_SETS[lights]()
    vp = _view_proj(1920, 1080)
    bounds = tl.light_screen_bounds(T(pos), T(col), T(vp), 1920, 1088)
    ty, tx = 4 if row_offset else 34, 15
    counts, lists = tl.tile_light_lists(bounds, ty, tx, row_offset)
    hits = _numpy_hits(bounds.numpy(), ty, tx, row_offset)
    np.testing.assert_array_equal(counts.numpy(), hits.sum(axis=1))
    assert 0 < counts.min() or 0 < counts.max() < len(pos)
    for t in range(ty * tx):
        n = int(counts[t])
        np.testing.assert_array_equal(lists[t, :n].numpy(),
                                      np.flatnonzero(hits[t]))
        assert set(lists[t, n:].tolist()) == set(np.flatnonzero(~hits[t]))


def _shading_inputs(seed, h=24, w=40):
    rng = np.random.default_rng(seed)
    albedo = rng.random((h, w, 3), dtype=np.float32)
    normal = rng.standard_normal((h, w, 3)).astype(np.float32)
    world = rng.uniform(-3, 3, (h, w, 3)).astype(np.float32)
    met = rng.random((h, w), dtype=np.float32)
    rgh = rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)
    return albedo, normal, world, met, rgh


@pytest.mark.parametrize("materials", ["scalar", "planes"])
@pytest.mark.parametrize("num_lights", [8, 64])
def test_ggx_shade_many_lights_matches_reference(num_lights, materials):
    albedo, normal, world, met, rgh = _shading_inputs(num_lights)
    pos, col = baseline_lights(0.05)
    pos, col = pos[:num_lights], col[:num_lights]
    cam = np.asarray(make_test_scene()[0].active_camera.position, np.float32)
    kw = ({} if materials == "scalar"
          else {"metallic": met, "roughness": rgh})
    ref = np.asarray(jsh.ggx_shade_many_lights(
        jnp.asarray(albedo), jnp.asarray(normal), jnp.asarray(world),
        jnp.asarray(cam), jnp.asarray(pos), jnp.asarray(col),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    ours = shading.ggx_shade_many_lights(
        T(albedo), T(normal), T(world), T(cam), T(pos), T(col),
        **{k: T(v) for k, v in kw.items()})
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-6)


def test_reconstruct_world_pos_row_offset_matches_reference():
    rng = np.random.default_rng(2)
    depth = rng.random((32, 48), dtype=np.float32)
    inv = np.linalg.inv(_view_proj(48, 96).astype(np.float64)).astype(
        np.float32)
    for offset in (0, 32, 64):
        ours = shading.reconstruct_world_pos(T(depth), T(inv), 48, 96,
                                             row_offset=offset)
        ref = jsh.reconstruct_world_pos(jnp.asarray(depth), jnp.asarray(inv),
                                        48, 96, row_offset=offset)
        np.testing.assert_array_equal(ours.numpy().view(np.int32),
                                      np.asarray(ref).view(np.int32))


def _deferred(w=160, h=96, lights=None, **kw):
    r = Renderer(RenderConfig(width=w, height=h, pipeline="deferred",
                              tri_align=64, **kw), device="cpu")
    r.load_scene(*make_test_scene())
    r.set_environment(lights=lights or golden_lights())
    return r


def test_deferred_frame_matches_golden():
    img, depth = _deferred().render_and_read()
    ref = read_png(DEFERRED_GOLDEN)
    assert img.shape == ref.shape == (96, 160, 4)
    assert (depth < 1.0).mean() > 0.3
    diff = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1


def test_bf16_lighting_planes_within_2_lsb_of_f32():
    img, depth = _deferred().render_and_read()
    img16, depth16 = _deferred(lighting_planes="bf16").render_and_read()
    np.testing.assert_array_equal(depth, depth16)
    diff = np.abs(img.astype(np.int32) - img16.astype(np.int32))
    assert 0 < diff.max() <= 2  # bf16 moves some pixels, none far


def test_deferred_animation_digests_equal_frames():
    r = _deferred(lights=baseline_lights(0.008))
    cams = []
    for dx in (0.0, 0.4):
        cam = make_test_scene()[0].active_camera
        cam.position = np.asarray(cam.position, np.float32) + np.float32(dx)
        cams.append(cam)
    digests, (color, _) = r.render_animation(cameras=cams)
    frames = [r.render_and_read(camera=c)[0] for c in cams]
    assert digests[0] != digests[1]
    for d, f in zip(digests.tolist(), frames):
        assert d == float(np.float32(f.astype(np.int64).sum()))
    np.testing.assert_array_equal(color.numpy(), frames[-1])


def test_padded_bounds_change_lists_and_are_kept():
    """Finding: the reference computes the bounds at the padded size.  At
    160x96 (padded 256x96) with the r2 lights some tiles' lists differ
    from the unpadded size's; the port lights those tiles with the padded
    lists, as the reference does."""
    pos, col = baseline_lights(0.008)
    vp = _view_proj(160, 96)
    padded = tl.light_screen_bounds(T(pos), T(col), T(vp), 256, 96)
    unpadded = tl.light_screen_bounds(T(pos), T(col), T(vp), 160, 96)
    hits_p = tl.tile_light_hits(padded, 3, 2)
    hits_u = tl.tile_light_hits(unpadded, 3, 2)
    changed = (hits_p != hits_u).any(dim=1)
    assert int(changed.sum()) > 0

    albedo, normal, world, met, rgh = _shading_inputs(5, 96, 256)
    world = world * np.float32(2.0)
    covered = np.ones((96, 256), bool)
    cam = np.asarray(make_test_scene()[0].active_camera.position, np.float32)
    ours = tl.tiled_deferred_lighting(
        T(albedo), T(normal), T(world), T(covered), T(cam), T(pos), T(col),
        T(vp), roughness=T(rgh), metallic=T(met))
    planes = torch.stack([T(x) for x in (
        *albedo.transpose(2, 0, 1), *normal.transpose(2, 0, 1),
        *world.transpose(2, 0, 1), met, rgh)])
    lights = T(np.concatenate([pos, col], axis=1))
    consts = torch.tensor([*cam, np.float32(0.03)])
    mask = T(covered.astype(np.int32))

    def lit(bounds):
        return tl.tiled_light_plain(planes, mask, bounds, lights,
                                    consts).permute(1, 2, 0)

    np.testing.assert_array_equal(ours.numpy(), lit(padded).numpy())
    tiles = changed.reshape(3, 2).repeat_interleave(32, 0) \
        .repeat_interleave(128, 1)
    other = lit(unpadded)
    assert not torch.equal(ours[tiles], other[tiles])
    assert torch.equal(ours[~tiles], other[~tiles])


def test_light_kernels_refuse_cpu_tensors():
    """The kernels' wrappers never fall back to the plain version."""
    planes = torch.zeros((tl.NUM_PLANES, 32, 128))
    args = (torch.zeros((32, 128), dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 6)),
            torch.zeros(4))
    with pytest.raises(ValueError, match="CUDA"):
        tl.tiled_light_kernel(planes, *args)
    with pytest.raises(ValueError, match="CUDA"):
        tl.tiled_light_bf16_kernel(planes.to(torch.bfloat16), *args)
    with pytest.raises(TypeError):
        tl.tiled_light_kernel(planes.to(torch.bfloat16), *args)
    assert tl.tiled_light(planes, *args).shape == (3, 32, 128)
    assert all(k.launches == 0 for k in tl.LIGHT_KERNELS)
    with pytest.raises(ValueError, match="multiple"):
        tl.tiled_deferred_lighting(
            torch.zeros((30, 128, 3)), torch.zeros((30, 128, 3)),
            torch.zeros((30, 128, 3)), torch.zeros((30, 128), dtype=bool),
            np.zeros(3, np.float32), *golden_lights(), np.eye(4))


def test_deferred_config_and_default_light():
    with pytest.raises(ValueError, match="lighting_planes"):
        RenderConfig(pipeline="deferred", lighting_planes="f16")
    r = Renderer(RenderConfig(width=128, height=64, pipeline="deferred",
                              tri_align=64), device="cpu")
    r.load_scene(*make_test_scene())
    img, depth = r.render_and_read()  # binds the default environment
    np.testing.assert_array_equal(r.lights[0].numpy(), [[4.0, 8.0, 6.0]])
    np.testing.assert_array_equal(r.lights[1].numpy(), [[1.0, 1.0, 1.0]])
    assert (img[depth < 1.0][:, :3].sum(-1) > 0).mean() > 0.9


def test_app_renders_deferred_taa_png(tmp_path):
    rc = app_main(["--scene", TEST_SCENE, "--width", "128", "--height", "64",
                   "--frames", "2", "--out", str(tmp_path), "--device", "cpu",
                   "--pipeline", "deferred", "--taa"])
    assert rc == 0
    img = read_png(str(tmp_path / "frame_0001.png"))
    assert img.shape == (64, 128, 4)
    assert (img[..., :3].astype(np.int32).sum(-1) > 0).mean() > 0.05
