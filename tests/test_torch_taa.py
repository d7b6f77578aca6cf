"""The port's TAA (zrenderer_tpu_torch/ops/taa.py) and the jittered frame
constants against the JAX package on the CPU.

Contract: bit-equal throughout.  The Halton jitters and the jittered
view-projection are copies of the reference's host code; both resolves
are integer arithmetic, so ``taa_resolve`` and ``taa_resolve_packed``
equal the reference's on random frames with the history carried, equal
each other, and refuse an alpha that quantizes to 0; the converged 160x96
frame (8 jittered flat frames) equals
``tests/goldens/taa_converged_160x96.png``; the jittered per-frame
constants equal the reference's ``camera_matrices`` and
``_lit_constants``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.engine.config import RenderConfig as JaxConfig
from zrenderer_tpu.engine.renderer import Renderer as JaxRenderer
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import taa as jtaa
from zrenderer_tpu.scene.procedural import make_test_scene as jax_test_scene
from zrenderer_tpu.utils.png import read_png
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.ops import raster
from zrenderer_tpu_torch.ops import taa
from zrenderer_tpu_torch.scene.procedural import make_test_scene

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TAA_GOLDEN = os.path.join(ROOT, "tests", "goldens",
                          "taa_converged_160x96.png")


def test_halton_and_jitters_match_reference():
    for base in (2, 3, 5):
        for i in range(40):
            assert taa.halton(i, base) == jtaa.halton(i, base)
    for n in (1, 8, 16):
        ours, ref = taa.jitter_sequence(n), jtaa.jitter_sequence(n)
        assert ours.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", [(160, 96), (1920, 1080), (255, 131)])
def test_jittered_view_proj_matches_reference(size):
    vp = g.view_proj_from_camera(jax_test_scene()[0].active_camera, *size)
    for jitter in taa.jitter_sequence(8):
        ours = taa.jittered_view_proj(vp, jitter, *size)
        ref = jtaa.jittered_view_proj(vp, jitter, *size)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def _frames(seed, n=4, h=24, w=40):
    """n random RGBA8 frames, neighbours alike (a moving gradient plus
    noise) so the clamp both holds and lets the history through."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w, 4)).astype(np.int32)
    frames = []
    for i in range(n):
        noise = rng.integers(-40, 41, (h, w, 4))
        frames.append(np.clip(np.roll(base, i, axis=1) + noise, 0, 255)
                      .astype(np.uint8))
    return frames


def _pack(frame):
    return frame.astype(np.uint32) @ np.array([1, 1 << 8, 1 << 16, 1 << 24],
                                              np.uint32)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0, 1.0 / 64])
def test_taa_resolves_match_reference(alpha):
    frames = _frames(int(alpha * 1000))
    hist = taa.taa_init_history(torch.from_numpy(frames[0]))
    hist_p = taa.taa_init_history_packed(torch.from_numpy(
        _pack(frames[0]).view(np.int32)))
    ref = jtaa.taa_init_history(jnp.asarray(frames[0]))
    ref_p = jtaa.taa_init_history_packed(jnp.asarray(_pack(frames[0])))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(hist_p.numpy(), np.asarray(ref_p))
    for frame in frames[1:]:
        hist, res = taa.taa_resolve(hist, torch.from_numpy(frame), alpha)
        ref, ref_res = jtaa.taa_resolve(ref, jnp.asarray(frame), alpha)
        packed = torch.from_numpy(_pack(frame).view(np.int32))
        hist_p, res_p = taa.taa_resolve_packed(hist_p, packed, alpha)
        ref_p, ref_res_p = jtaa.taa_resolve_packed(
            ref_p, jnp.asarray(_pack(frame)), alpha)
        assert hist.dtype == hist_p.dtype == torch.int32
        assert res.dtype == torch.uint8 and res_p.dtype == torch.int32
        np.testing.assert_array_equal(hist.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(res.numpy(), np.asarray(ref_res))
        np.testing.assert_array_equal(hist_p.numpy(), np.asarray(ref_p))
        np.testing.assert_array_equal(res_p.numpy().view(np.uint32),
                                      np.asarray(ref_res_p))
        # The two entry points: one resolve.
        np.testing.assert_array_equal(hist_p.permute(1, 2, 0).numpy(),
                                      hist.numpy())
        np.testing.assert_array_equal(
            raster.unpack_rgba8(res_p).numpy(), res.numpy())


@pytest.mark.parametrize("alpha", [0.0, 1.0 / 200, 1.0 / 128, 1.5])
def test_taa_alpha_that_quantizes_out_of_range_raises(alpha):
    """1/128, which the message names as the minimum, raises too on both
    sides: Python's round(0.5) is 0."""
    frame = torch.from_numpy(_frames(0, n=1)[0])
    packed = torch.from_numpy(_pack(frame.numpy()).view(np.int32))
    with pytest.raises(ValueError, match="quantizes"):
        taa.taa_resolve(taa.taa_init_history(frame), frame, alpha)
    with pytest.raises(ValueError, match="quantizes"):
        taa.taa_resolve_packed(taa.taa_init_history_packed(packed), packed,
                               alpha)
    with pytest.raises(ValueError, match="quantizes"):
        jtaa.taa_resolve(jtaa.taa_init_history(jnp.asarray(frame.numpy())),
                         jnp.asarray(frame.numpy()), alpha)


def test_taa_converged_frame_matches_golden():
    """The app's --taa composition: 8 jittered flat frames, each resolved
    into the history carried from the last."""
    r = Renderer(RenderConfig(width=160, height=96, tri_align=64),
                 device="cpu")
    r.load_scene(*make_test_scene())
    history = None
    for jitter in taa.jitter_sequence(8):
        color, _ = r.render(jitter=jitter)
        if history is None:
            history = taa.taa_init_history(color)
        history, resolved = taa.taa_resolve(history, color)
    np.testing.assert_array_equal(resolved.numpy(), read_png(TAA_GOLDEN))


def _renderers(pipeline):
    jr = JaxRenderer(JaxConfig(width=160, height=96, pipeline=pipeline,
                               backend="xla", tri_align=64))
    jr.load_scene(*jax_test_scene())
    r = Renderer(RenderConfig(width=160, height=96, pipeline=pipeline,
                              tri_align=64), device="cpu")
    r.load_scene(*make_test_scene())
    return jr, r


@pytest.mark.parametrize("pipeline", ["lit", "deferred"])
def test_jittered_constants_match_reference(pipeline):
    jr, r = _renderers(pipeline)
    for jitter in taa.jitter_sequence(3):
        ours = r._lit_constants(jitter=jitter)
        ref = jr._lit_constants(jitter=jitter)
        for key in ("matrices", "normal_mats", "view_proj", "inv_view_proj",
                    "cam_pos"):
            np.testing.assert_array_equal(ours[key].view(np.int32),
                                          np.asarray(ref[key]).view(np.int32))
        np.testing.assert_array_equal(
            r.camera_matrices(jitter=jitter).view(np.int32),
            jr.camera_matrices(jitter=jitter).view(np.int32))


@pytest.mark.parametrize("pipeline", ["flat", "deferred"])
def test_animation_jitters_equal_rendered_frames(pipeline):
    r = Renderer(RenderConfig(width=128, height=64, pipeline=pipeline,
                              tri_align=64), device="cpu")
    r.load_scene(*make_test_scene())
    jitters = taa.jitter_sequence(3)
    digests, (color, _) = r.render_animation(jitters=jitters)
    frames = [r.render_and_read(jitter=j)[0] for j in jitters]
    assert len(set(digests.tolist())) > 1  # the jitter moved coverage
    if pipeline != "flat":  # flat digests the padded packed plane
        for d, f in zip(digests.tolist(), frames):
            assert d == float(np.float32(f.astype(np.int64).sum()))
    np.testing.assert_array_equal(color.numpy(), frames[-1])
