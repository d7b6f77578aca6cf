"""The port's overlay pass (zrenderer_tpu_torch/ops/overlay.py: the host
setup, K8's and K8b's plain versions, ``overlay_pass``) against the JAX
package's overlay on the CPU.  K8's plain version against the Pallas
kernel in interpret mode is in test_torch_overlay_interpret.py.

Contract:

* ``setup_overlay_triangles`` is byte-equal to the reference's with
  ``xp=np``, negative-area, degenerate and off-screen triangles and empty
  scissors included;
* K8's plain version writes the count and the overflow int32-equal to the
  reference's XLA form ``rasterize_overlay_xla``, and every layer plane
  bit-equal to a NumPy transcription of its formulas (each product and
  sum rounded, as the oracle and the CUDA kernel round them).  Against
  the XLA form the layers hold the same draws in the same slots, the
  colours equal within 1 per channel and u, v within 2**-20: XLA:CPU
  contracts the interpolation's multiply-adds inside its fused loops
  whatever barriers it is given (docs/RASTER_SPEC.md §5), by up to
  2**-22 here;
* the composite is bit-equal to the oracle ``composite_overlay_cpu``
  (unlimited depth) where no pixel is deeper than K, and within 1 LSB per
  blended layer of the reference's ``overlay_pass(..., "xla")``, the
  reference's own rule (tests/test_overlay_raster.py);
* the port's flat 160x96 frame with the golden's panel is within 1 LSB of
  ``tests/goldens/overlay_160x96.png``, which the reference's Pallas
  interpret mode wrote, and bit-equal to the oracle's composite of the
  same draw list.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.app.draw_list import DrawList as RefDrawList
from zrenderer_tpu.app.font import UIAtlas as RefAtlas
from zrenderer_tpu.ops import overlay_raster as rov
from zrenderer_tpu.raster_ref.overlay_cpu import (
    composite_overlay_cpu as ref_oracle,
)
from zrenderer_tpu.utils.png import read_png
from zrenderer_tpu_torch.app.draw_list import DrawList
from zrenderer_tpu_torch.app.font import UIAtlas
from zrenderer_tpu_torch.app.overlay_ui import OverlayUI, atlas_on
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import overlay as ov
from zrenderer_tpu_torch.raster_ref.overlay_cpu import composite_overlay_cpu
from zrenderer_tpu_torch.scene.procedural import make_test_scene

# Many small torch ops: one intra-op thread a worker (see
# test_torch_deferred.py).
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
OVERLAY_GOLDEN = os.path.join(ROOT, "tests", "goldens", "overlay_160x96.png")

W, H = 128, 64  # the reference test's frame: one Pallas tile wide
UV_ATOL = 2.0 ** -20  # XLA:CPU's contracted interpolation (see above)
GOLDEN_MAX_LSB = 1

T = torch.from_numpy


def busy_draw_list(dl_cls, atlas, w=W, h=H):
    """The reference test's busy list (tests/test_overlay_raster.py):
    overlapping translucent panels, a rotated textured quad, scissored
    text, a circle and a line."""
    dl = dl_cls(w, h, atlas)
    dl.add_rect_filled(4, 4, 70, 40, (0.1, 0.1, 0.3, 0.8))
    dl.add_rect(4, 4, 70, 40, (0.4, 0.9, 0.4, 1.0), thickness=1)
    dl.add_rect_filled(30, 20, 100, 58, (0.8, 0.2, 0.1, 0.5))
    dl.add_quad_filled(
        (80, 8), (110, 20), (98, 50), (68, 38), (1.0, 1.0, 0.2, 0.9),
        uvs=[(0.0, 0.0), (0.5, 0.0), (0.5, 0.5), (0.0, 0.5)],
    )
    dl.push_clip_rect(10, 10, 52, 34)
    dl.add_text(12, 12, "HELLO 123", (0.0, 0.9, 0.0, 1.0), scale=2)
    dl.pop_clip_rect()
    dl.add_circle_filled(100, 45, 12, (0.2, 0.6, 0.9, 0.65), segments=12)
    dl.add_line((0, 60), (127, 30), (1.0, 0.3, 0.8, 0.7), thickness=2)
    return dl


def stacked_draw_list(dl_cls, atlas, n=ov.DEFAULT_K + 3):
    """The reference's overflow case: n translucent rects on one spot."""
    dl = dl_cls(W, H, atlas)
    for _ in range(n):
        dl.add_rect_filled(10, 10, 30, 30, (1.0, 1.0, 1.0, 0.1))
    return dl


def random_verts(seed, n=160, w=W, h=H):
    """A seeded soup of 2D triangles with random uv, colours outside [0, 1]
    and scissors (a third random, some empty), negative-area, degenerate
    and off-screen triangles."""
    rng = np.random.default_rng(seed)
    verts = np.zeros((n, 3, 8), np.float32)
    centre = rng.uniform([-0.1 * w, -0.1 * h], [1.1 * w, 1.1 * h], (n, 1, 2))
    verts[..., 0:2] = centre + rng.uniform(-0.5, 0.5, (n, 3, 2)) * [w, h]
    verts[..., 2:4] = rng.uniform(-1, 2, (n, 3, 2))
    verts[..., 4:8] = rng.uniform(-0.2, 1.2, (n, 3, 4))
    verts[0:8, 2] = verts[0:8, 1]  # degenerate: two corners equal
    verts[8:16, :, 0] += 4 * w  # off screen
    sc = np.tile(np.int32([0, 0, w, h]), (n, 1))
    x0 = rng.integers(-5, w, n)
    y0 = rng.integers(-5, h, n)
    some = np.stack([x0, y0, x0 + rng.integers(-4, w, n),
                     y0 + rng.integers(-4, h, n)], axis=1)
    sc[::3] = some[::3]
    sc[16:24] = [5, 5, 5, 40]  # empty scissors
    return verts, sc


@pytest.fixture(scope="module")
def atlases():
    return RefAtlas(), UIAtlas()


def _frame(w=W, h=H, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (h, w, 4), np.uint8)


def _layers_ref(layers, k):
    return [np.asarray(layers[3 * k + i]) for i in range(3)]


def numpy_layers(ti, tf, w, h, K=ov.DEFAULT_K):
    """K8's formulas in NumPy, rounding after every op (the oracle's
    arithmetic), over full-frame planes: (cnt, over, lu, lv, lc)."""
    g = tg
    half = g.SUBPIXEL // 2
    pi, pj = np.mgrid[0:h, 0:w].astype(np.int32)
    py, px = pi * g.SUBPIXEL + half, pj * g.SUBPIXEL + half
    cnt = np.zeros((h, w), np.int32)
    lu = np.zeros((K, h, w), np.float32)
    lv = np.zeros((K, h, w), np.float32)
    lc = np.zeros((K, h, w), np.uint32)
    for r, f in zip(ti, tf):
        e0 = r[g.I_DX0] * (py - r[g.I_Y1]) - r[g.I_DY0] * (px - r[g.I_X1])
        e1 = r[g.I_DX1] * (py - r[g.I_Y2]) - r[g.I_DY1] * (px - r[g.I_X2])
        e2 = r[g.I_DX2] * (py - r[g.I_Y0]) - r[g.I_DY2] * (px - r[g.I_X0])
        inside = ((e0 >= r[g.I_BIAS0]) & (e1 >= r[g.I_BIAS1])
                  & (e2 >= r[g.I_BIAS2])
                  & (pj >= r[g.I_JMIN]) & (pj <= r[g.I_JMAX])
                  & (pi >= r[g.I_IMIN]) & (pi <= r[g.I_IMAX])
                  & (r[g.I_VALID] > 0))
        ef = [e.astype(np.float32) for e in (e0, e1, e2)]

        def interp(c):
            return (ef[0] * f[c] + ef[1] * f[c + 1]) + ef[2] * f[c + 2]

        def q(c):
            return np.floor(np.clip(interp(c), 0.0, 1.0) * np.float32(255.0)
                            + np.float32(0.5)).astype(np.int32).astype(
                                np.uint32)

        u, v = interp(ov.F2_U0), interp(ov.F2_V0)
        col = (q(ov.F2_R0) | (q(ov.F2_G0) << 8) | (q(ov.F2_B0) << 16)
               | (q(ov.F2_A0) << 24))
        for k in range(K):
            m = inside & (cnt == k)
            lu[k] = np.where(m, u, lu[k])
            lv[k] = np.where(m, v, lv[k])
            lc[k] = np.where(m, col, lc[k])
        cnt = cnt + inside.astype(np.int32)
    return np.minimum(cnt, K), np.maximum(cnt - K, 0), lu, lv, lc


def _assert_layers_match_xla(port, ref, K=ov.DEFAULT_K):
    """Count and overflow int32-equal; u, v within UV_ATOL; colours within
    1 per channel (the XLA:CPU contraction of RASTER_SPEC §5)."""
    pc, po, (lu, lv, lc) = port
    cnt, over, layers = ref
    np.testing.assert_array_equal(pc.numpy(), np.asarray(cnt))
    np.testing.assert_array_equal(po.numpy(), np.asarray(over))
    for k in range(K):
        ru, rv, rc = _layers_ref(layers, k)
        np.testing.assert_allclose(lu[k].numpy(), ru, rtol=0, atol=UV_ATOL)
        np.testing.assert_allclose(lv[k].numpy(), rv, rtol=0, atol=UV_ATOL)
        a = lc[k].numpy().view(np.uint32)
        b = rc.view(np.uint32)
        for s in (0, 8, 16, 24):
            d = np.abs(((a >> s) & 255).astype(np.int32)
                       - ((b >> s) & 255).astype(np.int32))
            assert d.max() <= 1, (k, s, d.max())


def _assert_layers_bit_equal(port, expect):
    pc, po, (lu, lv, lc) = port
    cnt, over, eu, ev, ec = expect
    np.testing.assert_array_equal(pc.numpy(), cnt)
    np.testing.assert_array_equal(po.numpy(), over)
    np.testing.assert_array_equal(lu.numpy().view(np.int32), eu.view(np.int32))
    np.testing.assert_array_equal(lv.numpy().view(np.int32), ev.view(np.int32))
    np.testing.assert_array_equal(lc.numpy().view(np.uint32), ec)


# ---------------------------------------------------------------------------
# Host setup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [(128, 64), (1920, 1080), (37, 23)])
def test_setup_matches_reference(seed, size):
    w, h = size
    verts, sc = random_verts(seed, w=w, h=h)
    ti, tf = ov.setup_overlay_triangles(verts, sc, w, h)
    ri, rf = rov.setup_overlay_triangles(np, verts, sc, w, h)
    assert ti.dtype == np.int32 and tf.dtype == np.float32
    assert ti.shape == (len(verts), ov.NI32_2D)
    assert tf.shape == (len(verts), ov.NF32_2D)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tf.view(np.int32), rf.view(np.int32))
    dead = ti[:, tg.I_VALID] == 0
    assert dead[:24].all() and (~dead).sum() > len(verts) // 2
    assert (ti[dead, tg.I_JMIN] == 1).all() and (ti[dead, tg.I_JMAX] == 0).all()


def test_layout_constants_match_reference():
    for name in ("DEFAULT_K", "NI32_2D", "NF32_2D", "F2_U0", "F2_V0",
                 "F2_R0", "F2_G0", "F2_B0", "F2_A0", "F2_A2"):
        assert getattr(ov, name) == getattr(rov, name), name


# ---------------------------------------------------------------------------
# K8's plain version
# ---------------------------------------------------------------------------


def _draw_lists(atlases):
    ra, pa = atlases
    return {
        "busy": (busy_draw_list(RefDrawList, ra).setup(),
                 busy_draw_list(DrawList, pa).setup()),
        "stacked": (stacked_draw_list(RefDrawList, ra).setup(),
                    stacked_draw_list(DrawList, pa).setup()),
    }


@pytest.mark.parametrize("case", ["busy", "stacked", "random"])
def test_plain_k8_matches_numpy_and_xla(case, atlases):
    if case == "random":
        verts, sc = random_verts(3)
        ti, tf = ov.setup_overlay_triangles(verts, sc, W, H)
    else:
        (ri, rf), (ti, tf) = _draw_lists(atlases)[case]
        np.testing.assert_array_equal(ti, ri)
        np.testing.assert_array_equal(tf.view(np.int32), rf.view(np.int32))
    port = ov.rasterize_overlay(T(ti), T(tf), W, H)
    _assert_layers_bit_equal(port, numpy_layers(ti, tf, W, H))
    ref = rov.rasterize_overlay_xla(jnp.asarray(ti), jnp.asarray(tf), W, H)
    _assert_layers_match_xla(port, ref)
    if case == "busy":
        assert int(port[0].max()) >= 2  # translucent draws overlap
    if case == "random":
        assert int(port[1].max()) > 0  # some pixels deeper than K


def test_overflow_keeps_the_oldest_k():
    """DEFAULT_K + 3 stacked rects: count K and overflow 3 on the stack,
    the K oldest draws in the layers."""
    atlas = UIAtlas()
    ti, tf = stacked_draw_list(DrawList, atlas).setup()
    cnt, over, (lu, lv, lc) = ov.rasterize_overlay(T(ti), T(tf), W, H)
    assert int(cnt[20, 20]) == ov.DEFAULT_K
    assert int(over[20, 20]) == 3
    assert int(cnt[0, 0]) == 0 and int(over[0, 0]) == 0
    alpha = (lc[:, 20, 20].numpy().view(np.uint32) >> 24) & 255
    assert (alpha == 26).all()  # round(0.1 * 255)


@pytest.mark.parametrize("K", [2, 3])
def test_small_k_matches_numpy(K, atlases):
    (_, (ti, tf)) = _draw_lists(atlases)["busy"]
    port = ov.rasterize_overlay(T(ti), T(tf), W, H, K=K)
    _assert_layers_bit_equal(port, numpy_layers(ti, tf, W, H, K=K))
    ref = rov.rasterize_overlay_xla(jnp.asarray(ti), jnp.asarray(tf), W, H,
                                    K=K)
    _assert_layers_match_xla(port, ref, K=K)


def test_kernel_wrappers_take_cuda_tensors_only():
    ti, tf = busy_draw_list(DrawList, UIAtlas()).setup()
    with pytest.raises(ValueError, match="CUDA"):
        ov.overlay_raster_kernel(T(ti), T(tf), W, H)
    cnt, _, layers = ov.rasterize_overlay(T(ti), T(tf), W, H)
    frame = T(_frame())
    with pytest.raises(ValueError, match="CUDA"):
        ov.overlay_composite_kernel(frame, cnt, layers,
                                    atlas_on(UIAtlas(), "cpu"))
    assert ov.overlay_raster_kernel.launches == 0
    assert ov.overlay_composite_kernel.launches == 0


# ---------------------------------------------------------------------------
# The composite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["busy", "glyphs", "random"])
def test_overlay_pass_matches_oracle_and_xla(case, atlases):
    ra, pa = atlases
    frame = _frame() if case != "glyphs" else np.full((H, W, 4), 32,
                                                      np.uint8)
    if case == "random":
        verts, sc = random_verts(4, n=60)
    else:
        if case == "busy":
            rdl, pdl = busy_draw_list(RefDrawList, ra), busy_draw_list(
                DrawList, pa)
        else:  # text at a non-integer scale: true bilinear filtering
            rdl, pdl = RefDrawList(W, H, ra), DrawList(W, H, pa)
            for dl in (rdl, pdl):
                dl.add_text(5, 5, "AXW", (1.0, 0.8, 0.2, 1.0), scale=2.5)
        verts, sc = pdl.build()
        rv, rs = rdl.build()
        np.testing.assert_array_equal(verts, rv)
        np.testing.assert_array_equal(sc, rs)
    ti, tf = ov.setup_overlay_triangles(verts, sc, W, H)
    got = ov.overlay_pass(T(frame), T(ti), T(tf),
                          atlas_on(pa, "cpu")).numpy()
    expect, count = composite_overlay_cpu(frame, verts, sc, pa.data,
                                          return_count=True)
    ref_expect = ref_oracle(frame, verts, sc, ra.data)
    np.testing.assert_array_equal(expect, ref_expect)
    assert got.shape == (H, W, 4) and got.dtype == np.uint8
    shallow = count <= ov.DEFAULT_K
    np.testing.assert_array_equal(got[shallow], expect[shallow])
    ref = np.asarray(rov.overlay_pass(
        jnp.asarray(frame), jnp.asarray(ti), jnp.asarray(tf),
        jnp.asarray(ra.packed_u32), "xla"))
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert (diff <= np.maximum(np.minimum(count, ov.DEFAULT_K), 1)[..., None]
            ).all(), diff.max()
    assert (got[..., 3] == 255).all()
    assert (count > 0).sum() > 50


def test_composite_plain_is_the_reference_formula(atlases):
    """composite_layers_plain on the reference's own layer planes equals
    the reference's composite_layers within 1 LSB a layer, and the
    bilinear sample within 2 ulp."""
    ra, pa = atlases
    ti, tf = busy_draw_list(DrawList, pa).setup()
    cnt, _, layers = rov.rasterize_overlay_xla(jnp.asarray(ti),
                                               jnp.asarray(tf), W, H)
    frame = _frame()
    ref = np.asarray(rov.composite_layers(jnp.asarray(frame), cnt, layers,
                                          jnp.asarray(ra.packed_u32)))
    K = ov.DEFAULT_K
    stacks = tuple(torch.from_numpy(np.stack(
        [np.asarray(layers[3 * k + i]) for k in range(K)]).view(
            np.float32 if i < 2 else np.int32)) for i in range(3))
    got = ov.composite_layers(T(frame), T(np.array(cnt)), stacks,
                              atlas_on(pa, "cpu")).numpy()
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert (diff <= np.maximum(np.asarray(cnt), 1)[..., None]).all()
    tex = ov.sample_atlas_bilinear(atlas_on(pa, "cpu"), stacks[0][0],
                                   stacks[1][0]).numpy()
    tex_ref = np.asarray(rov.sample_atlas_bilinear(
        jnp.asarray(ra.packed_u32), layers[0], layers[1]))
    np.testing.assert_allclose(tex, tex_ref, rtol=0, atol=2 ** -22)


def test_count_zero_round_trip_is_exact():
    """K8b writes a pixel with no live layer as the frame's word with alpha
    255, skipping the divide and the quantize: for every byte x,
    floor(clip(f32(x) / 255, 0, 1) * 255 + 0.5) == x in IEEE f32, each
    op rounded as the plain version rounds it."""
    x = np.arange(256, dtype=np.float32)
    d = x / np.float32(255.0)
    q = np.floor(np.clip(d, np.float32(0.0), np.float32(1.0))
                 * np.float32(255.0) + np.float32(0.5))
    assert d.dtype == q.dtype == np.float32
    np.testing.assert_array_equal(q.astype(np.int64), np.arange(256))
    # The plain version's own quantize of the same plane agrees.
    dt = torch.arange(256, dtype=torch.float32) / torch.tensor(255.0)
    qt = torch.floor(torch.clamp(dt, 0.0, 1.0) * 255.0 + 0.5)
    assert torch.equal(qt.to(torch.int64), torch.arange(256))


def test_byte_table_equals_the_plain_division():
    """K8b's 256-entry table, float32(i) / float32(255) rounded once,
    holds for every byte the bits of the plain version's dst, the frame
    divided by a 255.0 tensor."""
    table = np.arange(256, dtype=np.float32) / np.float32(255.0)
    frame = T(np.arange(256, dtype=np.uint8).repeat(4).reshape(16, 16, 4))
    dst = frame[..., :3].to(torch.float32) / torch.tensor(255.0,
                                                          dtype=torch.float32)
    want = table[frame[..., :3].numpy()]
    np.testing.assert_array_equal(dst.numpy().view(np.int32),
                                  want.view(np.int32))


def test_composite_plain_without_layers_is_the_frame():
    """composite_layers_plain with a count of 0 everywhere returns the
    frame with alpha 255, whatever the layer planes hold: K8b's copy
    path."""
    rng = np.random.default_rng(11)
    h, w, K = 33, 127, ov.DEFAULT_K
    frame = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    # Every byte in every channel.
    frame.reshape(-1, 4)[:256, :3] = np.arange(256, dtype=np.uint8)[:, None]
    cnt = torch.zeros((h, w), dtype=torch.int32)
    layers = (T(rng.uniform(-2, 2, (K, h, w)).astype(np.float32)),
              T(rng.uniform(-2, 2, (K, h, w)).astype(np.float32)),
              T(rng.integers(-2**31, 2**31, (K, h, w), dtype=np.int64)
                .astype(np.int32)))
    got = ov.composite_layers_plain(T(frame), cnt, layers,
                                    atlas_on(UIAtlas(), "cpu"), K).numpy()
    want = frame.copy()
    want[..., 3] = 255
    np.testing.assert_array_equal(got, want)


def test_composite_copies_misaligned_views():
    """K8b's wrapper copies a frame or count that does not start on a
    16-byte boundary (``composite_aligned``) before the launch: a frame
    view at a 4-byte offset is one.  The plain version takes the view
    too, and gives the contiguous copy's frame."""
    h, w, K = 33, 127, ov.DEFAULT_K
    rng = np.random.default_rng(12)
    buf = T(rng.integers(0, 256, (h * w * 4 + 4,), dtype=np.uint8))
    view = buf[4:].view(h, w, 4)
    cnt = torch.zeros((h, w), dtype=torch.int32)
    assert ov.composite_aligned(buf, cnt)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    assert not ov.composite_aligned(view, cnt)
    layers = (torch.zeros((K, h, w)), torch.zeros((K, h, w)),
              torch.zeros((K, h, w), dtype=torch.int32))
    cnt[::3, ::5] = 1
    layers[2][0] = -1  # opaque white layer
    atlas = atlas_on(UIAtlas(), "cpu")
    np.testing.assert_array_equal(
        ov.composite_layers_plain(view, cnt, layers, atlas, K).numpy(),
        ov.composite_layers_plain(view.clone(), cnt, layers, atlas,
                                  K).numpy())


def test_submission_order_and_scissor():
    """Red over blue differs from blue over red (the last draw
    dominates), and a full-screen draw under a scissor covers exactly the
    scissor rect."""
    atlas = UIAtlas()
    adev = atlas_on(atlas, "cpu")
    frame = T(np.zeros((H, W, 4), np.uint8))

    def run(dl):
        ti, tf = dl.setup()
        return ov.overlay_pass(frame, T(ti), T(tf), adev).numpy()

    red, blue = (1.0, 0.0, 0.0, 0.7), (0.0, 0.0, 1.0, 0.7)
    out = {}
    for name, order in (("rb", (red, blue)), ("br", (blue, red))):
        dl = DrawList(W, H, atlas)
        for color in order:
            dl.add_rect_filled(10, 10, 60, 40, color)
        out[name] = run(dl)
    assert out["rb"][20, 30, 2] > out["rb"][20, 30, 0]
    assert out["br"][20, 30, 0] > out["br"][20, 30, 2]

    dl = DrawList(W, H, atlas)
    dl.push_clip_rect(20, 16, 40, 32)
    dl.add_rect_filled(0, 0, W, H, (1.0, 1.0, 1.0, 1.0))
    dl.pop_clip_rect()
    lit = run(dl)[..., 0] > 0
    expect = np.zeros((H, W), bool)
    expect[16:32, 20:40] = True
    np.testing.assert_array_equal(lit, expect)


def test_quad_seam_and_winding():
    """A translucent quad's shared diagonal is covered once, and a
    reversed triangle draws the same pixels."""
    atlas = UIAtlas()
    dl = DrawList(W, H, atlas)
    dl.add_quad_filled((15, 7), (90, 13), (101, 53), (9, 47),
                       (0.5, 0.5, 0.5, 0.5))
    cnt, _, _ = ov.rasterize_overlay(*(T(a) for a in dl.setup()), W, H)
    assert int(cnt.max()) == 1

    frame = T(np.zeros((H, W, 4), np.uint8))

    def run(p0, p1, p2):
        d = DrawList(W, H, atlas)
        d.add_triangle_filled(p0, p1, p2, (0.9, 0.4, 0.1, 1.0))
        return ov.overlay_pass(frame, *(T(a) for a in d.setup()),
                               atlas_on(atlas, "cpu")).numpy()

    a = run((10, 10), (60, 12), (30, 50))
    b = run((10, 10), (30, 50), (60, 12))
    assert (a[..., 0] > 0).sum() > 100
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The slice: the golden frame
# ---------------------------------------------------------------------------


def test_overlay_golden_160x96():
    """The port's flat 160x96 frame plus OverlayUI.compose, as the
    reference's golden test composes it."""
    scene, md = make_test_scene()
    r = Renderer(RenderConfig(width=160, height=96, tri_align=64),
                 device="cpu")
    r.load_scene(scene, md)
    img, _ = r.render_and_read()
    lines = ["zrenderer-tpu golden", "nodes: Cube, Cube.002"]
    ui = OverlayUI(160, 96, device="cpu")
    out = ui.compose(img, lines)
    golden = read_png(OVERLAY_GOLDEN)
    assert out.shape == golden.shape
    diff = np.abs(out.astype(np.int32) - golden.astype(np.int32))
    assert diff.max() <= GOLDEN_MAX_LSB, diff.max()
    verts, sc = ui.draw_list(lines).build()
    oracle = composite_overlay_cpu(img, verts, sc, ui.atlas.data)
    np.testing.assert_array_equal(out, oracle)
    assert (out != img).any(-1).mean() > 0.1  # the panel landed
