"""The port's shadowed pipeline (zrenderer_tpu_torch: the depth-only raster
K2d, K3d, K4d and K6d, the tile-list G-buffer K6g, PCF, the shadowed
passes and Renderer) against the JAX package and the NumPy oracle on the
CPU.  The Pallas kernels in interpret mode are in
test_torch_shadow_interpret.py.

Contract:

* the plain depth kernels equal, by value, the depth plane of the plain
  flat kernels (K1, K3, K4, K6) and the oracle's depth on shared setup
  rows: the clipped soup, the duplicated soup (exact ties) and rows whose
  bbox clamps to empty at the bottom and right edges of a 128x128 shadow
  map and past them in the guard band.  Without a row id an exact tie
  keeps the first row visited, so the planes may differ in the sign of a
  zero z only (compared with ``==``, not bitwise);
* plain K2d in the padding rows 56-63 of a 256x64 target under geometry
  at 256x56 against the reference's K2d in interpret mode (coverage
  exact, depth within 2e-6: the interpret kernel's f32 chains are
  contracted into FMAs), and over a tile list of more than 900 rows
  against the oracle's depth;
* plain K6g equals plain K2g bit for bit on all 13 planes, and the XLA
  G-buffer under the G-buffer contract of test_torch_gbuffer.py;
* ``shadow_factor_pcf`` and ``shadow_factor_pcf_strided`` on the CPU give
  the reference's bits (taps 1 and 2, with and without the slope-scaled
  bias, stride 1 and 2): no tap flips here.  On the card CUDA's sqrt and
  divide may flip a tap (chip_smoke.py counts them);
* whole shadowed frames: the 160x96 frame equals
  ``tests/goldens/shadowed_160x96.png`` bit for bit (0 LSB, no tap flip);
  against the XLA Renderer at shadow_size 128, with a node moved so the
  light frustum is refitted, coverage is exact, depth and the shadow map
  are within 2e-6, u8 within 2 LSB on every pixel but at most
  MAX_FLIPPED_PX where one tap of the 3x3 PCF flips, and
  ``render_animation`` digests equal the frames' u8 sums and, less the
  flipped pixels' differences, the reference's sum within rtol 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gbuffer import assert_gbuffer_close, lit_setup, plain_gbuffer
from test_torch_raster import (
    CASES,
    PAD_GEOM_H,
    PADDED,
    _padded_setup,
    _setup,
    longest_list,
    one_tile_soup,
)
from zrenderer_tpu.engine.config import RenderConfig as JaxConfig
from zrenderer_tpu.engine.renderer import Renderer as JaxRenderer
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.ops import raster_xla as rx
from zrenderer_tpu.ops import shading as jsh
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.procedural import make_test_scene as jax_test_scene
from zrenderer_tpu.scene.procedural import make_triangle_soup
from zrenderer_tpu.utils.png import read_png
from zrenderer_tpu_torch.app.main import main as app_main
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops import shading
from zrenderer_tpu_torch.scene.procedural import make_test_scene

# The plain kernels run thousands of small torch ops.  Under xdist every
# worker imports this module; one intra-op thread a worker keeps six
# workers from oversubscribing the cores, which slowed such ops 10-100x.
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TEST_SCENE = os.path.join(ROOT, "content", "scenes", "test_scene")
SHADOWED_GOLDEN = os.path.join(ROOT, "tests", "goldens",
                               "shadowed_160x96.png")
EDGE = 128  # the edge-clamped case's square shadow-map size

T = torch.from_numpy


def edge_setup():
    """Setup rows of a wide soup on a 128x128 target: some rows clamp to
    an empty bbox at the bottom and right edges, some past them in the
    guard band (imin or jmin beyond the last tile)."""
    scene, md = make_triangle_soup(600, seed=3, extent=6.0)
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, EDGE, EDGE)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                      EDGE, EDGE)
    return ti, tf, EDGE, EDGE


def depth_setup(case):
    return edge_setup() if case == "edge_clamped_128" else _setup(case)


DEPTH_CASES = list(CASES) + ["edge_clamped_128"]

# kind -> the port's depth wrapper (plain version on CPU tensors)
DEPTH = {
    "k2d": tr.rasterize_depth_small,
    "k3d": tr.rasterize_depth,
    "k4d": tr.rasterize_depth_binned_hbm,
    "k4d_budget": lambda ti, tf, w, h: tr.rasterize_depth_binned_hbm(
        ti, tf, w, h, cap=4, pair_budget=100),
    "k5_depth": tr.rasterize_depth_hbm,
    "k6d": tr.rasterize_depth_binned,
    "k6d_cap2": lambda ti, tf, w, h: tr.rasterize_depth_binned(ti, tf, w, h,
                                                               cap=2),
}
FLAT = {"k1": tr.rasterize_setup_small, "k3": tr.rasterize_setup,
        "k4": tr.rasterize_setup_binned_hbm, "k6": tr.rasterize_setup_binned}


def plain_depth(kind, ti, tf, w, h):
    depth = DEPTH[kind](T(ti), T(tf), w, h)
    assert depth.dtype == torch.float32 and tuple(depth.shape) == (h, w)
    return depth.numpy()


@pytest.mark.parametrize("kind", list(DEPTH))
@pytest.mark.parametrize("case", DEPTH_CASES)
def test_plain_depth_equals_flat_planes_and_oracle(case, kind):
    ti, tf, w, h = depth_setup(case)
    depth = plain_depth(kind, ti, tf, w, h)
    assert (depth < 1.0).mean() > 0.02
    for flat in FLAT.values():
        np.testing.assert_array_equal(depth, flat(T(ti), T(tf), w, h)[1])
    np.testing.assert_array_equal(depth,
                                  raster_cpu.rasterize_setup(ti, tf, w, h)[1])


@pytest.mark.parametrize("name", list(PADDED))
def test_depth_padding_rows_match_pallas_interpret(name):
    """Rows 56-63 of the 256x64 map, below geometry at 256x56: plain K2d
    draws the pixels the reference's whole-tile evaluation draws."""
    ti, tf, w, h = _padded_setup(name)
    depth = plain_depth("k2d", ti, tf, w, h)[PAD_GEOM_H:]
    ref = np.asarray(rp.rasterize_depth_pallas_small(
        jnp.asarray(ti), jnp.asarray(tf), w, h,
        interpret=True))[PAD_GEOM_H:]
    assert (depth < 1.0).sum() > 0
    np.testing.assert_array_equal(depth < 1.0, ref < 1.0)
    np.testing.assert_allclose(depth, ref, rtol=0, atol=2e-6)


def test_depth_long_tile_list_matches_oracle():
    """A tile list of more than 900 rows (K2d's staging: many chunks a
    block): plain K2d against the oracle's depth and plain K1's."""
    ti, tf = one_tile_soup(seed=1)
    assert longest_list(ti, tf, 128, 32) >= 900
    depth = plain_depth("k2d", ti, tf, 128, 32)
    assert (depth < 1.0).mean() > 0.5
    np.testing.assert_array_equal(
        depth, raster_cpu.rasterize_setup(ti, tf, 128, 32)[1])
    np.testing.assert_array_equal(
        depth, FLAT["k1"](T(ti), T(tf), 128, 32)[1])


def test_edge_clamped_rows_list_nothing_outside_the_map():
    """At a tile-aligned size a row clamped to empty below or right of the
    map has a footprint of 0 or less: no pair key at or above num_tiles is
    made, the prepares list what the reference's list, and K3d, K4d and
    K6d give one plane."""
    ti, tf, w, h = edge_setup()
    n_head = g.head_count(ti.shape[0])
    head = ti[:n_head]
    valid = head[:, g.I_VALID] > 0
    below = valid & (head[:, g.I_IMIN] > head[:, g.I_IMAX])
    right = valid & (head[:, g.I_JMIN] > head[:, g.I_JMAX])
    assert (below & (head[:, g.I_IMIN] == h)).any()
    assert (below & (head[:, g.I_IMIN] > h)).any()  # in the guard band
    assert (right & (head[:, g.I_JMIN] == w)).any()
    assert (right & (head[:, g.I_JMIN] > w)).any()

    num_tiles = (w // tr.TILE_W) * (h // tr.TILE_H)
    v, tj0, tj1, ty0, ty1 = tr._tile_span(T(head))
    ntx = tj1 - tj0 + 1
    foot = ntx * (ty1 - ty0 + 1)
    # (A row empty inside the map, e.g. imin 40 > imax 39, keeps a
    # one-tile footprint and draws nothing there.)
    clamped = T((below & (head[:, g.I_IMIN] >= h))
                | (right & (head[:, g.I_JMIN] >= w)))
    assert (foot[clamped] <= 0).all()
    keys = tr._pair_keys(v, foot, ntx, ty0, tj0, 8, w // tr.TILE_W,
                         num_tiles)
    assert ((keys >= 0) & (keys <= num_tiles)).all()  # sentinel or a tile

    ours6 = tr.prepare_binned_inputs(T(ti), T(tf), w, h)
    ref6 = rp.prepare_binned_inputs(jnp.asarray(ti), jnp.asarray(tf), w, h)
    np.testing.assert_array_equal(ours6[0].numpy(), np.asarray(ref6[0]))
    ours4 = tr.prepare_binned_hbm_inputs(T(ti), T(tf), w, h)
    ref4 = rp.prepare_binned_hbm_inputs(jnp.asarray(ti), jnp.asarray(tf), w,
                                        h)
    np.testing.assert_array_equal(ours4[0].numpy(), np.asarray(ref4[0]))
    n = int(ours6[0][-1])
    assert n > 0 and int(ours4[0][-1]) == n
    assert (ours6[1][:n] < n_head).all()

    d3 = plain_depth("k3d", ti, tf, w, h)
    for kind in ("k4d", "k6d"):
        np.testing.assert_array_equal(plain_depth(kind, ti, tf, w, h), d3)


@pytest.mark.parametrize("case", ["clipped_soup_384x128", "tie_soup_256x128",
                                  "test_scene_256x64"])
def test_plain_k6g_equals_k2g_and_xla(case):
    ti, tf, w, h = lit_setup(case, seed=5)
    ours = plain_gbuffer("k6g", ti, tf, w, h)
    for a, b in zip(ours, plain_gbuffer("k2g", ti, tf, w, h)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    ref = rx.rasterize_gbuffer_xla(jnp.asarray(ti), jnp.asarray(tf), w, h)
    assert_gbuffer_close(ours, ref[0], ref[1:])


def _expected_depth_route(binning, rows):
    """``render_depth_pallas``'s branches (raster_pallas.py:937-964), each
    mapped to the port's wrapper of the same kernel."""
    big = rows > rp.VMEM_RESIDENT_MAX_TRIS
    if rp._use_tile_lists(binning, rows):
        return (tr.rasterize_depth_binned_hbm if big
                else tr.rasterize_depth_binned)
    if big:
        return (tr.rasterize_depth_hbm if binning == "hierarchy"
                else tr.rasterize_depth_binned_hbm)
    if rp._use_small_bins(binning, rows):
        return tr.rasterize_depth_small
    return tr.rasterize_depth


@pytest.mark.parametrize("binning", list(tr.BINNINGS))
@pytest.mark.parametrize("tris", [120, 1024, 1025, 26000, 40000, 1000000])
def test_depth_dispatch_routes_like_render_depth_pallas(tris, binning):
    rows = g.capped_rows(tris)
    assert tr.select_depth_raster(binning, rows) is _expected_depth_route(
        binning, rows)


def test_depth_dispatch_and_map_size_refuse_bad_input():
    with pytest.raises(ValueError, match="unknown binning"):
        tr.select_depth_raster("dist", 256)
    ti, tf, w, h = edge_setup()
    for size in (96, 160, 0):
        with pytest.raises(ValueError, match="multiple"):
            tr.render_depth(None, None, None, size)
    with pytest.raises(ValueError, match="coarse"):
        tr.depth_binned_plain(*[None] * 7, object(), w, h)


def test_depth_kernels_refuse_cpu_tensors():
    """The depth and K6g launchers never fall back to the plain versions."""
    ti, tf, w, h = edge_setup()
    ti, tf = T(ti), T(tf)
    kernels = tr.DEPTH_KERNELS + (tr.gbuffer_lists_kernel,)
    before = [k.launches for k in kernels]
    lists = tr.prepare_binned_inputs(ti, tf, w, h)
    calls = [
        lambda: tr.depth_small_kernel(*tr.prepare_binned_small(ti, tf, w, h),
                                      w, h),
        lambda: tr.depth_hier_kernel(*tr.prepare_raster_inputs(ti, tf), w, h),
        lambda: tr.depth_binned_kernel(
            *tr.prepare_binned_hbm_inputs(ti, tf, w, h), w, h),
        lambda: tr.depth_lists_kernel(*lists, w, h),
        lambda: tr.gbuffer_lists_kernel(*lists, w, h),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="coarse"):
        tr.depth_binned_kernel(*tr.prepare_binned_hbm_inputs(
            ti, tf, w, h, coarse_cap=8), w, h)
    tr.rasterize_depth_small(ti, tf, w, h)  # CPU: plain version, no launch
    assert [k.launches for k in kernels] == before


def _pcf_inputs(seed=0, shape=(48, 64), size=64):
    """A shadow map of a tilted plane with a box in front of it, world
    points on the plane and on the box (some outside the light frustum),
    an orthographic light matrix, unit normals and a light direction."""
    rng = np.random.default_rng(seed)
    m = np.eye(4, dtype=np.float32)
    m[2, 2], m[3, 2] = -0.2, 0.5  # z_ndc = 0.5 - 0.2 * z
    y, x = np.mgrid[0:size, 0:size]
    plane = 0.55 + 0.1 * (x / size) - 0.05 * (y / size)
    plane[20:40, 24:44] = 0.35  # an occluder
    sd = plane.astype(np.float32)
    h, w = shape
    xs = rng.uniform(-1.05, 1.05, (h, w)).astype(np.float32)
    ys = rng.uniform(-1.05, 1.05, (h, w)).astype(np.float32)
    # z_ndc on the plane under each point, a little in front or behind.
    u = np.clip(((xs + 1) * size / 2).astype(int), 0, size - 1)
    v = np.clip(((1 - ys) * size / 2).astype(int), 0, size - 1)
    z_ndc = (0.55 + 0.1 * (u / size) - 0.05 * (v / size)
             + rng.normal(0, 0.004, (h, w)))
    zs = ((0.5 - z_ndc) / 0.2).astype(np.float32)
    world = np.stack([xs, ys, zs], axis=-1).astype(np.float32)
    nrm = rng.standard_normal((h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    light_dir = np.float32([-0.5, -1.0, -0.35])
    light_dir /= np.linalg.norm(light_dir)
    return sd, world, m, nrm.astype(np.float32), light_dir


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("slope", [False, True])
@pytest.mark.parametrize("taps", [1, 2])
def test_pcf_matches_reference(taps, slope, stride):
    sd, world, m, nrm, light_dir = _pcf_inputs(seed=taps)
    kw = dict(bias=2e-3, taps=taps)
    ref_kw = dict(kw)
    if slope:
        kw.update(normal=T(nrm), light_dir=T(light_dir))
        ref_kw.update(normal=jnp.asarray(nrm), light_dir=light_dir)
    ours = shading.shadow_factor_pcf_strided(T(sd), T(world), T(m),
                                             stride=stride, **kw).numpy()
    ref = np.asarray(jsh.shadow_factor_pcf_strided(
        jnp.asarray(sd), jnp.asarray(world), jnp.asarray(m), stride=stride,
        **ref_kw))
    assert ours.dtype == np.float32 and ours.shape == world.shape[:2]
    partial = (ours > 0) & (ours < 1)
    assert partial.mean() > 0.05 and (ours == 0).any() and (ours == 1).any()
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_pcf_stride_must_be_1_or_2():
    sd, world, m, _, _ = _pcf_inputs()
    with pytest.raises(ValueError, match="1 or 2"):
        shading.shadow_factor_pcf_strided(T(sd), T(world), T(m), stride=3)


def _shadowed(w, h, device="cpu", **kw):
    r = Renderer(RenderConfig(width=w, height=h, pipeline="shadowed",
                              tri_align=64, **kw), device=device)
    r.load_scene(*make_test_scene())
    return r


def test_shadowed_frame_matches_golden():
    """The procedural test scene at 160x96 with the default 1024^2 map
    (K2d, then K2g) against the stored golden, which the reference's
    Pallas renderer wrote."""
    r = _shadowed(160, 96)
    img, depth = r.render_and_read()
    assert r._shadow_map.shape == (1024, 1024)
    assert (r._shadow_map < 1.0).float().mean() > 0.05
    assert (depth < 1.0).mean() > 0.15
    np.testing.assert_array_equal(img, read_png(SHADOWED_GOLDEN))


# Pixels of the 160x96 frame at shadow_size 128 where one PCF tap flips
# against the XLA Renderer: 7 of 7249 covered (0.1%, up to 25 LSB) in the
# moved frame, 4 of 7777 in the static one.  XLA:CPU's depth and shadow
# map differ from the port's by up to 1 ulp (1.2e-7, 6e-8), which moves a
# D16 texel or a threshold across an integer.  The limit is 0.2% of the
# covered pixels.
MAX_FLIPPED_PX = 14


def test_shadowed_renderer_matches_jax_xla():
    """Frame, shadow map and animation digest against the XLA Renderer at
    shadow_size 128 with a moved node (the light frustum refitted to the
    moved bounds; the static frame is held to the golden above): u8
    within 2 LSB except on at most MAX_FLIPPED_PX pixels, each off by one
    tap.  One reference frame: the XLA Renderer compiles ~100 s a frame
    on the CPU."""
    w, h = 160, 96
    r = _shadowed(w, h, shadow_size=128)
    ref = JaxRenderer(JaxConfig(width=w, height=h, pipeline="shadowed",
                                backend="xla", tri_align=64,
                                shadow_size=128))
    ref.load_scene(*jax_test_scene())
    moved = r.flat.node_to_world.copy()
    moved[1, 3, :3] += np.float32([0.3, 0.2, -0.1])
    seq = np.stack([r.flat.node_to_world, moved])
    digests, (img_last, _) = r.render_animation(transforms_seq=seq)
    static, _ = r.render_and_read()
    assert digests[0].item() == static.astype(np.int64).sum()
    img, depth = r.render_and_read(transforms=moved)
    ref_img, ref_depth = ref.render_and_read(transforms=moved)
    ref_img, ref_depth = np.asarray(ref_img), np.asarray(ref_depth)
    np.testing.assert_array_equal(depth < 1.0, ref_depth < 1.0)
    np.testing.assert_allclose(depth, ref_depth, rtol=0, atol=2e-6)
    np.testing.assert_allclose(r._shadow_map.numpy(),
                               np.asarray(ref._shadow_map), rtol=0, atol=2e-6)
    assert (r._shadow_map < 1.0).float().mean() > 0.05
    diff = np.abs(img.astype(np.int32) - ref_img.astype(np.int32)).max(axis=-1)
    flipped = diff > 2  # a whole tap of 9: up to 255/9 LSB
    assert flipped.sum() <= MAX_FLIPPED_PX and diff.max() <= 29
    # The digest is the frame's exact u8 sum; against the reference's f32
    # sum within rtol 1e-5 once the flipped pixels are counted.
    assert digests[1].item() == img.astype(np.int64).sum()
    flips = (img.astype(np.int64) - ref_img)[flipped].sum()
    assert digests[1].item() - flips == pytest.approx(
        float(jnp.sum(jnp.asarray(ref_img).astype(jnp.float32))), rel=1e-5)
    np.testing.assert_array_equal(img_last.numpy(), img)


def test_light_view_proj_matches_reference():
    """The light frustum from the per-draw corners, static and moved, and
    its cache (reset by set_environment)."""
    r = _shadowed(160, 96)
    ref = JaxRenderer(JaxConfig(width=160, height=96, pipeline="shadowed",
                                backend="xla", tri_align=64))
    ref.load_scene(*jax_test_scene())
    np.testing.assert_array_equal(r._draw_corners, ref._draw_corners)
    moved = r.flat.node_to_world.copy()
    moved[0, 3, :3] += np.float32([1.5, 0.0, -0.5])
    for light_dir in ((-0.5, -1.0, -0.35), (0.1, -1.0, 0.05)):
        r.set_environment(light_dir=light_dir)
        ref.set_environment(light_dir=light_dir)
        np.testing.assert_array_equal(r.light_dir, ref.light_dir)
        for transforms in (None, moved):
            ours = r._light_view_proj(transforms)
            np.testing.assert_array_equal(
                ours.view(np.int32),
                ref._light_view_proj(transforms).view(np.int32))
        assert r._light_view_proj() is r._light_view_proj()


def test_app_renders_shadowed_png(tmp_path):
    rc = app_main(["--scene", TEST_SCENE, "--width", "128", "--height", "64",
                   "--frames", "1", "--out", str(tmp_path), "--device", "cpu",
                   "--pipeline", "shadowed"])
    assert rc == 0
    img = read_png(str(tmp_path / "frame_0000.png"))
    assert img.shape[:2] == (64, 128)
    assert (img[..., :3].astype(np.int32).sum(-1) > 0).mean() > 0.05


@pytest.mark.parametrize("pipeline", ["lit", "shadowed"])
def test_tile_lists_below_the_row_bound_runs_k6g(pipeline):
    """binning='tile_lists' at a few hundred rows takes K6g (and K6d for
    the shadow map) and gives auto's frame (K2g, K2d)."""
    frames = {}
    for binning in ("auto", "tile_lists"):
        r = Renderer(RenderConfig(width=128, height=64, pipeline=pipeline,
                                  binning=binning, shadow_size=256,
                                  tri_align=64), device="cpu")
        r.load_scene(*make_test_scene())
        frames[binning] = r.render_and_read()
    rows = g.capped_rows(r.flat.num_triangles)
    assert tr.select_gbuffer_raster("tile_lists", rows) is (
        tr.rasterize_gbuffer_binned)
    img, depth = frames["auto"]
    assert (depth < 1.0).mean() > 0.15
    np.testing.assert_array_equal(frames["tile_lists"][0], img)
    np.testing.assert_array_equal(frames["tile_lists"][1], depth)
