"""The port's flat raster (zrenderer_tpu_torch/ops/raster.py) against
zrenderer_tpu/ops/raster_pallas.py and the NumPy oracle, given shared
setup rows (the NumPy geometry stage).

Contracts (docs/RASTER_SPEC.md §5):
* prepares: exact against the JAX functions;
* plain K1/K3 vs the Pallas kernels in interpret mode: coverage exact,
  u8 within 1 LSB, depth within 2e-6 (XLA:CPU contracts the interpret
  kernels' f32 chains into FMAs; eager torch does not);
* plain K1/K3 vs ``raster_cpu.rasterize_setup``: coverage and depth exact,
  u8 within 1 LSB (the oracle divides where the kernels multiply by 1/den);
* plain K1 equals plain K3 bit for bit ((z, id) tie-break == sequential
  strict-less);
* the cases the sub-tile K1 and K2d (csrc/raster_small.cu) could break:
  the padding rows 56-63 of a 256x64 target under geometry at 256x56
  (against interpret mode: coverage exact, colour bits equal, depth
  within 2e-6, since the interpret kernels' f32 chains are contracted
  into FMAs), a tile list of more than 900 rows (against the oracle), and
  the premise of their skips: every pixel a listed or fan row covers lies
  in that row's vertices' pixel bbox.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.mesh import V_COLOR, MeshData
from zrenderer_tpu.scene.procedural import make_triangle_soup
from zrenderer_tpu.scene.scene import Scene
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.scene.procedural import one_tile_rows

SCENE_DIR = os.path.join(os.path.dirname(__file__), "..", "content",
                         "scenes", "test_scene")


def _content_scene():
    return (Scene.load(os.path.join(SCENE_DIR, "scene.bin")),
            MeshData.load(os.path.join(SCENE_DIR, "meshes.bin")))


def _clipped_soup():
    scene, md = make_triangle_soup(300, seed=7, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(40, 60):
        v[3 * t, 2] += 15.0
    return scene, md


def _tie_soup():
    """Second half repeats the first with other colors: exact depth ties."""
    scene, md = make_triangle_soup(60, seed=3, extent=2.0)
    v = md.vertex_data.reshape(-1, 16)
    v2 = v.copy()
    v2[:, V_COLOR] = 1.0 - v2[:, V_COLOR]
    v2[:, V_COLOR.stop - 1] = 1.0
    md2 = MeshData()
    md2.append_mesh(np.concatenate([v, v2]),
                    np.arange(2 * len(v), dtype=np.uint32))
    return scene, md2


# name -> (scene factory, width, height, tri_align); sizes are tile multiples.
CASES = {
    "test_scene_256x64": (_content_scene, 256, 64, 256),
    "clipped_soup_384x128": (_clipped_soup, 384, 128, 64),
    "tie_soup_256x128": (_tie_soup, 256, 128, 64),
}


def _setup(case):
    build, w, h, tri_align = CASES[case]
    scene, md = build()
    flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                      w, h)
    return ti, tf, w, h


def _plain(kind, ti, tf, w, h):
    fn = tr.rasterize_setup_small if kind == "k1" else tr.rasterize_setup
    color, depth = fn(torch.from_numpy(ti), torch.from_numpy(tf), w, h)
    assert color.dtype == torch.int32 and depth.dtype == torch.float32
    return color.numpy(), depth.numpy()


# Scenes whose geometry at PAD_SIZE[0] x PAD_GEOM_H draws into the padding
# rows of the PAD_SIZE target (the reference's whole-tile evaluation keeps
# the pixels below the clamped bboxes there).
PADDED = {
    "clipped_soup": _clipped_soup,
    "edge_soup": lambda: make_triangle_soup(600, seed=3, extent=6.0),
}
PAD_SIZE, PAD_GEOM_H = (256, 64), 56


def _padded_setup(name):
    scene, md = PADDED[name]()
    w = PAD_SIZE[0]
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, PAD_GEOM_H)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                      w, PAD_GEOM_H)
    return ti, tf, *PAD_SIZE


def one_tile_soup(n=1000, w=128, h=32, seed=0):
    """``one_tile_rows`` as numpy (tri_i32, tri_f32)."""
    ti, tf = one_tile_rows(n, w, h, seed)
    return ti.numpy(), tf.numpy()


def longest_list(ti, tf, w, h):
    counts = tr.prepare_binned_small(torch.from_numpy(ti),
                                     torch.from_numpy(tf), w, h)[0]
    return int(counts.max())


def _u8(packed_i32):
    return tr.unpack_rgba8(torch.tensor(packed_i32)).numpy()


def _bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_binned_small_matches_jax(case):
    ti, tf, w, h = _setup(case)
    ours = tr.prepare_binned_small(torch.from_numpy(ti), torch.from_numpy(tf),
                                   w, h)
    ref = rp.prepare_binned_small(jnp.asarray(ti), jnp.asarray(tf), w, h)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == tuple(b.shape)
        _bits(a.numpy(), b)


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_raster_inputs_matches_jax(case):
    ti, tf, _, _ = _setup(case)
    ours = tr.prepare_raster_inputs(torch.from_numpy(ti),
                                    torch.from_numpy(tf))
    ref = rp.prepare_raster_inputs(jnp.asarray(ti), jnp.asarray(tf))
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == tuple(b.shape)
        _bits(a.numpy(), b)


PALLAS = {"k1": rp.rasterize_setup_pallas_small,
          "k3": rp.rasterize_setup_pallas}


@pytest.mark.parametrize("kind", ["k1", "k3"])
@pytest.mark.parametrize("case", ["test_scene_256x64", "clipped_soup_384x128"])
def test_plain_matches_pallas_interpret(case, kind):
    ti, tf, w, h = _setup(case)
    color, depth = _plain(kind, ti, tf, w, h)
    ref_c, ref_d = PALLAS[kind](jnp.asarray(ti), jnp.asarray(tf), w, h,
                                interpret=True)
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)
    assert (depth < 1.0).mean() > 0.1
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    np.testing.assert_allclose(depth, ref_d, rtol=0, atol=2e-6)
    ref_u8 = _u8(ref_c.view(np.int32))
    assert np.abs(_u8(color).astype(np.int32) - ref_u8).max() <= 1


@pytest.mark.parametrize("kind", ["k1", "k3"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_oracle(case, kind):
    ti, tf, w, h = _setup(case)
    color, depth = _plain(kind, ti, tf, w, h)
    rgba, ref_d = raster_cpu.rasterize_setup(ti, tf, w, h)
    _bits(depth, ref_d)
    assert np.abs(_u8(color).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("case", list(CASES))
def test_plain_k1_equals_plain_k3(case):
    ti, tf, w, h = _setup(case)
    c1, d1 = _plain("k1", ti, tf, w, h)
    c3, d3 = _plain("k3", ti, tf, w, h)
    np.testing.assert_array_equal(c1, c3)
    _bits(d1, d3)


def test_ties_resolve_to_the_first_submitted_row():
    """With every triangle duplicated (other colors), the frame equals
    the frame of the originals alone."""
    ti, tf, w, h = _setup("tie_soup_256x128")
    scene, md = make_triangle_soup(60, seed=3, extent=2.0)
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti1, tf1 = g.geometry_pipeline_cols(np, *flat.expand_corner_cols(), mats,
                                        w, h)
    for kind in ("k1", "k3"):
        c_dup, d_dup = _plain(kind, ti, tf, w, h)
        c_one, d_one = _plain(kind, ti1, tf1, w, h)
        np.testing.assert_array_equal(c_dup, c_one)
        _bits(d_dup, d_one)


def _expected_route(binning, rows):
    """``render_frame_pallas``'s branches (raster_pallas.py:3060-3086),
    each mapped to the port's wrapper of the same kernel."""
    big = rows > rp.VMEM_RESIDENT_MAX_TRIS
    if rp._use_tile_lists(binning, rows):
        return (tr.rasterize_setup_binned_hbm_coarse if big
                else tr.rasterize_setup_binned)
    if big:
        return (tr.rasterize_setup_hbm if binning == "hierarchy"
                else tr.rasterize_setup_binned_hbm)
    if rp._use_small_bins(binning, rows):
        return tr.rasterize_setup_small
    return tr.rasterize_setup


@pytest.mark.parametrize("binning", list(tr.BINNINGS))
@pytest.mark.parametrize("tris", [120, 256, 1024, 1025, 4096, 20000, 26000,
                                  40000, 1000000])
def test_dispatch_routes_like_render_frame_pallas(tris, binning):
    rows = g.capped_rows(tris)
    assert tr.select_raster(binning, rows) is _expected_route(binning, rows)


def test_dispatch_raises_for_unported_kernels():
    """Every binning of the flat dispatch routes at every size (the
    26 000-triangle frame sits just below the row bound, 40 000 above);
    only other names raise, among them "dist", the multi-device binning
    whose kernels (K9) are not ported."""
    assert g.capped_rows(26000) == 32144 <= tr.MAX_RESIDENT_ROWS
    assert g.capped_rows(40000) > tr.MAX_RESIDENT_ROWS
    assert (tr.select_raster("tile_lists", g.capped_rows(256))
            is tr.rasterize_setup_binned)
    assert (tr.select_raster("tile_lists", g.capped_rows(40000))
            is tr.rasterize_setup_binned_hbm_coarse)
    assert (tr.select_raster("small", g.capped_rows(40000))
            is tr.rasterize_setup_binned_hbm)
    for name in ("dist", "xla", "", "Auto"):
        with pytest.raises(ValueError, match="unknown binning"):
            tr.select_raster(name, g.capped_rows(256))


def test_constants_match_reference():
    assert (tr.TILE_H, tr.TILE_W) == (32, 128) == (rp.TILE_H, rp.TILE_W)
    assert tr.SMALL_BIN_MAX_ROWS == rp.SMALL_BIN_MAX_ROWS


def test_kernels_refuse_cpu_tensors():
    """The kernel launchers never fall back to the plain versions."""
    ti, tf, w, h = _setup("test_scene_256x64")
    ti, tf = torch.from_numpy(ti), torch.from_numpy(tf)
    before = (tr.raster_small_kernel.launches, tr.raster_hier_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tr.raster_small_kernel(*tr.prepare_binned_small(ti, tf, w, h), w, h)
    with pytest.raises(ValueError, match="CUDA"):
        tr.raster_hier_kernel(*tr.prepare_raster_inputs(ti, tf), w, h)
    tr.rasterize_setup_small(ti, tf, w, h)  # CPU: plain version, no launch
    assert (tr.raster_small_kernel.launches,
            tr.raster_hier_kernel.launches) == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    assert not list(tmp_path.rglob("*.so"))


def test_raster_rejects_unaligned_frames():
    ti, tf, _, _ = _setup("test_scene_256x64")
    with pytest.raises(ValueError):
        tr.rasterize_setup(torch.from_numpy(ti), torch.from_numpy(tf), 250, 64)


def test_unpack_rgba8():
    packed = torch.tensor(np.array([[0x04030201, 0xFF000000]],
                                   np.uint32).view(np.int32))
    u8 = tr.unpack_rgba8(packed).numpy()
    np.testing.assert_array_equal(u8[0, 0], [1, 2, 3, 4])
    np.testing.assert_array_equal(u8[0, 1], [0, 0, 0, 255])
    ref = np.asarray(rp.unpack_rgba8(jnp.asarray(packed.numpy().view(np.uint32))))
    np.testing.assert_array_equal(u8, ref)


@pytest.mark.parametrize("name", list(PADDED))
def test_padding_rows_match_pallas_interpret(name):
    """Rows 56-63 of the 256x64 target, below geometry at 256x56: plain
    K1 draws the pixels the reference's whole-tile evaluation draws."""
    ti, tf, w, h = _padded_setup(name)
    color, depth = _plain("k1", ti, tf, w, h)
    ref_c, ref_d = rp.rasterize_setup_pallas_small(
        jnp.asarray(ti), jnp.asarray(tf), w, h, interpret=True)
    pad = slice(PAD_GEOM_H, h)
    ref_c = np.asarray(ref_c).view(np.int32)[pad]
    ref_d = np.asarray(ref_d)[pad]
    assert (depth[pad] < 1.0).sum() > 0
    np.testing.assert_array_equal(depth[pad] < 1.0, ref_d < 1.0)
    np.testing.assert_array_equal(color[pad], ref_c)
    np.testing.assert_allclose(depth[pad], ref_d, rtol=0, atol=2e-6)


def test_long_tile_list_matches_oracle():
    """A tile list of more than 900 rows (K1's staging: many chunks a
    block): plain K1 against the oracle."""
    ti, tf = one_tile_soup()
    assert longest_list(ti, tf, 128, 32) >= 900
    color, depth = _plain("k1", ti, tf, 128, 32)
    rgba, ref_d = raster_cpu.rasterize_setup(ti, tf, 128, 32)
    assert (depth < 1.0).mean() > 0.5
    _bits(depth, ref_d)
    assert np.abs(_u8(color).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1


def _covered_outside_vertex_bbox(ti, tf, w, h):
    """Over the (tile, row) pairs K1 and K2d evaluate (each listed row in
    its tile; each hierarchy row in the tiles its clamped bbox meets), the
    pixels a row covers and those of them outside its vertices' pixel bbox
    (``tr.vertex_bbox``, unclamped).  Returns (pairs, fan pairs, covered,
    outside)."""
    counts, lists, _, _, hier, _ = tr.prepare_binned_small(
        torch.from_numpy(ti), torch.from_numpy(tf), w, h)
    tiles_x = w // tr.TILE_W
    l2 = lists.reshape(counts.numel(), -1)
    live = torch.arange(l2.shape[1])[None, :] < counts[:, None]
    tile_h, row_h = torch.nonzero(tr._tile_hits(
        hier[:, [tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX]],
        h // tr.TILE_H, tiles_x)).unbind(1)
    tile = torch.cat([torch.nonzero(live)[:, 0], tile_h])
    row = torch.cat([l2[live].long(), row_h])
    covered = outside = 0
    for part in torch.split(torch.arange(tile.numel()), 256):
        t, r = tile[part], hier[row[part]].long()
        box = tr.vertex_bbox(hier[row[part]]).long()
        iy = ((t // tiles_x) * tr.TILE_H)[:, None, None] + torch.arange(
            tr.TILE_H)[None, :, None]
        ix = ((t % tiles_x) * tr.TILE_W)[:, None, None] + torch.arange(
            tr.TILE_W)[None, None, :]
        py, px = iy * tg.SUBPIXEL + tg.SUBPIXEL // 2, ix * tg.SUBPIXEL + (
            tg.SUBPIXEL // 2)

        def c(k):
            return r[:, k, None, None]

        def edge(dx, dy, x, y):  # int32 wrap, as the kernels' edge_fn
            v = c(dx) * (py - c(y)) - c(dy) * (px - c(x))
            return (v + 2**31) % 2**32 - 2**31

        cov = ((edge(tg.I_DX0, tg.I_DY0, tg.I_X1, tg.I_Y1) >= c(tg.I_BIAS0))
               & (edge(tg.I_DX1, tg.I_DY1, tg.I_X2, tg.I_Y2)
                  >= c(tg.I_BIAS1))
               & (edge(tg.I_DX2, tg.I_DY2, tg.I_X0, tg.I_Y0)
                  >= c(tg.I_BIAS2)))
        inside = ((ix >= box[:, 0, None, None]) & (ix <= box[:, 1, None, None])
                  & (iy >= box[:, 2, None, None])
                  & (iy <= box[:, 3, None, None]))
        covered += int(cov.sum())
        outside += int((cov & ~inside).sum())
    return tile.numel(), row_h.numel(), covered, outside


@pytest.mark.parametrize("case", list(CASES) + [f"padded_{n}" for n in PADDED]
                         + ["one_tile_soup"])
def test_covered_pixels_lie_in_the_vertex_bbox(case):
    """The premise of the sub-tile kernels' skips: no listed or fan row
    covers a pixel outside its vertices' pixel bbox, in the padding rows
    too."""
    if case.startswith("padded_"):
        ti, tf, w, h = _padded_setup(case[len("padded_"):])
    elif case == "one_tile_soup":
        (ti, tf), w, h = one_tile_soup(), 128, 32
    else:
        ti, tf, w, h = _setup(case)
    pairs, fan, covered, outside = _covered_outside_vertex_bbox(ti, tf, w, h)
    assert pairs > 0 and covered > 0
    if case.startswith("clipped_soup") or case == "padded_clipped_soup":
        assert fan > 0
    assert outside == 0
