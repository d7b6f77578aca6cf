"""The port's indexed geometry stage, band prepares and plain band kernels
(zrenderer_tpu_torch/ops/geometry.py ``geometry_pipeline``,
zrenderer_tpu_torch/ops/raster.py K3b/K9/K9g/K9d and their prepares,
zrenderer_tpu_torch/parallel/tiles.py) against the JAX package, run
eagerly on the CPU, and against the single-device frames.

Contracts (docs/RASTER_SPEC.md §5):
* indexed geometry: bit-exact against ``geometry_pipeline(np, ...)`` and
  against the port's column stage;
* ``canonical_order_perm``, the band-local ``prepare_binned_hbm_inputs``
  and ``prepare_binned_dist_local``: int32-exact against the JAX
  functions (offsets, listed rows, records over the spans; the port drops
  the reference's TPU record packing and DMA margin rows);
* the plain band kernels: the bands laid side by side equal the
  single-device plain frame bit for bit, and the NumPy oracle in coverage
  and depth bits, u8 within 1 LSB (the oracle divides where the kernels
  multiply by 1/den).
The multi-process runs are in test_torch_sharding.py, the Pallas
interpret runs in test_torch_bands_interpret.py; the CUDA kernels are
held against the plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_raster import _bits, _content_scene, _u8
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu.parallel.tiles import canonical_order_perm as ref_perm
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.procedural import make_test_scene
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops import taa
from zrenderer_tpu_torch.parallel import tiles
from zrenderer_tpu_torch.scene.procedural import (
    make_stress_scene,
    make_triangle_soup,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clipped_soup(n=512):
    """``n``-triangle soup, some triangles pushed through the near plane."""
    scene, md = make_triangle_soup(n, seed=7, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(40, 60):
        v[3 * t, 2] += 15.0
    return scene, md


# name -> (scene factory, width, height, tri_align): heights split into
# 2 bands of whole tiles; tri_align keeps the triangle count even.
SCENES = {
    "test_scene_256x64": (_content_scene, 256, 64, 16),
    "clipped_soup_384x128": (_clipped_soup, 384, 128, 64),
}


def _flat(case):
    build, w, h, tri_align = SCENES[case]
    scene, md = build()
    flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    return flat, mats, w, h


def _indexed_args(flat, mats):
    return (flat.positions, flat.attrs, flat.tri_vidx, mats, flat.vert_node)


def _vertex_shader(lib):
    """Object-space shader written for either array library: scale and
    lift the positions, invert the colours."""
    def vs(p, a):
        scale = lib.asarray(np.array([0.9, 0.9, 0.9, 1.0], np.float32))
        lift = lib.asarray(np.array([0.0, 0.25, 0.0, 0.0], np.float32))
        colour = 1.0 - a[:, 0:3]
        return p * scale + lift, lib.concatenate([colour, a[:, 3:]], 1) \
            if lib is np else torch.cat([colour, a[:, 3:]], 1)
    return vs


VARIANTS = ["capped", "dense", "cap2", "draw_materials", "tri_materials",
            "vertex_shader"]


def _variant_kw(variant, flat, mats, lib):
    rng = np.random.default_rng(4)
    conv = (lambda a: a) if lib is np else _t
    kw = {}
    if variant == "dense":
        kw["clip_cap"] = None
    if variant == "cap2":
        kw["clip_cap"] = 2
    if variant.endswith("materials"):
        rows = len(mats) if variant == "draw_materials" else len(flat.tri_vidx)
        kw["material_table"] = conv(rng.random((rows, g.MATERIAL_COLS),
                                               dtype=np.float32))
        kw["normal_matrices"] = conv(rng.standard_normal(
            (len(mats), 3, 3)).astype(np.float32))
    if variant == "vertex_shader":
        kw["vertex_shader"] = _vertex_shader(lib)
    return kw


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case", list(SCENES))
def test_indexed_geometry_matches_numpy(case, variant):
    flat, mats, w, h = _flat(case)
    ref = g.geometry_pipeline(np, *_indexed_args(flat, mats), w, h,
                              **_variant_kw(variant, flat, mats, np))
    ours = tg.geometry_pipeline(*map(_t, _indexed_args(flat, mats)), w, h,
                                **_variant_kw(variant, flat, mats, torch))
    assert ours[0].dtype == torch.int32 and ours[1].dtype == torch.float32
    assert tuple(ours[0].shape) == ref[0].shape
    assert (ours[0][:, g.I_VALID] > 0).sum() > 20
    np.testing.assert_array_equal(ours[0].numpy(), ref[0])
    _bits(ours[1].numpy(), ref[1])


@pytest.mark.parametrize("case", list(SCENES))
def test_indexed_geometry_equals_the_column_stage(case):
    """Per-draw materials and normals: the indexed rows are the column
    stage's bits (a triangle's corners share a draw)."""
    flat, mats, w, h = _flat(case)
    kw = _variant_kw("draw_materials", flat, mats, torch)
    ti, tf = tg.geometry_pipeline(*map(_t, _indexed_args(flat, mats)), w, h,
                                  **kw)
    ccols, tri_node = flat.expand_corner_cols()
    ti_c, tf_c = tg.geometry_pipeline_cols(_t(ccols), _t(tri_node), _t(mats),
                                           w, h, **kw)
    assert torch.equal(ti, ti_c)
    assert torch.equal(tf.view(torch.int32), tf_c.view(torch.int32))


@pytest.mark.parametrize("clip_cap", ["auto", 4])
def test_clip_overflow_count_indexed_matches_reference(clip_cap):
    flat, mats, w, h = _flat("clipped_soup_384x128")
    ref = g.clip_overflow_count(np, *_indexed_args(flat, mats), w, h,
                                clip_cap=clip_cap)
    ours = tg.clip_overflow_count_indexed(*map(_t, _indexed_args(flat, mats)),
                                          w, h, clip_cap=clip_cap)
    assert ours.dtype == torch.int32 and int(ours) == int(ref)
    if clip_cap == 4:
        assert int(ours) > 0


@pytest.mark.parametrize("n, shard_tris", [(1, 256), (2, 128), (4, 1500),
                                           (8, 70000)])
def test_canonical_order_perm_matches_reference(n, shard_tris):
    ours = tiles.canonical_order_perm(n, shard_tris)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(ref_perm(n, shard_tris)))


def _gathered(case, n):
    """The canonical gathered rows of ``n`` shards, port (torch) and
    reference (NumPy geometry + the reference's permutation), with the
    per-shard rows and the shard size."""
    flat, mats, w, h = _flat(case)
    s = len(flat.tri_vidx) // n
    locals_, ti, tf, s2 = tiles.setups_in_turn(
        n, *map(_t, _indexed_args(flat, mats)), w, h)
    assert s2 == s
    ref = [g.geometry_pipeline(np, flat.positions, flat.attrs,
                               flat.tri_vidx[r * s:(r + 1) * s], mats,
                               flat.vert_node, w, h) for r in range(n)]
    perm = np.asarray(ref_perm(n, s))
    ti_ref = np.concatenate([a for a, _ in ref])[perm]
    tf_ref = np.concatenate([b for _, b in ref])[perm]
    np.testing.assert_array_equal(ti.numpy(), ti_ref)
    _bits(tf.numpy(), tf_ref)
    return locals_, ref, ti, tf, s, w, h


def _records_equal(rec_i, rec_f, prec_i, prec_f, n):
    prec_i = np.asarray(prec_i).reshape(-1, rp.I32_LANES)
    prec_f = np.asarray(prec_f).reshape(-1, rp.F32_LANES)
    np.testing.assert_array_equal(rec_i[:n, :g.NI32].numpy(),
                                  prec_i[:n, :g.NI32])
    np.testing.assert_array_equal(rec_i[:n, g.NI32].numpy(),
                                  prec_i[:n, rp.L_PID])
    _bits(rec_f[:n].numpy(), prec_f[:n, :g.NF32])


@pytest.mark.parametrize("budget", ["none", "half"])
@pytest.mark.parametrize("band", [0, 1])
@pytest.mark.parametrize("case", list(SCENES))
def test_band_prepare_matches_jax(case, band, budget):
    """The band-local K9 prepare with the gathered layout's true head
    count: offsets, records over the spans, the leftover rows (the listed
    set) and the block tables; with a pair budget of half the band's
    pairs, so that the clamp demotes rows."""
    _, _, ti, tf, s, w, h = _gathered(case, 2)
    band_h = h // 2
    kw = dict(cap=4, n_head=2 * s, band_ty0=band * band_h // tr.TILE_H,
              band_tiles_y=band_h // tr.TILE_H)
    full = int(tr.prepare_binned_hbm_inputs(ti, tf, w, h, **kw)[0][-1])
    if budget == "half":
        kw["pair_budget"] = full // 2
    ours = tr.prepare_binned_hbm_inputs(ti, tf, w, h, **kw)
    ref = rp.prepare_binned_hbm_inputs(jnp.asarray(ti.numpy()),
                                       jnp.asarray(tf.numpy()), w, h, **kw)
    offsets, rec_i, rec_f, supers, blocks, hier, _, coarse = ours
    assert coarse is None
    assert offsets.shape[0] == w // tr.TILE_W * band_h // tr.TILE_H + 1
    np.testing.assert_array_equal(offsets.numpy(), np.asarray(ref[0]))
    n = int(offsets[-1])
    assert n > 0
    if budget == "half":
        assert n <= full // 2 < full  # the clamp engaged
    _records_equal(rec_i, rec_f, ref[1], ref[2], n)
    np.testing.assert_array_equal(supers.numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(ref[4]))
    np.testing.assert_array_equal(
        hier.numpy(), np.asarray(ref[5]).reshape(-1, rp.I32_LANES)[:, :g.NI32])


@pytest.mark.parametrize("slab", [16, None])
@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("case", list(SCENES))
def test_dist_local_prepare_matches_jax(case, shard, slab):
    """K9d's per-shard prepare: spans, the listed rows sent to each band
    and the records over the spans, with the canonical ids."""
    locals_, _, _, _, s, w, h = _gathered(case, 2)
    ti_l, tf_l = locals_[shard]
    ours = tr.prepare_binned_dist_local(ti_l, tf_l, w, h, 2, shard, s,
                                        slab_records=slab)
    ref = rp.prepare_binned_dist_local(
        jnp.asarray(ti_l.numpy()), jnp.asarray(tf_l.numpy()), w, h,
        n_bands=2, shard_index=shard, shard_head=s, slab_records=slab)
    rec_i, rec_f, offs, listed = ours
    assert listed.dtype == torch.bool
    np.testing.assert_array_equal(offs.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(listed.numpy(), np.asarray(ref[3]))
    assert rec_i.shape[1] == tr.dist_slab_rows(
        tr.DIST_SLAB_RECORDS if slab is None else slab)
    for b in range(2):
        n = int(offs[b, -1])
        assert 0 < n <= rec_i.shape[1]
        _records_equal(rec_i[b], rec_f[b], np.asarray(ref[0])[b],
                       np.asarray(ref[1])[b], n)


def test_dist_slab_overflow_demotes():
    """A 16-record slab (256 after rounding) demotes in-band candidates to
    the owner's hierarchy: some valid rows reach no band, the spans stay
    inside the slab, and the assembled bands still equal the
    single-device frame (the reference's test_sharding.py:357)."""
    w, h = 128, 64
    scene, md = make_triangle_soup(2048, seed=17, extent=2.0,
                                   triangle_size=0.5)
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = tg.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    args = list(map(_t, _indexed_args(flat, mats)))
    ti0, tf0 = tg.geometry_pipeline(args[0], args[1], args[2][:1024],
                                    *args[3:], w, h)
    _, _, offs, listed = tr.prepare_binned_dist_local(ti0, tf0, w, h, 2, 0,
                                                      1024, slab_records=16)
    valid = ti0[:1024, g.I_VALID] > 0
    assert int(valid.sum()) > 300
    assert int((valid & ~(listed[0] | listed[1])).sum()) > 0
    assert int(offs.max()) <= 256
    old = tr.DIST_SLAB_RECORDS
    try:
        tr.DIST_SLAB_RECORDS = 16
        bands = tiles.bands_in_turn(2, w, h, *args, binning="dist")
    finally:
        tr.DIST_SLAB_RECORDS = old
    ccols, tri_node = flat.expand_corner_cols()
    c1, d1 = tr.render_frame(_t(ccols), _t(tri_node), _t(mats), w, h, h, w)
    assert torch.equal(torch.cat([b[0] for b in bands]), tr.unpack_rgba8(c1))
    _bits(torch.cat([b[1] for b in bands]).numpy(), d1.numpy())


def test_dist_slab_counts_empty_footprints_as_zero():
    """A valid row whose bbox lies wholly right of the frame (inside the
    guard band) clamps to an empty column range with a negative footprint.
    The reference's per-band slab prefix sums it as negative, so its spans
    pass the slab (277 records for 256 here; its DMA margin rows still
    hold them); the port counts it 0, every span fits the slab, and the
    bands still equal the single-device frame."""
    w, h, slab = 256, 64, 256
    scene, md = make_triangle_soup(2048, seed=17, extent=2.0,
                                   triangle_size=0.5)
    md.vertex_data.reshape(-1, 16)[:600, 0] += 40.0  # 200 triangles right
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = tg.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    ti, tf = g.geometry_pipeline(np, *_indexed_args(flat, mats), w, h)
    t = len(flat.tri_vidx)
    head = ti[:t]
    ntx = head[:, g.I_JMAX] // tr.TILE_W - head[:, g.I_JMIN] // tr.TILE_W + 1
    assert ((head[:, g.I_VALID] > 0) & (ntx < 0)).sum() > 20
    ref = rp.prepare_binned_dist_local(jnp.asarray(ti), jnp.asarray(tf), w, h,
                                       n_bands=2, shard_index=0,
                                       shard_head=t, slab_records=slab)
    ours = tr.prepare_binned_dist_local(_t(ti), _t(tf), w, h, 2, 0, t,
                                        slab_records=slab)
    assert int(np.asarray(ref[2])[:, -1].max()) > slab
    assert int(ours[2][:, -1].max()) <= slab == ours[0].shape[1]
    old = tr.DIST_SLAB_RECORDS
    try:
        tr.DIST_SLAB_RECORDS = slab
        bands = tiles.bands_in_turn(2, w, h, *map(_t, _indexed_args(
            flat, mats)), binning="dist")
    finally:
        tr.DIST_SLAB_RECORDS = old
    c1, d1 = _single_frame(flat, mats, w, h)
    assert torch.equal(torch.cat([b[0] for b in bands]), tr.unpack_rgba8(c1))
    _bits(torch.cat([b[1] for b in bands]).numpy(), d1.numpy())


def _single_frame(flat, mats, w, h):
    ccols, tri_node = flat.expand_corner_cols()
    return tr.render_frame(_t(ccols), _t(tri_node), _t(mats), w, h, h, w,
                           binning="hierarchy")


BAND_KINDS = ["k3b", "k9", "k9_global", "k9d"]


@pytest.mark.parametrize("kind", BAND_KINDS)
@pytest.mark.parametrize("case", list(SCENES))
def test_plain_bands_assemble_the_single_device_frame(case, kind):
    """Each plain band kernel over both bands: laid side by side they equal
    the single-device plain K3 frame bit for bit, and the oracle."""
    locals_, _, ti, tf, s, w, h = _gathered(case, 2)
    band_h = h // 2
    bands = []
    for b in range(2):
        row0 = b * band_h
        if kind == "k3b":
            out = tr.raster_hier_band_plain(*tr.prepare_raster_inputs(ti, tf),
                                            w, band_h, row0)
        elif kind in ("k9", "k9_global"):
            local = kind == "k9"
            out = tr.rasterize_setup_binned_band(
                ti, tf, w, h, band_h, row0, cap=4, n_head=2 * s,
                pair_budget=60, band_local=local)
        else:
            received = tiles.dist_exchange(tiles.InTurnExchange(2),
                                           locals_, w, h, s)[b]
            out = tr.rasterize_setup_binned_band_dist(
                ti, tf, *received, w, h, band_h, row0)
        assert tuple(out[0].shape) == (band_h, w)
        bands.append(out)
    color = torch.cat([c for c, _ in bands]).numpy()
    depth = torch.cat([d for _, d in bands]).numpy()
    c1, d1 = tr.rasterize_setup(ti, tf, w, h)
    assert (depth < 1.0).mean() > 0.1
    np.testing.assert_array_equal(color, c1.numpy())
    _bits(depth, d1.numpy())
    rgba, ref_d = raster_cpu.rasterize_setup(ti.numpy(), tf.numpy(), w, h)
    _bits(depth, ref_d)
    assert np.abs(_u8(color).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1


def test_hierarchy_band_above_the_row_bound_equals_the_frame(monkeypatch):
    """``binning="hierarchy"`` sends every band to K3b, whatever its row
    count: the 40K lattice from 2 shards at 256x128 (above 32768 gathered
    rows, 12 superblocks), each band of the in-turn band stage equal to the
    same rows of the whole-frame plain K3 frame (K5's, above the bound)."""
    w, h = 256, 128
    scene, md = make_stress_scene(40000)
    flat = flatten_scene(scene, md, pad=True, tri_align=256)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    _, ti, tf, s = tiles.setups_in_turn(
        2, *map(_t, _indexed_args(flat, mats)), w, h)
    prep = tr.prepare_raster_inputs(ti, tf)
    assert ti.shape[0] > tr.MAX_RESIDENT_ROWS and prep[0].shape[0] > 8
    color, depth = tr.raster_hier_plain(*prep, w, h)
    assert (depth < 1.0).float().mean() > 0.1
    calls = []
    k3b = tr.rasterize_setup_band
    monkeypatch.setattr(tr, "rasterize_setup_band",
                        lambda *a: calls.append(a[3:]) or k3b(*a))
    for b in range(2):
        rgba, d = tiles.band_raster(ti, tf, w, h, 2, b, 2 * s,
                                    binning="hierarchy")
        rows = slice(b * h // 2, (b + 1) * h // 2)
        assert torch.equal(rgba, tr.unpack_rgba8(color[rows]))
        _bits(d.numpy(), depth[rows].numpy())
    assert calls == [(h // 2, 0), (h // 2, h // 2)]


@pytest.mark.parametrize("case", list(SCENES))
def test_plain_k9g_bands_assemble_the_single_device_gbuffer(case):
    """K9g's 13 planes over both bands, per-triangle materials and
    normals: equal as int32 bits to the single-device plain K4g planes."""
    flat, mats, w, h = _flat(case)
    kw = _variant_kw("tri_materials", flat, mats, torch)
    _, ti, tf, s = tiles.setups_in_turn(
        2, *map(_t, _indexed_args(flat, mats)), w, h, **kw)
    bands = [tr.rasterize_gbuffer_binned_band(ti, tf, w, h, h // 2,
                                              b * h // 2, cap=4,
                                              pair_budget=60, n_head=2 * s)
             for b in range(2)]
    full = tr.gbuffer_binned_plain(*tr.prepare_binned_hbm_inputs(
        ti, tf, w, h, n_head=2 * s), w, h)
    assert (full[1] < 1.0).float().mean() > 0.1
    assert len(bands[0]) == tr.GBUFFER_PLANES
    for i, plane in enumerate(full):
        got = torch.cat([b[i] for b in bands])
        assert torch.equal(got.contiguous().view(torch.int32),
                           plane.contiguous().view(torch.int32)), i


@pytest.mark.parametrize("binning", ["auto", "hierarchy", "tile_lists",
                                     "dist"])
def test_bands_in_turn_equal_the_renderer_frame(binning):
    """The sharded flat frame with its ranks in turn (4 bands) equals the
    port's single-device Renderer frame at the same size."""
    w, h = 256, 128
    scene, md = _clipped_soup(384)
    r = Renderer(RenderConfig(width=w, height=h, tri_align=64), device="cpu")
    r.load_scene(scene, md)
    img, depth = r.render_and_read()
    b = r._buffers()
    bands = tiles.bands_in_turn(4, w, h, b["positions"], b["attrs"],
                                b["tri_vidx"], _t(r.camera_matrices()),
                                b["vert_node"], binning=binning)
    assert [tuple(x[0].shape) for x in bands] == [(32, w, 4)] * 4
    np.testing.assert_array_equal(torch.cat([x[0] for x in bands]).numpy(),
                                  img)
    _bits(torch.cat([x[1] for x in bands]).numpy(), depth)


def _deferred_renderer(w, h, n_lights=8):
    r = Renderer(RenderConfig(width=w, height=h, pipeline="deferred",
                              tri_align=64), device="cpu")
    r.load_scene(*make_test_scene())
    rng = np.random.default_rng(3)
    pos = rng.uniform(-4, 4, (n_lights, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1]) + 1.0
    col = rng.uniform(0.2, 3.0, (n_lights, 3)).astype(np.float32)
    r.set_environment(lights=(pos, col))
    return r


def _deferred_args(r):
    c = {k: _t(v) for k, v in r._lit_constants().items()}
    b = r._buffers()
    return (b["positions"], b["attrs"], b["tri_vidx"], c["matrices"],
            b["vert_node"], c["normal_mats"], b["materials"],
            c["inv_view_proj"], c["cam_pos"], _t(r.lights[0]),
            _t(r.lights[1]), c["view_proj"])


def test_deferred_bands_in_turn_equal_the_renderer_frame():
    """K9g + K7 per band (2 bands), the per-triangle material table split
    with the triangles: equal to the port's single-device deferred
    frame."""
    w, h = 128, 64
    r = _deferred_renderer(w, h)
    img, depth = r.render_and_read()
    bands = tiles.deferred_bands_in_turn(2, w, h, *_deferred_args(r))
    assert (depth < 1.0).mean() > 0.2
    np.testing.assert_array_equal(torch.cat([x[0] for x in bands]).numpy(),
                                  img)
    _bits(torch.cat([x[1] for x in bands]).numpy(), depth)


@pytest.mark.parametrize("n", [2, 4])
def test_per_draw_table_of_shard_length_is_expanded(n):
    """A per-draw material table with T/n rows, as many as a shard has
    triangles: every shard gets it expanded to its own triangles, so the
    gathered rows equal those of the expanded per-triangle table and not
    those of the table read per triangle."""
    flat, mats, w, h = _flat("clipped_soup_384x128")
    args = list(map(_t, _indexed_args(flat, mats)))
    t = len(flat.tri_vidx)
    rng = np.random.default_rng(6)
    draws = _t(rng.random((t // n, g.MATERIAL_COLS), dtype=np.float32))
    normals = _t(rng.standard_normal((len(mats), 3, 3)).astype(np.float32))
    expanded = draws[args[4][args[2][:, 0].long()].long()]
    assert len(draws) == t // n and len(mats) < t // n
    rows = {name: tiles.setups_in_turn(n, *args, w, h,
                                       normal_matrices=normals,
                                       material_table=table)[1:3]
            for name, table in (("draw", draws), ("tri", expanded))}
    # Each shard reading the table per triangle is the per-triangle table
    # of the n copies.
    per_tri_misread = tiles.setups_in_turn(
        n, *args, w, h, normal_matrices=normals,
        material_table=draws.repeat(n, 1))[2]
    assert torch.equal(rows["draw"][0], rows["tri"][0])
    assert torch.equal(rows["draw"][1].view(torch.int32),
                       rows["tri"][1].view(torch.int32))
    assert not torch.equal(rows["draw"][1], per_tri_misread)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_taa_bands_equal_the_full_frame_resolve(n):
    """The halo-row resolve per band equals ``taa_resolve`` on the whole
    frame, the 3x3 clamp wrapping at the top and bottom rows; the history
    stays band-local over 3 frames."""
    rng = np.random.default_rng(5)
    h, w = 128, 64
    frames = [torch.from_numpy(rng.integers(0, 256, (h, w, 4), np.uint8))
              for _ in range(3)]
    hist = taa.taa_init_history(frames[0])
    hists = [None] * n
    for frame in frames:
        hist, res = taa.taa_resolve(hist, frame)
        out = tiles.taa_bands_in_turn(list(frame.chunk(n)), hists)
        hists = [x[0] for x in out]
        assert torch.equal(torch.cat([x[1] for x in out]), res)
        assert torch.equal(torch.cat(hists), hist)


def test_band_checks_raise():
    flat, mats, w, h = _flat("test_scene_256x64")
    args = list(map(_t, _indexed_args(flat, mats)))
    with pytest.raises(ValueError, match="bands"):
        tiles.bands_in_turn(3, w, h, *args)
    with pytest.raises(ValueError, match="shards"):
        tiles.bands_in_turn(2, w, h, args[0], args[1], args[2][:-1],
                            *args[3:])
    with pytest.raises(ValueError, match="binning"):
        tiles.bands_in_turn(2, w, h, *args, binning="small")
    ti, tf = tg.geometry_pipeline(*args, w, h)
    with pytest.raises(ValueError, match="band"):
        tr.rasterize_setup_band(ti, tf, w, 32, 16)
    with pytest.raises(ValueError, match="band"):
        tr.rasterize_setup_binned_band(ti, tf, w, h, 32, 64)
    with pytest.raises(ValueError, match="coarse"):
        tr.prepare_binned_hbm_inputs(ti, tf, w, h, coarse_cap=8, band_ty0=0,
                                     band_tiles_y=1)


def test_band_kernels_refuse_cpu_tensors():
    """The band kernel launchers never fall back to the plain versions."""
    _, _, ti, tf, s, w, h = _gathered("test_scene_256x64", 2)
    hier = tr.prepare_raster_inputs(ti, tf)
    band = tr.prepare_binned_hbm_inputs(ti, tf, w, h, n_head=2 * s,
                                        band_ty0=1, band_tiles_y=1)
    glob = tr.prepare_binned_hbm_inputs(ti, tf, w, h, n_head=2 * s)
    before = [k.launches for k in tr.BAND_KERNELS]
    calls = [
        lambda: tr.raster_hier_band_kernel(*hier, w, 32, 32),
        lambda: tr.raster_binned_band_kernel(*band, w, 32, 32),
        lambda: tr.raster_binned_band_kernel(*glob, w, 32, 32, False),
        lambda: tr.gbuffer_binned_band_kernel(*band, w, 32, 32),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="n_src"):
        tr.raster_binned_band_dist_kernel(*band, w, 32, 32)
    assert [k.launches for k in tr.BAND_KERNELS] == before


def test_band_constants_match_reference():
    assert tr.DIST_SLAB_RECORDS == rp.DIST_SLAB_RECORDS
    assert tr.REC_ALIGN == rp.REC_ALIGN
    for n in (1, 2, 4, 8, 64):
        assert tr.band_pair_budget(n) == rp.band_pair_budget(n)
    for k in (1, 16, 256, 257, 1 << 15):
        assert tr.dist_slab_rows(k) == rp.dist_slab_rows(k) - rp.REC_CHUNK


def test_per_triangle_materials_split_with_the_shards():
    """The reference's sharded deferred frame hands every shard the whole
    per-triangle material table (``tiles.py:369-373``), so a shard of T/n
    triangles reads it as a per-draw table, indexed by draw id, and gets
    other triangles' constants; the port splits a per-triangle table with
    the triangles, and its shard's rows equal the single-device rows."""
    flat, mats, w, h = _flat("clipped_soup_384x128")
    rng = np.random.default_rng(6)
    table = rng.random((len(flat.tri_vidx), g.MATERIAL_COLS), np.float32)
    s = len(flat.tri_vidx) // 2
    shard = (flat.positions, flat.attrs, flat.tri_vidx[s:], mats,
             flat.vert_node)
    ti, single = g.geometry_pipeline(np, *_indexed_args(flat, mats), w, h,
                                     material_table=table)
    _, ref = g.geometry_pipeline(np, *shard, w, h, material_table=table)
    _, ours = tg.geometry_pipeline(*map(_t, shard), w, h,
                                   material_table=_t(table[s:]))
    cols = slice(g.F_MET, g.F_TEX + 1)
    live = ti[s:2 * s, g.I_VALID] > 0
    np.testing.assert_array_equal(ours.numpy()[:s, cols][live],
                                  single[s:2 * s, cols][live])
    assert (ref[:s, cols][live] != single[s:2 * s, cols][live]).any()
