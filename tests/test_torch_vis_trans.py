"""The port's visibility-buffer and transposed-group raster
(zrenderer_tpu_torch/ops/experiments/raster_vis_trans.py: K10vis,
K10trans) against the JAX package, the port's plain K5 and the NumPy
oracle, given shared setup rows.

* The prepares equal the reference's ``prepare_group_bits`` and
  ``prepare_trans_inputs`` (XLA on the CPU) exactly: the bitmap's first
  ceil(G/32) words of the first tiles (the reference pads words to a
  multiple of 1024 and tiles to a multiple of 8, with zeros), the
  superblock and block tables, the records' setup ints and z-plane bits,
  the group bounds and the resolve table.
* ``resolve_flat_vis`` equals the reference's bit for bit on given depth,
  id and table planes.
* The plain frames (colour and depth) equal the port's plain K5
  (``raster_hier_plain``) bit for bit in the visible rows; against the
  oracle coverage and depth exact, u8 within 1 LSB (RASTER_SPEC §5).
* Below the geometry's frame each kernel draws by its own extent: at
  128x64 with geometry at 128x56, K5 draws 289 pixels in rows 56-63,
  K10vis 451 (185 of them differ from K5), K10trans none.
* The CUDA kernels' rules, in torch (``vis_block_hits``,
  ``admitted_rows``, ``window_rects``, ``window_keys``, ``key_planes``):
  every admitted (tile, row) pair over its window, one (z, row id, sign)
  key a pixel, the work items merged by minimum, give the plain versions'
  depth bits and ids in every row at 1 and VIS_ITEMS items a tile: the
  padded soup (451 and 0 padding-row pixels), exact ties, a -0.0 tie
  both ways, a row at z == 1.0, the empty scene.  Two counter-cases show
  why the rules are what they are: K10vis admitting rows by their own
  bbox, as K5 does, loses padding-row pixels; K10trans's windows over the
  whole tile draw padding-row pixels.  The bitmap hit words give every hit
  block a work item, and the hit blocks hold every group the plain
  versions visit.

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py; here their wrappers must refuse CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_group8 import _bits, empty_setup
from test_torch_raster import _setup, _u8
from test_torch_vec import twin_soup_setup
from zrenderer_tpu.engine.upload import flatten_scene
from zrenderer_tpu.ops import geometry as g
from zrenderer_tpu.ops.experiments import raster_vis_trans as rvt
from zrenderer_tpu.raster_ref import raster_cpu
from zrenderer_tpu.scene.procedural import make_test_scene, make_triangle_soup
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops.experiments import raster_vis_trans as vt

# The plain kernels run thousands of small torch ops: one intra-op thread
# a test worker (see test_torch_gbuffer.py).
torch.set_num_threads(1)

T = torch.from_numpy


def rows_at(scene, md, w, h, tri_align=64):
    """The reference's NumPy geometry of ``scene`` at (w, h)."""
    flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
    vp = g.view_proj_from_camera(scene.active_camera, w, h)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    return g.geometry_pipeline(np, flat.positions, flat.attrs, flat.tri_vidx,
                               mats, flat.vert_node, w, h)


def demo_setup(w=128, h=32):
    """The reference test's procedural scene (tests/test_raster_pallas.py
    ``test_vis_buffer_matches_hbm_kernel``)."""
    return (*rows_at(*make_test_scene(), w, h, tri_align=16), w, h)


def padded_setup():
    """1500-triangle soup with geometry at 128x56, rasterized at 128x64:
    rows 56-63 are padding rows, where rows straddling row 55 and rows
    whose bbox clamps empty below it lie."""
    return (*rows_at(*make_triangle_soup(1500, seed=5, extent=6.0), 128,
                     56), 128, 64)


def setup(case):
    return {"demo_128x32": demo_setup, "twin_soup_256x64": twin_soup_setup,
            "empty_128x32": empty_setup,
            "padded_soup_128x64": padded_setup}.get(
        case, lambda: _setup(case))()


PREPARE_CASES = ["test_scene_256x64", "clipped_soup_384x128",
                 "tie_soup_256x128", "twin_soup_256x64",
                 "padded_soup_128x64", "empty_128x32"]


@pytest.mark.parametrize("case", PREPARE_CASES)
def test_prepare_group_bits_matches_jax(case):
    ti, tf, w, h = setup(case)
    supers, bits, ti_c, _, _ = vt.prepare_vis_inputs(T(ti), T(tf), w, h)
    ref = np.asarray(rvt.prepare_group_bits(jnp.asarray(ti_c.numpy()), w, h))
    tiles = (w // tr.TILE_W) * (h // tr.TILE_H)
    nwords = -(-ti_c.shape[0] // (32 * vt.GROUP))
    assert tuple(bits.shape) == (tiles, nwords)
    _bits(bits.numpy(), ref[:tiles, :nwords])
    assert not ref[tiles:].any() and not ref[:, nwords:].any()
    _bits(supers.numpy(), tr.prepare_raster_inputs(T(ti), T(tf))[0])
    if case != "empty_128x32":
        assert bits.numpy().any()


@pytest.mark.parametrize("case", PREPARE_CASES)
def test_prepare_trans_inputs_matches_jax(case):
    ti, tf, _, _ = setup(case)
    supers, blocks, rec, gb, table = vt.prepare_trans_inputs(T(ti), T(tf))
    ref = [np.asarray(x) for x in rvt.prepare_trans_inputs(jnp.asarray(ti),
                                                           jnp.asarray(tf))]
    _bits(supers.numpy(), ref[0])
    _bits(blocks.numpy(), ref[1])
    r128, rec = ref[2], rec.numpy()
    assert rec.shape == (r128.shape[0], vt.REC_LANES)
    _bits(rec[:, :g.NI32], r128[:, :g.NI32])
    _bits(rec[:, vt.TRANS_ZA:vt.TRANS_ZA + 3],
          r128[:, rvt.TRANS_ZA:rvt.TRANS_ZA + 3])
    assert not rec[:, vt.TRANS_ZA + 3:].any()
    assert not np.delete(r128, np.r_[0:g.NI32, rvt.TRANS_ZA:rvt.TRANS_ZA + 3],
                         axis=1).any()
    ref_gb = ref[3].reshape(-1, 8)
    _bits(gb.numpy(), ref_gb[:, :4])
    assert not ref_gb[:, 4:].any()
    _bits(table.numpy(), ref[4][:, :vt.TABLE_LANES])
    assert not ref[4][:, vt.TABLE_LANES:].any()


def test_resolve_matches_jax():
    """Given planes: random ids in [-1, T) (with dead rows and rows whose
    pixels are uncovered) over a real table, and the table of the
    reference's ``_vis_resolve_table``."""
    ti, tf, w, h = setup("clipped_soup_384x128")
    _, _, ti_c, tf_c, table = vt.prepare_vis_inputs(T(ti), T(tf), w, h)
    ref_table = np.asarray(rvt._vis_resolve_table(jnp.asarray(ti_c.numpy()),
                                                  jnp.asarray(tf_c.numpy())))
    _bits(table.numpy(), ref_table[:, :vt.TABLE_LANES])
    rng = np.random.default_rng(3)
    idx = rng.integers(-1, ti_c.shape[0], (h, w)).astype(np.int32)
    depth = rng.random((h, w), dtype=np.float32)
    ours = vt.resolve_flat_vis(T(depth), T(idx), table).numpy()
    ref = np.asarray(rvt.resolve_flat_vis(jnp.asarray(depth),
                                          jnp.asarray(idx),
                                          jnp.asarray(ref_table)))
    _bits(ours, ref)
    u8 = _u8(ours)
    assert (u8[..., :3].sum(-1) > 0).mean() > 0.01
    assert (u8[idx < 0, :3] == 0).all() and (u8[..., 3] == 255).all()


FRAME_CASES = ["demo_128x32", "test_scene_256x64", "twin_soup_256x64",
               "clipped_soup_384x128", "empty_128x32"]
ENTRY = {"vis": vt.rasterize_setup_vis, "trans": vt.rasterize_setup_trans}


@pytest.mark.parametrize("kind", list(ENTRY))
@pytest.mark.parametrize("case", FRAME_CASES)
def test_plain_frames_equal_k5_and_oracle(case, kind):
    ti, tf, w, h = setup(case)
    color, depth = ENTRY[kind](T(ti), T(tf), w, h)
    assert color.dtype == torch.int32 and depth.dtype == torch.float32
    k5 = tr.raster_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)), w, h)
    _bits(color, k5[0])
    _bits(depth, k5[1])
    rgba, ref_d = raster_cpu.rasterize_setup(ti, tf, w, h)
    np.testing.assert_array_equal(depth.numpy(), ref_d)
    assert np.abs(_u8(color.numpy()).astype(np.int32)
                  - raster_cpu.pack_u8(rgba).astype(np.int32)).max() <= 1
    if case == "empty_128x32":
        assert (depth == 1.0).all() and (color == tr._ALPHA_BITS).all()
    else:
        assert (depth < 1.0).float().mean() > 0.02


def pair_soup_setup(w=256, h=64):
    """The twin soup's 500 triangles with each odd triangle of 65-83
    repeating the even one before it: rows one apart, mostly in one 8-row
    group, so K10trans's in-group tie rule (the lower row id) decides."""
    scene, md = make_triangle_soup(500, seed=7, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(65, 84, 2):
        v[3 * t:3 * t + 3, 0:3] = v[3 * (t - 1):3 * (t - 1) + 3, 0:3]
    return (*rows_at(scene, md, w, h), w, h)


TIE_CASES = {  # name: (setup, the repeats, the rows they repeat)
    "twin_soup_256x64": (twin_soup_setup, np.arange(74, 84),
                         np.arange(64, 74)),
    "pair_soup_256x64": (pair_soup_setup, np.arange(65, 84, 2),
                         np.arange(64, 83, 2)),
}


@pytest.mark.parametrize("kind", list(ENTRY))
@pytest.mark.parametrize("case", list(TIE_CASES))
def test_exact_ties_resolve_to_the_first_row(case, kind):
    """Repeated triangles tie their originals' depth exactly: the frame
    equals the one without the repeats, and differs from the one without
    the originals."""
    build, repeats, originals = TIE_CASES[case]
    ti, tf, w, h = build()
    live = ti[:, g.I_VALID] > 0
    assert (live[repeats] & live[originals]).sum() >= 4
    if case == "pair_soup_256x64":  # compacted rows: same 8-row group
        pos = np.cumsum(live) - 1
        assert (pos[repeats] // 8 == pos[originals] // 8)[
            live[repeats] & live[originals]].sum() >= 3

    def without(rows):
        dead = ti.copy()
        dead[rows, g.I_VALID] = 0
        dead[rows, g.I_JMIN] = 1
        dead[rows, g.I_JMAX] = 0
        return ENTRY[kind](T(dead), T(tf), w, h)

    color, depth = ENTRY[kind](T(ti), T(tf), w, h)
    c1, d1 = without(repeats)
    _bits(color, c1)
    _bits(depth, d1)
    assert not torch.equal(color, without(originals)[0])


def test_padding_rows_rule():
    """Geometry at 128x56, raster at 128x64.  Hit groups hold dead rows
    and valid rows whose bbox clamps empty below the frame; both kernels'
    visible rows equal K5's.  In rows 56-63 K5 draws the rows that
    straddle row 55 over their tiles, K10vis also the empty-bbox rows of
    every hit group, and K10trans nothing here (the groups' spans end at
    row 55 and their 4-row chunks do not reach row 56)."""
    ti, tf, w, h = setup("padded_soup_128x64")
    supers, bits, ti_c, tf_c, table = vt.prepare_vis_inputs(T(ti), T(tf), w,
                                                            h)
    c5, d5 = tr.raster_hier_plain(*tr.prepare_raster_inputs(T(ti), T(tf)),
                                  w, h)
    vis_d, vis_i = vt.raster_vis_plain(supers, bits, ti_c, tf_c, w, h)
    trans_c, trans_d = vt.rasterize_setup_trans(T(ti), T(tf), w, h)
    vis_c = vt.resolve_flat_vis(vis_d, vis_i, table)
    ic = ti_c.numpy()
    dead = ic[:, g.I_VALID] == 0
    clamped = ~dead & ((ic[:, g.I_JMIN] > ic[:, g.I_JMAX])
                       | (ic[:, g.I_IMIN] > ic[:, g.I_IMAX]))
    word_bits = (bits.numpy()[:, :, None].view(np.uint32)
                 >> np.arange(32, dtype=np.uint32)) & 1
    hit = word_bits.reshape(bits.shape[0], -1)[:, :ic.shape[0] // vt.GROUP]
    hit_groups = hit.any(axis=0)
    assert (dead.reshape(-1, vt.GROUP).any(axis=1) & hit_groups).any()
    assert (clamped.reshape(-1, vt.GROUP).any(axis=1) & hit_groups).any()
    vis, pad = slice(0, 56), slice(56, 64)
    for c, d in ((vis_c, vis_d), (trans_c, trans_d)):
        _bits(c[vis], c5[vis])
        _bits(d[vis], d5[vis])
    assert int((d5[pad] < 1.0).sum()) == 289
    assert int((vis_d[pad] < 1.0).sum()) == 451
    assert int(((vis_d[pad] != d5[pad]) | (vis_c[pad] != c5[pad])).sum()) \
        == 185
    assert int((trans_d[pad] < 1.0).sum()) == 0
    assert clamped[vis_i[pad][vis_i[pad] >= 0].numpy()].any()


def test_kernel_wrappers_take_cuda_tensors_only():
    ti, tf, w, h = setup("test_scene_256x64")
    vis_args = vt.prepare_vis_inputs(T(ti), T(tf), w, h)[:4]
    trans_args = vt.prepare_trans_inputs(T(ti), T(tf))[:4]
    for kern, args in zip(vt.KERNELS, (vis_args, trans_args)):
        with pytest.raises(ValueError, match="CUDA"):
            kern(*args, w, h)
    vt.rasterize_setup_vis(T(ti), T(tf), w, h)  # CPU: the plain version
    vt.rasterize_setup_trans(T(ti), T(tf), w, h)
    assert all(k.launches == 0 for k in vt.KERNELS)
    with pytest.raises(ValueError):
        vt.rasterize_setup_trans(T(ti), T(tf), 256, 40)


def test_constants_match_reference():
    assert (vt.GROUP, vt.TRANS_GROUP, vt.TRANS_R, vt.VIS_BUFFER_MIN_TRIS,
            vt.TRANS_MIN_TRIS) == (rvt.GROUP, rvt.TRANS_GROUP, rvt.TRANS_R,
                                   rvt.VIS_BUFFER_MIN_TRIS,
                                   rvt.TRANS_MIN_TRIS)
    assert vt.REC_LANES == g.NI32 + 4 < 128


# ---------------------------------------------------------------------------
# The CUDA kernels' rules (raster_vis_trans.vis_block_hits, admitted_rows,
# window_rects, window_keys, key_planes) against the plain versions
# ---------------------------------------------------------------------------


def pair_case(za_a=None, za_b=None):
    """tests/test_raster_pallas.py's tall row A with a short row B inside
    it, B submitted after A (``test_torch_hbm2.pair_setup``, imported when
    the case is built: that module imports this one)."""
    def build():
        from test_torch_hbm2 import pair_setup

        return pair_setup(za_a=za_a, za_b=za_b)[:4]

    return build


KEY_CASES = {
    "padded_soup_128x64": padded_setup,
    "twin_soup_256x64": twin_soup_setup,
    "test_scene_256x64": lambda: _setup("test_scene_256x64"),
    # An exact tie at z == 0: A's -0.0 against B's +0.0, then the other
    # way; the first row, A, keeps its sign.
    "neg_zero_first_128x32": pair_case((-0.0,) * 3, (0.0,) * 3),
    "neg_zero_second_128x32": pair_case((0.0,) * 3, (-0.0,) * 3),
    # A at z = e0 / 4: exactly 1.0 on one covered pixel, which stays clear.
    "z_one_128x32": pair_case((0.25, 0.0, 0.0)),
    "empty_128x32": empty_setup,
}


def kernel_inputs(kind, ti, tf, w, h):
    """What ``kind``'s CUDA kernel walks, from the prepare: (hit blocks
    (tiles, B), the setup ints its rows are read from, their z-plane
    coefficients (T, 3) f32, group bounds or None, bitmap or None, its
    plain version's planes)."""
    if kind == "vis":
        supers, bits, ti_c, tf_c, _ = vt.prepare_vis_inputs(T(ti), T(tf), w,
                                                            h)
        return (vt.vis_block_hits(supers, bits, ti_c.shape[0], w, h), ti_c,
                tf_c[:, g.F_ZA0:g.F_ZA0 + 3], None, bits,
                vt.raster_vis_plain(supers, bits, ti_c, tf_c, w, h))
    supers, blocks, rec, gb, _ = vt.prepare_trans_inputs(T(ti), T(tf))
    za = rec[:, vt.TRANS_ZA:vt.TRANS_ZA + 3].contiguous().view(torch.float32)
    return (tr.hier_block_hits(supers, blocks, w, h), rec, za, gb, None,
            vt.raster_trans_plain(supers, blocks, rec, gb, w, h))


def kernel_planes(inputs, w, h, items, admit=None, windows=None):
    """The CUDA kernel's planes from its rules: each admitted (tile, row)
    pair (``admit``: (rows, tile y, tile x), by default the kernel's own)
    over its window (``windows``: rects, by default ``window_rects`` with
    the kernel's extent), keyed by each tile's work item of ``items``
    (``raster.hier_work_items``), each item's keys minimum-merged into the
    key plane, the planes decoded from it.  Returns (depth, id, admitted
    pairs)."""
    hits, ri, za, gb, bits, _ = inputs
    rows, ty, tx = admit or vt.admitted_rows(hits, w, bits=bits, gbounds=gb)
    rects = (vt.window_rects(ri, rows, ty, tx, gbounds=gb) if windows is None
             else windows(ri, rows, ty, tx))
    item = tr.hier_work_items(hits, items)[ty * (w // tr.TILE_W) + tx,
                                           rows // g.RASTER_BLOCK]
    assert bool((item >= 0).all())
    plane = torch.full((h * w,), vt.KEY_CLEAR, dtype=torch.int64)
    for i in range(items):
        sel = item == i
        keys = torch.full((h * w,), vt.KEY_CLEAR, dtype=torch.int64)
        vt.window_keys(keys, ri, za, rows[sel], rects[sel], ty[sel], tx[sel],
                       w)
        plane = torch.minimum(plane, keys)
    return (*vt.key_planes(plane, w, h), rows)


@pytest.mark.parametrize("items", [1, vt.VIS_ITEMS])
@pytest.mark.parametrize("kind", ["vis", "trans"])
@pytest.mark.parametrize("case", list(KEY_CASES))
def test_key_plane_equals_plain(case, kind, items):
    """The kernels' rules (hit words, admission, windows, one key a pixel,
    items merged through the key plane, the store) give the plain
    versions' depth bits and row ids in every row, the padding rows
    included."""
    ti, tf, w, h = KEY_CASES[case]()
    inputs = kernel_inputs(kind, ti, tf, w, h)
    depth, idx, rows = kernel_planes(inputs, w, h, items)
    plain_d, plain_i = inputs[-1]
    _bits(depth, plain_d)
    _bits(idx, plain_i)
    if case == "padded_soup_128x64":  # rows 56-63 are padding
        assert int((depth[56:] < 1.0).sum()) == {"vis": 451, "trans": 0}[kind]
    if case.startswith("neg_zero"):
        zero = depth == 0.0
        assert int(zero.sum()) > 100 and set(idx[zero].tolist()) == {0}
        assert bool((torch.signbit(depth[zero])
                     == case.startswith("neg_zero_first")).all())
    if case == "z_one_128x32":
        assert not bool(((depth == 1.0) & (idx >= 0)).any())
    if case == "empty_128x32":
        assert rows.numel() == 0 and bool((idx == vt.NO_ROW).all())
    else:
        assert bool((idx >= 0).any())


def test_vis_admission_by_own_bbox_loses_padding_pixels():
    """K10vis must admit every row of a hit group: admitting each row by
    its own clamped bbox, as K5 does, leaves the visible rows as they
    were but loses the padding-row pixels of the rows clamped empty below
    the frame."""
    ti, tf, w, h = padded_setup()
    inputs = kernel_inputs("vis", ti, tf, w, h)
    hits, ri, _, _, bits, (plain_d, plain_i) = inputs
    rows, ty, tx = vt.admitted_rows(hits, w, bits=bits)
    r = ri[rows].to(torch.int64)
    r0, c0 = ty * tr.TILE_H, tx * tr.TILE_W
    own = ((r[:, g.I_JMAX] >= c0) & (r[:, g.I_JMIN] < c0 + tr.TILE_W)
           & (r[:, g.I_IMAX] >= r0) & (r[:, g.I_IMIN] < r0 + tr.TILE_H)
           & (r[:, g.I_JMIN] <= r[:, g.I_JMAX])
           & (r[:, g.I_IMIN] <= r[:, g.I_IMAX]))
    depth, idx, _ = kernel_planes(inputs, w, h, 1,
                                  admit=(rows[own], ty[own], tx[own]))
    _bits(depth[:56], plain_d[:56])
    _bits(idx[:56], plain_i[:56])
    drawn = int((depth[56:] < 1.0).sum())
    assert int((plain_d[56:] < 1.0).sum()) == 451 and drawn < 451


def test_trans_whole_tile_window_draws_padding_rows():
    """K10trans's windows must stay inside its groups' 4-row chunks: the
    vertices' bbox over the whole tile leaves the visible rows as they
    were but draws in rows 56-63, which the chunks never reach."""
    ti, tf, w, h = padded_setup()
    inputs = kernel_inputs("trans", ti, tf, w, h)
    plain_d, plain_i = inputs[-1]
    depth, idx, _ = kernel_planes(
        inputs, w, h, 1, windows=lambda ri, rows, ty, tx: vt.window_rects(
            ri, rows, ty, tx))
    _bits(depth[:56], plain_d[:56])
    _bits(idx[:56], plain_i[:56])
    assert int((plain_d[56:] < 1.0).sum()) == 0
    assert int((depth[56:] < 1.0).sum()) > 0


ITEM_CASES = ["padded_soup_128x64", "clipped_soup_384x128",
              "test_scene_256x64"]


@pytest.mark.parametrize("kind", ["vis", "trans"])
@pytest.mark.parametrize("case", ITEM_CASES)
def test_work_items_cover_the_admitted_groups(case, kind):
    """Each tile's hit words (``raster.hier_hit_words`` of the kernel's hit
    blocks; K10vis's from the bitmap) give every hit block one of the
    tile's work items at any count, and the hit blocks hold every (tile,
    8-row group) pair the plain version visits: the bitmap's bits under
    the superblock test (K10vis), the group, block and superblock bbox
    tests (K10trans)."""
    ti, tf, w, h = setup(case)
    hits, _, _, gb, bits, _ = kernel_inputs(kind, ti, tf, w, h)
    _, before, count = tr.hier_hit_words(hits)
    assert torch.equal(count, hits.sum(1)) and not before[:, 0].any()
    for n in (1, 4, vt.VIS_ITEMS, 64):
        item = tr.hier_work_items(hits, n)
        assert torch.equal(item >= 0, hits) and int(item.max()) < n
        # Each item takes a run of hit blocks in row order.
        assert bool(((item.cummax(1).values == item) | ~hits).all())
    rows, ty, tx = vt.admitted_rows(hits, w, bits=bits, gbounds=gb)
    tiles = (h // tr.TILE_H) * (w // tr.TILE_W)
    walked = torch.zeros((tiles, hits.shape[1] * g.RASTER_BLOCK // vt.GROUP),
                         dtype=torch.bool)
    walked[ty * (w // tr.TILE_W) + tx, rows // vt.GROUP] = True
    ty_n, tx_n = h // tr.TILE_H, w // tr.TILE_W
    if kind == "vis":
        supers, bits, ti_c, _, _ = vt.prepare_vis_inputs(T(ti), T(tf), w, h)
        ng = ti_c.shape[0] // vt.GROUP
        word_bits = (bits[:, :, None] >> torch.arange(32, dtype=torch.int32)
                     ) & 1
        want = word_bits.bool().reshape(tiles, -1)[:, :ng] & tr._tile_hits(
            supers, ty_n, tx_n)[:, torch.arange(ng) // (
                g.SUPER_BLOCK * g.RASTER_BLOCK // vt.GROUP)]
    else:
        supers, blocks, rec, gb, _ = vt.prepare_trans_inputs(T(ti), T(tf))
        ng = gb.shape[0]
        block = torch.arange(ng) // (g.RASTER_BLOCK // vt.TRANS_GROUP)
        want = (tr._tile_hits(gb, ty_n, tx_n)
                & tr._tile_hits(blocks, ty_n, tx_n)[:, block]
                & tr._tile_hits(supers, ty_n, tx_n)[:, block // g.SUPER_BLOCK])
    assert torch.equal(walked[:, :ng], want)
    assert not walked[:, ng:].any() and bool(want.any())
