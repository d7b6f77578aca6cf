"""The port's sharded frames (zrenderer_tpu_torch/parallel/tiles.py and
multihost.py) in 2 and 4 CPU processes joined by a gloo process group,
bit-equal to the port's single-device CPU frames and, on the flat cases,
to the reference's ``raster_xla.render_frame_jit``.

Each test starts its ranks as ``python tests/test_torch_sharding.py
<spec>`` (one torch thread each), which meet through a file store in the
test's own temporary directory; each rank writes its band, and the test
lays the bands side by side.  A rank that hangs
fails its test at the ``communicate`` timeout instead of stalling the
suite.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120
W, H = 256, 128  # 2 bands of 64 rows, or 4 of 32


def _soup(n_tris=384, seed=7, shift=False):
    """A soup with near-plane crossings (fan rows); ``shift`` moves 200
    triangles far right of the frame (empty, negative column footprints)."""
    from zrenderer_tpu_torch.scene.procedural import make_triangle_soup

    scene, md = make_triangle_soup(n_tris, seed=seed, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(40, 60):
        v[3 * t, 2] += 15.0
    if shift:
        v[:600, 0] += 40.0
    return scene, md


def _flat_inputs(spec):
    """(positions, attrs, tri_vidx, matrices, node_ids) of the spec's
    scene at W x H, NumPy, padded to a multiple of 4 shards."""
    from zrenderer_tpu_torch.engine.upload import flatten_scene
    from zrenderer_tpu_torch.ops import geometry as tg

    scene, md = _soup(**spec.get("scene", {}))
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = tg.view_proj_from_camera(scene.active_camera, W, H)
    if "jitter" in spec:
        from zrenderer_tpu_torch.ops.taa import jittered_view_proj
        vp = jittered_view_proj(vp, spec["jitter"], W, H)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    return (flat.positions, flat.attrs, flat.tri_vidx, mats, flat.vert_node)


def _deferred_renderer(materials="triangle", device="cpu"):
    """The deferred test scene with 8 random lights and random material
    constants: ``materials`` "triangle" a table of every triangle's, "draw"
    a per-draw table of T/2 rows (as many as a shard of 2 has triangles).
    Returns (renderer, the table to shard); the renderer's own buffer holds
    the table expanded to its triangles."""
    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import Renderer
    from zrenderer_tpu_torch.scene.procedural import make_test_scene

    r = Renderer(RenderConfig(width=W, height=H, pipeline="deferred",
                              tri_align=64), device=device)
    r.load_scene(*make_test_scene())
    rng = np.random.default_rng(3)
    pos = rng.uniform(-4, 4, (8, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1]) + 1.0
    col = rng.uniform(0.2, 3.0, (8, 3)).astype(np.float32)
    r.set_environment(lights=(pos, col))
    import torch

    b = r._buffers()
    mats = b["materials"]
    gen = torch.Generator().manual_seed(9)
    if materials == "triangle":
        table = torch.rand(mats.shape, dtype=mats.dtype, generator=gen)
        mats.copy_(table)
    else:
        table = torch.rand((mats.shape[0] // 2, mats.shape[1]),
                           dtype=mats.dtype, generator=gen)
        mats.copy_(table[b["vert_node"][b["tri_vidx"][:, 0].long()].long()])
    return r, table


def _deferred_args(r, table):
    c = r._lit_constants()
    b = {k: v.numpy() for k, v in r._buffers().items()}
    return (b["positions"], b["attrs"], b["tri_vidx"], c["matrices"],
            b["vert_node"], c["normal_mats"], table.numpy(),
            c["inv_view_proj"], c["cam_pos"], r.lights[0], r.lights[1],
            c["view_proj"])


TAA_FRAMES = 3


def _rank_main(spec):
    """One rank: join the group, run the spec's frame, save its band."""
    import torch

    torch.set_num_threads(1)
    from zrenderer_tpu_torch.parallel import multihost, tiles

    rank, n = spec["rank"], spec["n"]
    multihost.initialize(num_processes=n, process_id=rank, device="cpu",
                         init_method=spec["init"])
    kind = spec["kind"]
    out = {}
    if kind == "deferred":
        frame_fn, shard = tiles.make_sharded_deferred_frame(
            None, W, H, device="cpu")
        rgba, depth = frame_fn(*shard(*_deferred_args(
            *_deferred_renderer(spec["materials"]))))
    elif kind == "taa":
        from zrenderer_tpu_torch.ops.taa import jitter_sequence

        taa_frame, shard = tiles.make_sharded_taa_frame(None, W, H,
                                                        device="cpu")
        hist = None
        for j in jitter_sequence(TAA_FRAMES):
            args = shard(*_flat_inputs(dict(spec, jitter=j.tolist())))
            rgba, depth, hist = taa_frame(*args, hist)
        out["hist"] = hist.numpy()
    else:
        if kind == "grid":
            frame_fn, shard = tiles.make_sharded_frame_2d(
                None, 2, W, H, spec["binning"], device="cpu")
        elif kind == "multihost":
            group = multihost.global_tile_mesh()
            frame_fn, shard = multihost.make_multihost_frame(
                group, W, H, spec["binning"], device="cpu")
        else:
            frame_fn, shard = tiles.make_sharded_frame(
                None, W, H, spec["binning"], device="cpu")
        if "slab" in spec:
            from zrenderer_tpu_torch.ops import raster

            raster.DIST_SLAB_RECORDS = spec["slab"]
        rgba, depth = frame_fn(*shard(*_flat_inputs(spec)))
        if kind == "multihost":
            (row0, rows), = multihost.local_bands(rgba)
            out["row0"] = np.int64(row0)
            assert np.array_equal(rows, rgba.numpy())
            out["frame"] = multihost.gather_frame(rgba)
            out["depth_frame"] = multihost.gather_frame(depth)
    out.update(rgba=rgba.numpy(), depth=depth.numpy())
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def _store(tmp_path) -> str:
    """A rendezvous only this test's ranks can join."""
    return f"file://{tmp_path / 'store'}"


def _run_ranks(tmp_path, n, **spec):
    """Start n ranks of ``spec``; returns each rank's saved arrays."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(n):
        arg = json.dumps(dict(spec, rank=rank, n=n, init=_store(tmp_path),
                              out=str(tmp_path)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), arg], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]


def _assemble(outs, bands=None):
    bands = range(len(outs)) if bands is None else bands
    return (np.concatenate([outs[b]["rgba"] for b in bands]),
            np.concatenate([outs[b]["depth"] for b in bands]))


def _bits(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32))


def _single_flat(spec):
    """The port's single-device CPU frame of the spec's scene."""
    import torch

    from zrenderer_tpu_torch.ops import geometry as tg
    from zrenderer_tpu_torch.ops import raster as tr

    pos, attrs, vidx, mats, node = map(torch.from_numpy, _flat_inputs(spec))
    ti, tf = tg.geometry_pipeline(pos, attrs, vidx, mats, node, W, H)
    color, depth = tr.rasterize_setup(ti, tf, W, H)
    return tr.unpack_rgba8(color).numpy(), depth.numpy()


def _jax_flat(spec):
    from zrenderer_tpu.ops import raster_xla

    rgba, depth = raster_xla.render_frame_jit(*_flat_inputs(spec), W, H)
    return np.asarray(rgba), np.asarray(depth)


def _check_flat(rgba, depth, spec, jax_too=True):
    """Bit-equal to the port's single-device frame; against the
    reference's XLA frame the contract of test_torch_renderer.py
    (docs/RASTER_SPEC.md §5: XLA:CPU contracts the setup's f32 chains):
    coverage exact, depth within 2e-6, u8 within 1 LSB."""
    ref_rgba, ref_depth = _single_flat(spec)
    assert (ref_depth < 1.0).mean() > 0.1
    np.testing.assert_array_equal(rgba, ref_rgba)
    _bits(depth, ref_depth)
    if jax_too:
        jrgba, jdepth = _jax_flat(spec)
        np.testing.assert_array_equal(depth < 1.0, jdepth < 1.0)
        np.testing.assert_allclose(depth, jdepth, rtol=0, atol=2e-6)
        assert np.abs(rgba.astype(np.int32)
                      - jrgba.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("binning", ["auto", "hierarchy", "tile_lists",
                                     "dist"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_frame_matches_single_device(tmp_path, n, binning):
    spec = dict(kind="flat", binning=binning)
    outs = _run_ranks(tmp_path, n, **spec)
    assert all(o["rgba"].shape == (H // n, W, 4) for o in outs)
    _check_flat(*_assemble(outs), spec)


def test_sharded_dist_slab_overflow_demotes(tmp_path):
    """A 16-record slab (256 after rounding) on a 2048-triangle soup, 200
    of its triangles far right of the frame: rows are demoted to the
    owners' hierarchies and the frame is unchanged (the reference's
    tests/test_sharding.py:357)."""
    spec = dict(kind="flat", binning="dist", slab=16,
                scene=dict(n_tris=2048, seed=17, shift=True))
    _check_flat(*_assemble(_run_ranks(tmp_path, 2, **spec)), spec)


@pytest.mark.parametrize("binning", ["auto", "tile_lists"])
def test_sharded_frame_2d_matches_single_device(tmp_path, binning):
    """The 2 x 2 geom x tiles grid: ranks 0 and 2 render band 0, ranks 1
    and 3 band 1; both copies equal."""
    spec = dict(kind="grid", binning=binning)
    outs = _run_ranks(tmp_path, 4, **spec)
    for a, b in ((0, 2), (1, 3)):
        np.testing.assert_array_equal(outs[a]["rgba"], outs[b]["rgba"])
        _bits(outs[a]["depth"], outs[b]["depth"])
    _check_flat(*_assemble(outs, (0, 1)), spec)


def test_multihost_local_bands_and_gather_frame(tmp_path):
    """``global_tile_mesh`` keeps the launcher's host-major order,
    ``local_bands`` gives each rank its rows, ``gather_frame`` the whole
    frame on every rank."""
    spec = dict(kind="multihost", binning="auto")
    outs = _run_ranks(tmp_path, 4, **spec)
    rgba, depth = _assemble(outs)
    for r, o in enumerate(outs):
        assert int(o["row0"]) == r * H // 4
        np.testing.assert_array_equal(o["frame"], rgba)
        _bits(o["depth_frame"], depth)
    _check_flat(rgba, depth, spec, jax_too=False)


def _check_deferred(tmp_path, materials):
    outs = _run_ranks(tmp_path, 2, kind="deferred", materials=materials)
    rgba, depth = _assemble(outs)
    r, _ = _deferred_renderer(materials)
    img, ref_depth = r.render_and_read()
    assert (ref_depth < 1.0).mean() > 0.1
    np.testing.assert_array_equal(rgba, img)
    _bits(depth, ref_depth)


def test_sharded_deferred_matches_single_device(tmp_path):
    """K9g + K7 per band (2 ranks), a random per-triangle material table
    split with the triangles: equal to the port's single-device deferred
    frame."""
    _check_deferred(tmp_path, "triangle")


def test_sharded_deferred_per_draw_table_of_shard_length(tmp_path):
    """A per-draw material table with as many rows as a shard has
    triangles is expanded to the triangles before the split, not read per
    triangle by each shard: equal to the single-device deferred frame."""
    _check_deferred(tmp_path, "draw")


def test_sharded_taa_matches_single_device(tmp_path):
    """Config 4 sharded over 2 ranks, 3 jittered frames with the halo-row
    resolve and band-local histories: the resolved frame and history equal
    the single-device frames through ``taa_resolve``."""
    import torch

    from zrenderer_tpu_torch.ops import taa

    outs = _run_ranks(tmp_path, 2, kind="taa", binning="auto")
    hist = None
    for j in taa.jitter_sequence(TAA_FRAMES):
        frame, depth = _single_flat(dict(jitter=j.tolist()))
        frame = torch.from_numpy(frame)
        if hist is None:
            hist = taa.taa_init_history(frame)
        hist, resolved = taa.taa_resolve(hist, frame)
    rgba, last_depth = _assemble(outs)
    np.testing.assert_array_equal(rgba, resolved.numpy())
    _bits(last_depth, depth)
    np.testing.assert_array_equal(
        np.concatenate([o["hist"] for o in outs]), hist.numpy())


def test_sharded_frames_refuse_bad_splits(tmp_path):
    """Heights that do not split into whole tile bands, triangle counts
    that do not split into shards and unknown binnings raise."""
    import torch
    import torch.distributed as dist

    from zrenderer_tpu_torch.parallel import tiles

    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=_store(tmp_path),
                                world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="bands"):
            tiles.make_sharded_frame(None, W, 100, device="cpu")
        with pytest.raises(ValueError, match="binning"):
            tiles.make_sharded_frame(None, W, H, "small", device="cpu")
        with pytest.raises(ValueError, match="binning"):
            tiles.make_sharded_frame_2d(None, 1, W, H, "dist", device="cpu")
        with pytest.raises(ValueError, match="grid"):
            tiles.make_sharded_frame_2d(None, 2, W, H, device="cpu")
        _, shard = tiles.make_sharded_frame(None, W, H, device="cpu")
        args = _flat_inputs({})
        assert shard(*args)[2].shape == torch.Size(args[2].shape)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(json.loads(sys.argv[1]))
