#!/usr/bin/env python3
"""Same-call A/B of the raster kernels K1, K2g, K2d, K3, K3b, K3g, K3d, K4,
K4c, K4g, K4d, K5, K5g, K6, K6g, K6d, K9 and K9d, the two-class
experiments K10hbm2 and K10scan, the visibility-buffer experiments K10vis
and K10trans, the group-tile and lane-parallel experiments K10g8, K10g8g,
K10g8d, K10vec and K10vecg, the tiled light kernel K7 and the overlay
kernels K8 and K8b, and of the
frames whose pace they set, between this tree and another checkout (for
example a parent commit unpacked with ``git archive``) on one CUDA card;
or, with ``--sweep``, this tree's K5 and K5g on the 1M lattice at each
work-item count of SWEEP_ITEMS, K10hbm2 and K10scan at each count of
SWEEP_TWOCLASS_ITEMS (``twoclass_sweep``), K10vis and K10trans at each
count of SWEEP_VIS_ITEMS (``vis_sweep``), K10vec and K10g8, K10vecg and
K10g8g on the lit rows, and K10g8d on the 20K lattice's shadow map, at
each count of SWEEP_X_ITEMS (``x_sweep``), K6, K6g, K6d and K9d at each
item size of SWEEP_RECORDS and halved toward each item count of
SWEEP_MIN_ITEMS (``record_sweep``), and K1 and K2d at each count of
SWEEP_SMALL_BLOCKS blocks a tile (``small_sweep``).

    python3 chip_ab.py --other path/to/checkout [--small]
    python3 chip_ab.py --sweep

Each tree runs in a process of its own, which builds that tree's kernels,
in turns: other, this, this, other.  Every run uses chip_smoke.py's sizes
and builders (``lit_frame_rows``, ``deferred_frame_inputs``,
``baseline_lights``, ``checker_texture``) from this tree on the tree's own
package.  A run times K1 on the flat 1080p test scene's inputs, K2g on
the lit one's and K2d on the shadowed one's 1024x1024 map (CUDA events
and device busy ms a call from a trace of as many calls, ``small_ms``:
the launchers' host work outlasts these kernels), the flat and the
shadowed test-scene frames, K8 and K8b on the --ui windows' draw list
over the flat test scene (``small_ms``) and K8b a launch inside traced
--ui app frames (``ui_frame_ms``), then, with CUDA events after a
warm-up: K3 on the flat 20K lattice's inputs (the hierarchy prepare, the
padded 1080p target) and K6 on its ``tile_lists`` inputs (the row-id
spans), K3b on band 0 of its 2 bands at 1920x544 (the rows gathered from
2 shards), and so on the 40K lattice's
(52 288 rows, 13 superblocks), K3g on the lit 20K lattice's inputs and K6g
on its ``tile_lists`` inputs, K3d on its 1024x1024 shadow map, K6d on the
same map's ``tile_lists`` inputs, K9d on band 0 of the 40K lattice's 2
``dist`` bands at 1920x544 (each shard's slabs through the in-turn
all-to-all, ``tiles.dist_exchange``, then the owner's prepare), K5 on the
flat 40K and 1M lattices' and the 1M lattice's shadow map's hierarchy
inputs, K10hbm2, K10scan, K10vis, K10trans, K10vec and K10g8 on the flat
1M lattice's rows (their own prepares), K10vecg and K10g8g on the lit 40K
and 1M lattices', K10g8d on the 20K lattice's 1024x1024 shadow map, K4 on the
flat and K4g on the lit 1M lattice's inputs (``auto``),
K9 on band 0 of the flat 1M lattice's 2 bands at 1920x544 (the rows
gathered from 2 shards, the band-local prepare, as ``tiles.band_raster``
makes it), K4c on the 1M soup's ``tile_lists`` inputs (the coarse class),
K4d on the 1M lattice's shadow map, K5g on the lit 1M lattice
(``hierarchy``), K7 on the deferred test scene's 1080p G-buffer with
BASELINE config 3's wide and r2 lights (f32 planes), and ms/frame of
``render_animation`` on the flat, the lit and the shadowed 20K lattice
(``auto`` and ``tile_lists``: K6; K6g; K6d and K6g), the flat, lit and
shadowed 1M lattice (``auto``) and the deferred test scene with the wide
lights at 1080p, of the flat, lit and shadowed 1M lattice through
``binning="hierarchy"`` (K5, K5g, K5 on the map), and of the flat 20K and
1M lattices in 2 bands rendered in turn (``tiles.bands_in_turn``,
1920x1088) and of the 40K lattice in 2 ``dist`` bands, and the device busy
ms per frame of the flat 20K frame, of the flat, the lit and the shadowed
20K ``tile_lists`` frames, of the six 1M frames and of those three banded
frames (one traced run each: ``chip_smoke.device_trace``, the union of the
device operations' intervals) and of the flat and the shadowed
test-scene frames; with ``--small``, only K1, K2d, K2g, the two
test-scene frames, K8 and K8b. Every run must give the same planes
(their digests are compared). Prints the card's name and power limit
first, then one JSON line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
# Work items a tile that ``--sweep`` times K5 and K5g at, and K10hbm2 and
# K10scan.
SWEEP_ITEMS = (1, 4, 8, 16, 32, 64)
SWEEP_TWOCLASS_ITEMS = (1, 4, 8, 16, 32)
# Work items a tile that ``--sweep`` times K10vis and K10trans at, and
# K10vec and K10g8.
SWEEP_VIS_ITEMS = (1, 4, 8, 16, 32)
SWEEP_X_ITEMS = (1, 4, 8, 16, 32)
# Records an item that ``--sweep`` times K6, K6g, K6d and K9d at, never
# halved, and
# the items their 256 records are halved to aim at.
SWEEP_RECORDS = (16, 32, 64, 128, 256)
SWEEP_MIN_ITEMS = (512, 1024, 2048, 4096)
# Frames of each traced 1M ``hierarchy`` run.
BUSY_FRAMES_1M = 5
# Blocks a tile that ``--sweep`` times K1 and K2d at (the C entries
# zr_raster_small_blocks and zr_depth_small_blocks), and the calls a
# small-kernel timing runs (CUDA events; the same count traced).
SWEEP_SMALL_BLOCKS = (1, 2, 4, 8)
SMALL_CALLS = 50
# --ui app frames traced for K8b's time a launch inside the frame.
UI_FRAMES = 10


def event_ms(fn, reps):
    """ms per call from CUDA events around ``reps`` calls, after one."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def digest(*planes):
    """The planes' int32 sum: equal planes, equal digests."""
    import torch

    return int(sum(int(p.contiguous().view(torch.int32).to(torch.int64)
                       .sum().item()) for p in planes))


def small_ms(fn, calls=SMALL_CALLS):
    """A small kernel's ms a call from CUDA events around ``calls`` calls
    (host dispatch included: the launcher's checks take longer than these
    kernels), and its device busy ms a call from one traced run of as
    many calls (``chip_smoke.device_trace``)."""
    events, _ = cs.device_trace(lambda: [fn() for _ in range(calls)])
    return {"ms": event_ms(fn, calls),
            "busy_ms": cs.busy_us(events) / 1000.0 / calls}


def test_scene():
    from zrenderer_tpu_torch.scene.mesh import MeshData
    from zrenderer_tpu_torch.scene.scene import Scene

    return (Scene.load(os.path.join(cs.SCENE_DIR, "scene.bin")),
            MeshData.load(os.path.join(cs.SCENE_DIR, "meshes.bin")))


def small_prepares():
    """K1's inputs of the flat 1080p test-scene frame and K2d's of the
    shadowed one's 1024x1024 map: {key: (prepare, (w, h))}."""
    from zrenderer_tpu_torch.ops import raster

    scene_md, s = test_scene(), cs.SHADOW_SIZE
    r = renderer(scene_md)
    flat = raster.prepare_binned_small(*cs.frame_rows(r), cs.PAD_W, cs.PAD_H)
    r = renderer(scene_md, pipeline="shadowed", shadow_size=s)
    r.set_environment()
    return {"k1": (flat, (cs.PAD_W, cs.PAD_H)),
            "k2d": (raster.prepare_binned_small(*cs.light_rows(r), s, s),
                    (s, s))}


def small_sweep() -> dict:
    """K1 on the flat test scene's inputs and K2d on the shadowed test
    scene's map at each count of SWEEP_SMALL_BLOCKS blocks a tile
    (``small_ms``), every count's planes equal."""
    from zrenderer_tpu_torch.ops import _build, raster

    lib = _build.load_library()
    out = {"k1": {}, "k2d": {}}
    for key, (prep, (w, h)) in small_prepares().items():
        args = raster._small_args(*prep, w, h)
        dev = prep[4].device
        ref = None
        for b in SWEEP_SMALL_BLOCKS:
            if key == "k1":
                def entry(*a, b=b):
                    return lib.zr_raster_small_blocks(b, *a)

                def call():
                    return raster._run(entry, dev, w, h, *args)
            else:
                def entry(*a, b=b):
                    return lib.zr_depth_small_blocks(b, *a)

                def call():
                    return (raster._run_depth(entry, dev, w, h, *args),)
            out[key][b] = small_ms(call)
            d = digest(*call())
            if ref is not None and d != ref:
                raise AssertionError(f"{key}: {b} blocks a tile changed the "
                                     "planes")
            ref = d
    return out


def ui_inputs(scene_md):
    """K8's and K8b's inputs of the --ui windows over the flat 1080p test
    scene: (K8's setup rows, the rendered frame, the atlas), on the card,
    and the renderer and the --ui overlay that made them."""
    import torch

    from zrenderer_tpu_torch.app.draw_list import padded_count
    from zrenderer_tpu_torch.app.font import UIAtlas
    from zrenderer_tpu_torch.app.overlay_ui import ImguiOverlay, atlas_on

    ui = ImguiOverlay(cs.WIDTH, cs.HEIGHT, device="cuda")
    dl = ui.draw_list(cs.UI_STATS_TEXT, scene_md[0])
    ti, tf = dl.setup(padded_count(len(dl)))
    rows = (torch.from_numpy(ti).to("cuda"), torch.from_numpy(tf).to("cuda"))
    r = renderer(scene_md)
    return (rows, r.render()[0], atlas_on(UIAtlas(), "cuda")), (r, ui)


def ui_frame_ms(r, ui) -> float:
    """K8b's device ms a launch inside UI_FRAMES traced --ui app frames of
    renderer ``r`` (rendered, composited by ``ui``, read back), its inputs
    fresh from the frame rather than L2-warm from a loop over them."""
    events, _ = cs.device_trace(lambda: [
        ui.compose(r.render()[0], cs.UI_STATS_TEXT, r.scene)
        for _ in range(UI_FRAMES)])
    durs = [d for n, _, d in events if "overlay_composite_kernel" in n]
    if len(durs) != UI_FRAMES:
        raise AssertionError(f"k8b: {len(durs)} launches traced in "
                             f"{UI_FRAMES} --ui app frames")
    return sum(durs) / len(durs) / 1000.0


def renderer(scene_md, **kw):
    """A 1080p Renderer on the card with ``scene_md`` loaded."""
    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import Renderer

    r = Renderer(RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                              tri_align=256, **kw), device="cuda")
    r.load_scene(*scene_md)
    return r


def indexed_args(r, height):
    """The renderer's indexed buffers and per-draw matrices at (WIDTH,
    height): a sharded frame's inputs."""
    import numpy as np
    import torch

    from zrenderer_tpu_torch.ops import geometry as tg

    b = r._buffers()
    vp = tg.view_proj_from_camera(r.scene.active_camera, cs.WIDTH, height)
    mats = np.einsum("nij,jk->nik", r.flat.node_to_world,
                     vp).astype(np.float32)
    return (b["positions"], b["attrs"], b["tri_vidx"],
            torch.from_numpy(mats).to("cuda"), b["vert_node"])


def record_sweep() -> dict:
    """K6 and K6g on the flat and the lit 20K lattice's 1080p frames and
    K6d on its shadow map's 1024x1024 map (``tile_lists``: pair_tri as
    prepared, n_head * cap slots; K6d's also trimmed to the spans' end, so
    that the launch's grid counts no empty slot) and K9d on
    band 0 of the 40K lattice's 2 ``dist`` bands at 1920x544 (two slabs of
    32768 rows) at each ITEM_RECORDS of SWEEP_RECORDS never halved
    (KEYED_MIN_ITEMS 0) and at 256 halved toward each KEYED_MIN_ITEMS of
    SWEEP_MIN_ITEMS: ms a call (CUDA events over 20 calls) and device busy
    ms a call (one traced run of 5 calls), every setting's planes equal."""
    from zrenderer_tpu_torch.ops import raster
    from zrenderer_tpu_torch.parallel import tiles
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene

    s, w, h = cs.SHADOW_SIZE, cs.PAD_W, cs.PAD_H
    lattice = make_stress_scene(20000)
    r = renderer(lattice, binning="tile_lists")
    flat = raster.prepare_binned_inputs(*cs.frame_rows(r), w, h)
    r = renderer(lattice, pipeline="lit", binning="tile_lists")
    r.set_environment(texture=cs.checker_texture())
    lit = raster.prepare_binned_inputs(*cs.lit_frame_rows(r), w, h)
    r = renderer(lattice, pipeline="shadowed", shadow_size=s,
                 binning="tile_lists")
    r.set_environment()
    k6 = raster.prepare_binned_inputs(*cs.light_rows(r), s, s)
    r = renderer(make_stress_scene(cs.MID_TRIS))
    locals_, ti, tf, s2 = tiles.setups_in_turn(
        2, *indexed_args(r, 1088), cs.PAD_W, 1088)
    k9 = raster.prepare_binned_dist_owner(ti, tf, *tiles.dist_exchange(
        tiles.InTurnExchange(2), locals_, cs.PAD_W, 1088, s2)[0])
    del r, locals_, ti, tf
    cases = {
        "k6": (raster.raster_lists_kernel, flat, (w, h)),
        "k6g": (raster.gbuffer_lists_kernel, lit, (w, h)),
        "k6d": (raster.depth_lists_kernel, k6, (s, s)),
        "k6d trimmed": (raster.depth_lists_kernel,
                        (k6[0], k6[1][:int(k6[0][-1].item())], *k6[2:]),
                        (s, s)),
        "k9d": (raster.raster_binned_band_dist_kernel, k9,
                (cs.PAD_W, 544, 0)),
    }
    out = {"pair_tri slots": k6[1].shape[0],
           "k6 span entries": int((flat[0][-1] - flat[0][0]).item()),
           "k6g span entries": int((lit[0][-1] - lit[0][0]).item()),
           "k6d span entries": int((k6[0][-1] - k6[0][0]).item()),
           "k9d span records": int((k9[0][:, -1] - k9[0][:, 0]).sum().item())}
    saved = raster.ITEM_RECORDS, raster.KEYED_MIN_ITEMS
    settings = ([(n, 0) for n in SWEEP_RECORDS]
                + [(256, m) for m in SWEEP_MIN_ITEMS])
    for key, (kern, prep, tail) in cases.items():
        ref = None
        out[key] = {}
        for n, m in settings:
            raster.ITEM_RECORDS, raster.KEYED_MIN_ITEMS = n, m

            def call():
                planes = kern(*prep, *tail)
                return (tuple(planes) if isinstance(planes, (tuple, list))
                        else (planes,))

            events, _ = cs.device_trace(lambda: [call() for _ in range(5)])
            out[key][f"{n}/{m}"] = {"ms": event_ms(call, 20),
                                    "busy_ms": cs.busy_us(events) / 5000.0}
            d = digest(*call())
            if ref is not None and d != ref:
                raise AssertionError(f"{key}: {n} records an item, {m} "
                                     "aimed at, changed the planes")
            ref = d
    raster.ITEM_RECORDS, raster.KEYED_MIN_ITEMS = saved
    return out


def twoclass_cases(rows, height):
    """K10hbm2's and K10scan's (kernel, prepared inputs) on ``rows``."""
    from zrenderer_tpu_torch.ops.experiments import (raster_hbm2,
                                                     raster_scanline)

    return {"k10hbm2": (raster_hbm2.raster_hbm2_kernel,
                        raster_hbm2.prepare_raster_inputs_2class(*rows)),
            "k10scan": (raster_scanline.raster_scanline_kernel,
                        raster_scanline.prepare_scanline_inputs(*rows,
                                                                height))}


def twoclass_sweep(rows=None) -> dict:
    """K10hbm2 and K10scan on the flat 1M lattice's rows (``rows``, or
    the renderer's) at each work-item count of SWEEP_TWOCLASS_ITEMS (ms a
    call, CUDA events), every count's planes equal."""
    from zrenderer_tpu_torch.ops.experiments import raster_hbm2
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene

    w, h = cs.PAD_W, cs.PAD_H
    if rows is None:
        rows = cs.frame_rows(renderer(make_stress_scene(cs.LARGE_TRIS)))
    out = {}
    saved = raster_hbm2.TWOCLASS_ITEMS
    try:
        for key, (kern, prep) in twoclass_cases(rows, h).items():
            out[key], ref = {}, None
            for n in SWEEP_TWOCLASS_ITEMS:
                raster_hbm2.TWOCLASS_ITEMS = n
                out[key][n] = event_ms(lambda: kern(*prep, w, h), 10)
                d = digest(*kern(*prep, w, h))
                if ref is not None and d != ref:
                    raise AssertionError(f"{key}: {n} items a tile changed "
                                         "the planes")
                ref = d
    finally:
        raster_hbm2.TWOCLASS_ITEMS = saved
    return out


def vis_cases(rows, width, height):
    """K10vis's and K10trans's (kernel, prepared inputs) on ``rows``."""
    from zrenderer_tpu_torch.ops.experiments import raster_vis_trans as vt

    return {"k10vis": (vt.raster_vis_kernel,
                       vt.prepare_vis_inputs(*rows, width, height)[:4]),
            "k10trans": (vt.raster_trans_kernel,
                         vt.prepare_trans_inputs(*rows)[:4])}


def vis_sweep(rows=None) -> dict:
    """K10vis and K10trans on the flat 1M lattice's rows (``rows``, or the
    renderer's) at each work-item count of SWEEP_VIS_ITEMS (ms a call,
    CUDA events), every count's planes equal."""
    from zrenderer_tpu_torch.ops.experiments import raster_vis_trans as vt
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene

    w, h = cs.PAD_W, cs.PAD_H
    if rows is None:
        rows = cs.frame_rows(renderer(make_stress_scene(cs.LARGE_TRIS)))
    out = {}
    saved = vt.VIS_ITEMS
    try:
        for key, (kern, prep) in vis_cases(rows, w, h).items():
            out[key], ref = {}, None
            for n in SWEEP_VIS_ITEMS:
                vt.VIS_ITEMS = n
                out[key][n] = event_ms(lambda: kern(*prep, w, h), 10)
                d = digest(*kern(*prep, w, h))
                if ref is not None and d != ref:
                    raise AssertionError(f"{key}: {n} items a tile changed "
                                         "the planes")
                ref = d
    finally:
        vt.VIS_ITEMS = saved
    return out


def x_cases(rows, width, height, gbuffer=False):
    """K10vec's and K10g8's (kernel, prepared inputs) on ``rows``, or with
    ``gbuffer`` K10vecg's and K10g8g's (lit rows)."""
    from zrenderer_tpu_torch.ops.experiments import raster_group8, raster_vec

    g = "g" if gbuffer else ""
    return {"k10vec" + g: (raster_vec.gbuffer_vec_kernel if gbuffer
                           else raster_vec.raster_vec_kernel,
                           raster_vec.prepare_vec_inputs(*rows)),
            "k10g8" + g: (raster_group8.gbuffer_group8_kernel if gbuffer
                          else raster_group8.raster_group8_kernel,
                          raster_group8.prepare_group8_inputs(*rows, width,
                                                              height))}


def lit_lattice_rows(scene_md):
    """The lit renderer's setup rows of ``scene_md`` (the checker
    texture)."""
    r = renderer(scene_md, pipeline="lit")
    r.set_environment(texture=cs.checker_texture())
    return cs.lit_frame_rows(r)


def x_sweep(rows=None, lit_rows=None) -> dict:
    """K10vec and K10g8 on the flat 1M lattice's rows (``rows``, or the
    renderer's), K10vecg and K10g8g on its lit rows (``lit_rows``, or the
    lit renderer's), and K10g8d on the 20K lattice's 1024x1024 shadow map,
    at each work-item count of SWEEP_X_ITEMS (ms a call, CUDA events),
    every count's planes equal."""
    from zrenderer_tpu_torch.ops.experiments import raster_group8, raster_vec
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene

    w, h, s = cs.PAD_W, cs.PAD_H, cs.SHADOW_SIZE
    if rows is None or lit_rows is None:
        lattice = make_stress_scene(cs.LARGE_TRIS)
        rows = rows or cs.frame_rows(renderer(lattice))
        lit_rows = lit_rows or lit_lattice_rows(lattice)
    r = renderer(make_stress_scene(20000), pipeline="shadowed",
                 shadow_size=s)
    r.set_environment()
    cases = {key: (kern, prep, (w, h))
             for key, (kern, prep) in {**x_cases(rows, w, h),
                                       **x_cases(lit_rows, w, h,
                                                 True)}.items()}
    cases["k10g8d"] = (raster_group8.depth_group8_kernel,
                       raster_group8.prepare_group8_inputs(
                           *cs.light_rows(r), s, s), (s, s))
    del r
    out = {}
    for key, (kern, prep, (kw, kh)) in cases.items():
        mod, attr = ((raster_vec, "VEC_ITEMS") if key.startswith("k10vec")
                     else (raster_group8, "G8_ITEMS"))
        saved = getattr(mod, attr)
        out[key], ref = {}, None
        try:
            for n in SWEEP_X_ITEMS:
                setattr(mod, attr, n)
                out[key][n] = event_ms(lambda: kern(*prep, kw, kh), 10)
                planes = kern(*prep, kw, kh)
                d = digest(*(planes if isinstance(planes, (list, tuple))
                             else (planes,)))
                if ref is not None and d != ref:
                    raise AssertionError(f"{key}: {n} items a tile changed "
                                         "the planes")
                ref = d
        finally:
            setattr(mod, attr, saved)
    return out


def sweep() -> dict:
    """K5 on the flat and K5g on the lit 1M lattice's hierarchy inputs at
    each item count of SWEEP_ITEMS (ms a call, CUDA events), every count's
    planes equal; then ``record_sweep``."""
    from zrenderer_tpu_torch.ops import raster
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene

    w, h = cs.PAD_W, cs.PAD_H
    lattice = make_stress_scene(cs.LARGE_TRIS)
    out = {"root": imported_root(), "k5": {}, "k5g": {}}
    r = renderer(lattice)
    rows = cs.frame_rows(r)
    flat = raster.prepare_raster_inputs(*rows)
    out["twoclass"] = twoclass_sweep(rows)
    out["vis"] = vis_sweep(rows)
    lit_rows = lit_lattice_rows(lattice)
    out["x"] = x_sweep(rows, lit_rows)
    del r, rows
    lit = raster.prepare_raster_inputs(*lit_rows)
    del lit_rows
    saved = raster.HIER_ITEMS
    for key, kern, prep in (("k5", raster.raster_hbm_kernel, flat),
                            ("k5g", raster.gbuffer_hbm_kernel, lit)):
        ref = None
        for n in SWEEP_ITEMS:
            raster.HIER_ITEMS = n
            out[key][n] = event_ms(lambda: kern(*prep, w, h), 10)
            d = digest(*kern(*prep, w, h))
            if ref is not None and d != ref:
                raise AssertionError(f"{key}: {n} items a tile changed the "
                                     "planes")
            ref = d
    raster.HIER_ITEMS = saved
    del lattice, flat, lit
    out["records"] = record_sweep()
    out["small"] = small_sweep()
    return out


def measure(small=False) -> dict:
    """One run in the tree that ``zrenderer_tpu_torch`` imports from;
    ``small``: the test scene's kernels and frames alone."""
    import torch

    from zrenderer_tpu_torch.ops import light_kernel, overlay, raster
    from zrenderer_tpu_torch.ops.experiments import raster_group8
    from zrenderer_tpu_torch.parallel import tiles
    from zrenderer_tpu_torch.scene.procedural import (make_stress_scene,
                                                      make_triangle_soup)

    def anim_ms(r, frames):
        r.render_animation(num_frames=frames)
        torch.cuda.synchronize()
        return event_ms(lambda: r.render_animation(num_frames=frames),
                        1) / frames

    def busy_ms(fn, frames=1):
        """Device busy ms per frame of one traced run of ``fn``."""
        events, _ = cs.device_trace(fn)
        return cs.busy_us(events) / 1000.0 / frames

    def frame_1m(r, label):
        """ms/frame, busy ms a frame and the frame's digest of a 1M
        renderer ``r``."""
        out["frames"][label] = anim_ms(r, cs.LARGE_FRAMES)
        out["busy"][label] = busy_ms(
            lambda: r.render_animation(num_frames=BUSY_FRAMES_1M),
            BUSY_FRAMES_1M)
        out["digests"][label] = digest(r.render()[0])

    w, h = cs.PAD_W, cs.PAD_H
    h2, band_h = 1088, 544
    out = {"root": imported_root(), "k1": {}, "k2g": {}, "k2d": {},
           "k3": {}, "k3b": {}, "k3g": {}, "k3d": {}, "k4": {}, "k4c": {},
           "k4d": {}, "k4g": {}, "k5": {}, "k5g": {}, "k6": {}, "k6g": {},
           "k6d": {}, "k7": {}, "k9": {}, "k9d": {}, "k10hbm2": {},
           "k10scan": {}, "k10vis": {}, "k10trans": {}, "k10vec": {},
           "k10g8": {}, "k10vecg": {}, "k10g8g": {}, "k10g8d": {},
           "k8": {}, "k8b": {}, "frames": {},
           "busy": {}, "digests": {}}
    # The test scene: K1 on the flat frame's inputs, K2g on the lit
    # frame's, K2d on the shadowed frame's map; the flat and the shadowed
    # frames.
    scene_md = test_scene()
    for key, (prep, (pw, ph)) in small_prepares().items():
        kern = (raster.raster_small_kernel if key == "k1"
                else raster.depth_small_kernel)
        label = "test scene" if key == "k1" else "test scene map"
        out[key][label] = small_ms(lambda: kern(*prep, pw, ph))
        planes = kern(*prep, pw, ph)
        out["digests"][f"{key} {label}"] = digest(
            *(planes if key == "k1" else (planes,)))
    r = renderer(scene_md, pipeline="lit")
    r.set_environment(texture=cs.checker_texture())
    prep = raster.prepare_binned_small(*cs.lit_frame_rows(r), w, h)
    k2g = raster.gbuffer_small_kernel
    out["k2g"]["lit test scene"] = small_ms(lambda: k2g(*prep, w, h))
    out["digests"]["k2g lit test scene"] = digest(*k2g(*prep, w, h))
    for label, kw in (("test scene", {}),
                      ("shadowed test scene",
                       dict(pipeline="shadowed",
                            shadow_size=cs.SHADOW_SIZE))):
        r = renderer(scene_md, **kw)
        if kw:
            r.set_environment()
        out["frames"][label] = anim_ms(r, cs.ANIM_FRAMES)
        out["busy"][label] = busy_ms(
            lambda: r.render_animation(num_frames=cs.PROFILE_FRAMES),
            cs.PROFILE_FRAMES)
        out["digests"][label] = digest(r.render()[0])
    del prep, r
    # K8 and K8b on the --ui windows' draw list over the flat test scene,
    # then K8b inside traced --ui app frames.
    (rows, frame, atlas), (r, ui) = ui_inputs(scene_md)
    k8, k8b = overlay.overlay_raster_kernel, overlay.overlay_composite_kernel
    out["k8"]["--ui windows"] = small_ms(lambda: k8(*rows, cs.WIDTH,
                                                    cs.HEIGHT))
    cnt, over, layers = k8(*rows, cs.WIDTH, cs.HEIGHT)
    out["digests"]["k8 --ui windows"] = digest(cnt, over, *layers)
    out["k8b"]["--ui windows"] = small_ms(lambda: k8b(frame, cnt, layers,
                                                      atlas))
    out["digests"]["k8b --ui windows"] = digest(k8b(frame, cnt, layers,
                                                    atlas))
    out["k8b"]["--ui app frame"] = ui_frame_ms(r, ui)
    del rows, frame, cnt, over, layers, r, ui
    if small:
        return out
    lattice = make_stress_scene(20000)
    r = renderer(lattice)
    prep = raster.prepare_raster_inputs(*cs.frame_rows(r))
    k3 = raster.raster_hier_kernel
    out["k3"]["lattice20k"] = event_ms(lambda: k3(*prep, w, h), 20)
    out["digests"]["k3 lattice20k"] = digest(*k3(*prep, w, h))
    out["frames"]["lattice20k"] = anim_ms(r, cs.ANIM_FRAMES)
    out["busy"]["lattice20k"] = busy_ms(
        lambda: r.render_animation(num_frames=cs.PROFILE_FRAMES),
        cs.PROFILE_FRAMES)
    out["digests"]["lattice20k"] = digest(r.render()[0])
    args = indexed_args(r, h2)
    _, ti, tf, _ = tiles.setups_in_turn(2, *args, w, h2)
    prep = raster.prepare_raster_inputs(ti, tf)
    k3b = raster.raster_hier_band_kernel
    out["k3b"]["lattice20k band 0 of 2"] = event_ms(
        lambda: k3b(*prep, w, band_h, 0), 20)
    out["digests"]["k3b lattice20k band 0 of 2"] = digest(
        *k3b(*prep, w, band_h, 0))
    out["frames"]["lattice20k, 2 bands in turn"] = event_ms(
        lambda: tiles.bands_in_turn(2, cs.WIDTH, h2, *args), 10)
    out["busy"]["lattice20k, 2 bands in turn"] = busy_ms(
        lambda: tiles.bands_in_turn(2, cs.WIDTH, h2, *args))
    out["digests"]["lattice20k, 2 bands in turn"] = digest(
        *(p for band in tiles.bands_in_turn(2, cs.WIDTH, h2, *args)
          for p in band))
    del prep, args, r
    # The 20K lattice's `tile_lists` frames: K6 flat, K6g lit.
    for label, kw, kern, rows_of in (
            ("lattice20k", {}, raster.raster_lists_kernel, cs.frame_rows),
            ("lit lattice20k", dict(pipeline="lit"),
             raster.gbuffer_lists_kernel, cs.lit_frame_rows)):
        r = renderer(lattice, binning="tile_lists", **kw)
        if kw:
            r.set_environment(texture=cs.checker_texture())
        prep = raster.prepare_binned_inputs(*rows_of(r), w, h)
        key = "k6g" if kw else "k6"
        out[key][label] = event_ms(lambda: kern(*prep, w, h), 20)
        out["digests"][f"{key} {label}"] = digest(*kern(*prep, w, h))
        label += " tile_lists"
        out["frames"][label] = anim_ms(r, cs.ANIM_FRAMES)
        out["busy"][label] = busy_ms(
            lambda: r.render_animation(num_frames=cs.PROFILE_FRAMES),
            cs.PROFILE_FRAMES)
        out["digests"][label] = digest(r.render()[0])
        del prep, r
    r = renderer(lattice, pipeline="lit")
    r.set_environment(texture=cs.checker_texture())
    prep = raster.prepare_raster_inputs(*cs.lit_frame_rows(r))
    k3g = raster.gbuffer_hier_kernel
    out["k3g"]["lit lattice20k"] = event_ms(lambda: k3g(*prep, w, h), 20)
    out["digests"]["k3g lit lattice20k"] = digest(*k3g(*prep, w, h))
    out["frames"]["lit lattice20k"] = anim_ms(r, cs.ANIM_FRAMES)
    out["digests"]["lit lattice20k"] = digest(r.render()[0])
    r = renderer(lattice, pipeline="shadowed", shadow_size=cs.SHADOW_SIZE)
    r.set_environment()
    prep = raster.prepare_raster_inputs(*cs.light_rows(r))
    k3d, s = raster.depth_hier_kernel, cs.SHADOW_SIZE
    out["k3d"]["lattice20k map"] = event_ms(lambda: k3d(*prep, s, s), 20)
    out["digests"]["k3d lattice20k map"] = digest(k3d(*prep, s, s))
    prep = raster_group8.prepare_group8_inputs(*cs.light_rows(r), s, s)
    k10g8d = raster_group8.depth_group8_kernel
    out["k10g8d"]["lattice20k map"] = event_ms(lambda: k10g8d(*prep, s, s),
                                               20)
    out["digests"]["k10g8d lattice20k map"] = digest(k10g8d(*prep, s, s))
    out["frames"]["shadowed lattice20k"] = anim_ms(r, cs.ANIM_FRAMES)
    out["digests"]["shadowed lattice20k"] = digest(r.render()[0])
    del prep, r
    r = renderer(lattice, pipeline="shadowed", shadow_size=cs.SHADOW_SIZE,
                 binning="tile_lists")
    r.set_environment()
    prep = raster.prepare_binned_inputs(*cs.light_rows(r), s, s)
    k6d = raster.depth_lists_kernel
    out["k6d"]["lattice20k map"] = event_ms(lambda: k6d(*prep, s, s), 20)
    out["digests"]["k6d lattice20k map"] = digest(k6d(*prep, s, s))
    label = "shadowed lattice20k tile_lists"
    out["frames"][label] = anim_ms(r, cs.ANIM_FRAMES)
    out["busy"][label] = busy_ms(
        lambda: r.render_animation(num_frames=cs.PROFILE_FRAMES),
        cs.PROFILE_FRAMES)
    out["digests"][label] = digest(r.render()[0])
    del prep, r

    r = renderer(make_stress_scene(cs.MID_TRIS))
    prep = raster.prepare_raster_inputs(*cs.frame_rows(r))
    k5 = raster.raster_hbm_kernel
    out["k5"]["lattice40k"] = event_ms(lambda: k5(*prep, w, h), 20)
    out["digests"]["k5 lattice40k"] = digest(*k5(*prep, w, h))
    args = indexed_args(r, h2)
    _, ti, tf, _ = tiles.setups_in_turn(2, *args, w, h2)
    prep = raster.prepare_raster_inputs(ti, tf)
    out["k3b"]["lattice40k band 0 of 2"] = event_ms(
        lambda: k3b(*prep, w, band_h, 0), 20)
    out["digests"]["k3b lattice40k band 0 of 2"] = digest(
        *k3b(*prep, w, band_h, 0))
    locals_, ti, tf, s2 = tiles.setups_in_turn(2, *args, w, h2)
    prep = raster.prepare_binned_dist_owner(ti, tf, *tiles.dist_exchange(
        tiles.InTurnExchange(2), locals_, w, h2, s2)[0])
    k9d = raster.raster_binned_band_dist_kernel
    out["k9d"]["lattice40k band 0 of 2"] = event_ms(
        lambda: k9d(*prep, w, band_h, 0), 20)
    out["digests"]["k9d lattice40k band 0 of 2"] = digest(
        *k9d(*prep, w, band_h, 0))
    label = "lattice40k, 2 dist bands in turn"
    out["frames"][label] = event_ms(
        lambda: tiles.bands_in_turn(2, cs.WIDTH, h2, *args, "dist"), 10)
    out["busy"][label] = busy_ms(
        lambda: tiles.bands_in_turn(2, cs.WIDTH, h2, *args, "dist"))
    out["digests"][label] = digest(
        *(p for band in tiles.bands_in_turn(2, cs.WIDTH, h2, *args, "dist")
          for p in band))
    del prep, args, ti, tf, locals_, r
    rows = lit_lattice_rows(make_stress_scene(cs.MID_TRIS))
    for key, (kern, prep) in x_cases(rows, w, h, True).items():
        out[key]["lit lattice40k"] = event_ms(lambda: kern(*prep, w, h), 20)
        out["digests"][f"{key} lit lattice40k"] = digest(*kern(*prep, w, h))
    del prep, rows

    lattice = make_stress_scene(cs.LARGE_TRIS)
    r = renderer(lattice)
    rows = cs.frame_rows(r)
    prep = raster.prepare_binned_hbm_inputs(*rows, w, h)
    k4 = raster.raster_binned_kernel
    out["k4"]["lattice1M"] = event_ms(lambda: k4(*prep, w, h), 10)
    out["digests"]["k4 lattice1M"] = digest(*k4(*prep, w, h))
    prep = raster.prepare_raster_inputs(*rows)
    out["k5"]["lattice1M"] = event_ms(lambda: k5(*prep, w, h), 5)
    out["digests"]["k5 lattice1M"] = digest(*k5(*prep, w, h))
    for key, (kern, prep) in {**twoclass_cases(rows, h),
                              **vis_cases(rows, w, h),
                              **x_cases(rows, w, h)}.items():
        out[key]["lattice1M"] = event_ms(lambda: kern(*prep, w, h), 5)
        out["digests"][f"{key} lattice1M"] = digest(*kern(*prep, w, h))
    del rows, prep
    frame_1m(r, "lattice1M")
    args = indexed_args(r, h2)
    _, ti, tf, s = tiles.setups_in_turn(2, *args, w, h2)
    prep = raster.prepare_binned_hbm_inputs(
        ti, tf, w, h2, n_head=2 * s, pair_budget=raster.band_pair_budget(2),
        band_ty0=0, band_tiles_y=band_h // raster.TILE_H)
    k9 = raster.raster_binned_band_kernel
    out["k9"]["lattice1M band 0 of 2"] = event_ms(
        lambda: k9(*prep, w, band_h, 0), 10)
    out["digests"]["k9 lattice1M band 0 of 2"] = digest(
        *k9(*prep, w, band_h, 0))
    del prep, ti, tf
    out["frames"]["lattice1M, 2 bands in turn"] = event_ms(
        lambda: tiles.bands_in_turn(2, cs.WIDTH, h2, *args), 5)
    out["busy"]["lattice1M, 2 bands in turn"] = busy_ms(
        lambda: tiles.bands_in_turn(2, cs.WIDTH, h2, *args))
    out["digests"]["lattice1M, 2 bands in turn"] = digest(
        *(p for band in tiles.bands_in_turn(2, cs.WIDTH, h2, *args)
          for p in band))
    del args, r
    r = renderer(make_triangle_soup(cs.LARGE_TRIS, seed=1,
                                    extent=cs.SOUP_EXTENT),
                 binning="tile_lists")
    prep = raster.prepare_binned_hbm_inputs(
        *cs.frame_rows(r), w, h, coarse_cap=raster.TILE_LISTS_COARSE_CAP)
    k4c = raster.raster_binned_coarse_kernel
    out["k4c"]["soup1M"] = event_ms(lambda: k4c(*prep, w, h), 3)
    out["digests"]["k4c soup1M"] = digest(*k4c(*prep, w, h))
    del prep, r
    r = renderer(lattice, pipeline="lit")
    r.set_environment(texture=cs.checker_texture())
    rows = cs.lit_frame_rows(r)
    prep = raster.prepare_binned_hbm_inputs(*rows, w, h)
    k4g = raster.gbuffer_binned_kernel
    out["k4g"]["lit lattice1M"] = event_ms(lambda: k4g(*prep, w, h), 10)
    out["digests"]["k4g lit lattice1M"] = digest(*k4g(*prep, w, h))
    prep = raster.prepare_raster_inputs(*rows)
    k5g = raster.gbuffer_hbm_kernel
    out["k5g"]["lit lattice1M"] = event_ms(lambda: k5g(*prep, w, h), 5)
    out["digests"]["k5g lit lattice1M"] = digest(*k5g(*prep, w, h))
    for key, (kern, prep) in x_cases(rows, w, h, True).items():
        out[key]["lit lattice1M"] = event_ms(lambda: kern(*prep, w, h), 5)
        out["digests"][f"{key} lit lattice1M"] = digest(*kern(*prep, w, h))
    del prep, rows
    frame_1m(r, "lit lattice1M")
    del r
    r = renderer(lattice, pipeline="shadowed", shadow_size=cs.SHADOW_SIZE)
    r.set_environment()
    s = cs.SHADOW_SIZE
    prep = raster.prepare_binned_hbm_inputs(*cs.light_rows(r), s, s)
    k4d = raster.depth_binned_kernel
    out["k4d"]["lattice1M map"] = event_ms(lambda: k4d(*prep, s, s), 10)
    out["digests"]["k4d lattice1M map"] = digest(k4d(*prep, s, s))
    del prep
    frame_1m(r, "shadowed lattice1M")
    del r
    # The 1M lattice's frames through `hierarchy`: K5, K5g, K5's depth
    # plane as the shadow map.
    hier = dict(binning="hierarchy")
    paths = {"lattice1M hierarchy": dict(hier),
             "lit lattice1M hierarchy": dict(hier, pipeline="lit"),
             "shadowed lattice1M hierarchy": dict(
                 hier, pipeline="shadowed", shadow_size=cs.SHADOW_SIZE)}
    for label, kw in paths.items():
        r = renderer(lattice, **kw)
        if kw.get("pipeline") == "lit":
            r.set_environment(texture=cs.checker_texture())
        elif kw.get("pipeline") == "shadowed":
            r.set_environment()
            prep = raster.prepare_raster_inputs(*cs.light_rows(r))
            out["k5"]["lattice1M map"] = event_ms(lambda: k5(*prep, s, s), 5)
            out["digests"]["k5 lattice1M map"] = digest(k5(*prep, s, s)[1])
            del prep
        frame_1m(r, label)
        del r
    del lattice

    k7 = light_kernel.tiled_light_kernel
    for name in ("wide", "r2"):
        r = renderer(scene_md, pipeline="deferred")
        r.set_environment(lights=cs.baseline_lights(name))
        inputs = cs.deferred_frame_inputs(r)
        out["k7"][name] = event_ms(lambda: k7(*inputs), 20)
        out["digests"][f"k7 {name}"] = digest(k7(*inputs))
        if name == "wide":
            out["frames"]["deferred test scene wide"] = anim_ms(
                r, cs.ANIM_FRAMES)
    return out


def imported_root() -> str:
    """The checkout whose package this process imported."""
    import zrenderer_tpu_torch

    return os.path.dirname(os.path.dirname(zrenderer_tpu_torch.__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--sweep", action="store_true",
                    help="time this tree's K5 and K5g at each item count "
                    "of SWEEP_ITEMS, K10hbm2 and K10scan at each of "
                    "SWEEP_TWOCLASS_ITEMS, K10vis and K10trans at each of "
                    "SWEEP_VIS_ITEMS, K10vec and K10g8 at each of "
                    "SWEEP_X_ITEMS (K10vecg and K10g8g, K10g8d too), K6, "
                    "K6g, K6d and K9d at each item size of SWEEP_RECORDS "
                    "and SWEEP_MIN_ITEMS, and K1 and K2d at each count of "
                    "SWEEP_SMALL_BLOCKS, instead")
    ap.add_argument("--small", action="store_true",
                    help="with --other: K1, K2d, K2g, the test-scene "
                    "frames, K8 and K8b only")
    ap.add_argument("--worker", help="(internal) measure the package of "
                    "this checkout root")
    args = ap.parse_args(argv)
    if args.worker:
        # The package from the given root, chip_smoke from this tree.
        root = os.path.abspath(args.worker)
        sys.path[:] = [root] + [p for p in sys.path
                                if os.path.abspath(p or ".") != HERE]
        res = measure(args.small)
        if os.path.abspath(res["root"]) != root:
            raise RuntimeError(f"imported {res['root']}, not {root}")
        print(json.dumps(res), flush=True)
        return 0
    if not (args.sweep or args.other):
        ap.error("give --other or --sweep")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card (name, power limit): {smi}", flush=True)
    if args.sweep:
        print(json.dumps(sweep()), flush=True)
        return 0
    other = os.path.abspath(args.other)
    runs = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root]
                             + (["--small"] if args.small else []),
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["tree"] = label
        runs.append(line)
        print(json.dumps(line), flush=True)
    if any(r["digests"] != runs[0]["digests"] for r in runs):
        print("the trees' planes differ", file=sys.stderr)
        return 1
    print("every run gave the same "
          + ("K1, K2g, K2d, K8, K8b and frame" if args.small else
             "K1, K2g, K2d, K3, K3b, K3g, K3d, K4, K4c, K4g, K4d, K5, K5g, "
             "K6, K6g, K6d, K7, K8, K8b, K9, K9d, K10hbm2, K10scan, K10vis, "
             "K10trans, K10vec, K10vecg, K10g8, K10g8g, K10g8d and frame")
          + " planes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
