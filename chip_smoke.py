#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (zrenderer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order, each printing its own lines and seconds:

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
2. build: the CUDA raster kernels from ``zrenderer_tpu_torch/csrc``;
3. K1 (small-scene binned raster) against its plain torch version on the
   card, bit-exact: the test scene at 1080p, a triangle soup with clipped
   fan rows, and exact depth ties between duplicated triangles;
4. K3 (hierarchy raster) against its plain version, bit-exact: the
   20K-triangle lattice at 1080p and the soup;
5. the main path: ``Renderer.render_and_read`` at 1080p on the test scene
   (K1) and the lattice (K3), with the launch counts of that run, and the
   256x144 frame against the NumPy oracle (the port's geometry on CPU
   tensors, then the oracle's scalar loop);
6. timing: ``render_animation`` ms/frame (CUDA events), a per-stage
   breakdown (ms per call, host dispatch included, and device ops per
   call), each kernel's device time
   from a torch.profiler trace beside its plain version's time per call,
   and a profiled ``render_animation`` run per scene: device-busy ms and
   device ops per frame and the device's idle share;
7. the app CLI writing PNGs;
8. hygiene: neither jax nor the JAX package (``zrenderer_tpu``) loaded.

Any failure raises and exits non-zero; without a CUDA card it exits 1 at
once.  The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE_DIR = os.path.join(HERE, "content", "scenes", "test_scene")

# The main-path frame (the reference demo's 1080p) and its padded raster
# target, the card, and the animation length of the timing phase.
DEVICE = "cuda"
WIDTH, HEIGHT = 1920, 1080
PAD_W, PAD_H = 1920, 1088
ANIM_FRAMES = 200
PROFILE_FRAMES = 20  # frames of the profiled render_animation run

# bench.py's parity threshold against the oracle at 256x144, and
# RASTER_SPEC.md §5's full-pipeline depth bound.
PARITY_MAX_LSB = 1
PARITY_MAX_PX = 50
DEPTH_MAX_ULP = 2
MIN_COVERAGE = 0.05


def phase(name):
    """Decorator: run the phase at once, print its seconds, return its
    result.  Exceptions propagate (the script exits non-zero)."""
    def run(fn):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        out = fn()
        print(f"== phase {name}: ok in {time.perf_counter() - t0:.2f} s",
              flush=True)
        return out
    return run


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1

    import numpy as np

    from zrenderer_tpu_torch.app.main import main as app_main
    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import Renderer, frame_digest
    from zrenderer_tpu_torch.engine.upload import (
        flat_scene_to_device,
        flatten_scene,
    )
    from zrenderer_tpu_torch.ops import _build, raster
    from zrenderer_tpu_torch.ops import geometry as tg
    from zrenderer_tpu_torch.raster_ref import raster_cpu
    from zrenderer_tpu_torch.scene.mesh import V_COLOR, MeshData
    from zrenderer_tpu_torch.scene.procedural import (
        make_stress_scene,
        make_triangle_soup,
    )
    from zrenderer_tpu_torch.scene.scene import Scene
    from zrenderer_tpu_torch.utils.png import read_png

    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    k1, k3 = raster.raster_small_kernel, raster.raster_hier_kernel
    results = {"k1": {"err": 0.0}, "k3": {"err": 0.0}}

    def load_test_scene():
        return (Scene.load(os.path.join(SCENE_DIR, "scene.bin")),
                MeshData.load(os.path.join(SCENE_DIR, "meshes.bin")))

    def clipped_soup():
        """300-triangle soup with 20 triangles pushed through the near
        plane, so the capped clipper emits fan rows."""
        scene, md = make_triangle_soup(300, seed=7, extent=2.0,
                                       behind_camera_fraction=0.1)
        v = md.vertex_data.reshape(-1, 16)
        for t in range(40, 60):
            v[3 * t, 2] += 15.0
        return scene, md

    def tie_soup(duplicate: bool):
        """Soup whose second half repeats the first with other colors:
        every duplicate ties its original's depth exactly."""
        scene, md = make_triangle_soup(200, seed=3, extent=2.0)
        v = md.vertex_data.reshape(-1, 16)
        if duplicate:
            v2 = v.copy()
            v2[:, V_COLOR] = 1.0 - v2[:, V_COLOR]
            v2[:, V_COLOR.stop - 1] = 1.0
            v = np.concatenate([v, v2])
        md2 = MeshData()
        md2.append_mesh(v, np.arange(len(v), dtype=np.uint32))
        return scene, md2

    def setup_rows(scene, md, width, height, tri_align=64):
        """Port geometry on the card: (tri_i32, tri_f32)."""
        flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
        b = flat_scene_to_device(flat.host_arrays(), dev)
        vp = tg.view_proj_from_camera(scene.active_camera, width, height)
        mats = np.einsum("nij,jk->nik", flat.node_to_world,
                         vp).astype(np.float32)
        return tg.geometry_pipeline_cols(
            b["corner_cols"], b["tri_node"], torch.from_numpy(mats).to(dev),
            width, height)

    def compare(key, label, kernel_fn, plain_fn, prepared, w, h):
        """Kernel vs plain version on the same prepared inputs: packed
        color and depth bits must be equal."""
        sync()
        ck, dk = kernel_fn(*prepared, w, h)
        sync()
        cp, dp = plain_fn(*prepared, w, h)
        sync()
        err = max(
            (raster.unpack_rgba8(ck).int() - raster.unpack_rgba8(cp).int())
            .abs().max().item(),
            (dk - dp).abs().max().item(),
        )
        same = (torch.equal(ck, cp)
                and torch.equal(dk.view(torch.int32), dp.view(torch.int32)))
        cov = (dk < 1.0).float().mean().item()
        print(f"  {label}: {w}x{h} bit-exact={same} max_abs_err={err} "
              f"coverage={cov:.4f}", flush=True)
        if not same:
            raise AssertionError(f"{label}: kernel and plain version differ")
        if cov <= 0.0:
            raise AssertionError(f"{label}: empty frame proves nothing")
        results[key]["err"] = max(results[key]["err"], float(err))
        return ck, dk

    # -- 1. environment ---------------------------------------------------
    @phase("1 environment")
    def card():
        nvcc = _build.find_nvcc()
        nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} card(s): "
              f"{torch.cuda.get_device_name(0)}")
        print(f"  nvcc: {nvcc_ver.strip().splitlines()[-1]}")
        print(f"  card (name, power limit): {smi}")
        return smi

    # -- 2. build ---------------------------------------------------------
    @phase("2 build")
    def build():
        info = _build.build_library()
        _build.load_library()
        print(f"  {info.path} built in {info.seconds:.2f} s "
              f"(flags: {' '.join(_build.NVCC_FLAGS)})")
        for line in info.log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}")
        return info.seconds

    # -- 3. K1 vs plain ---------------------------------------------------
    @phase("3 K1 kernel vs plain version")
    def k1_inputs():
        scene, md = load_test_scene()
        ti, tf = setup_rows(scene, md, WIDTH, HEIGHT, tri_align=256)
        main_prep = raster.prepare_binned_small(ti, tf, PAD_W, PAD_H)
        compare("k1", "(a) test scene", k1, raster.raster_small_plain,
                main_prep, PAD_W, PAD_H)

        scene, md = clipped_soup()
        ti, tf = setup_rows(scene, md, WIDTH, HEIGHT)
        n_head = tg.head_count(ti.shape[0])
        fans = int((ti[n_head:, tg.I_VALID] > 0).sum().item())
        print(f"  (b) soup: {n_head} head rows, {fans} live clipped-fan rows")
        if fans == 0:
            raise AssertionError("soup has no clipped-fan rows")
        compare("k1", "(b) clipped soup", k1, raster.raster_small_plain,
                raster.prepare_binned_small(ti, tf, PAD_W, PAD_H), PAD_W, PAD_H)

        w, h = 1024, 512
        ti, tf = setup_rows(*tie_soup(True), w, h)
        c_dup, d_dup = compare("k1", "(c) duplicated triangles", k1,
                               raster.raster_small_plain,
                               raster.prepare_binned_small(ti, tf, w, h), w, h)
        ti1, tf1 = setup_rows(*tie_soup(False), w, h)
        c_one, d_one = k1(*raster.prepare_binned_small(ti1, tf1, w, h), w, h)
        if not (torch.equal(c_dup, c_one) and torch.equal(d_dup, d_one)):
            raise AssertionError("(c) a duplicate won an exact depth tie")
        print("  (c) every exact depth tie went to the first-submitted row")
        return main_prep

    # -- 4. K3 vs plain ---------------------------------------------------
    @phase("4 K3 kernel vs plain version")
    def k3_inputs():
        lattice = make_stress_scene(20000)
        ti, tf = setup_rows(*lattice, WIDTH, HEIGHT, tri_align=256)
        main_prep = raster.prepare_raster_inputs(ti, tf)
        print(f"  lattice: {ti.shape[0]} rows, "
              f"{tg.head_count(ti.shape[0])} head rows")
        t0 = time.perf_counter()
        compare("k3", "lattice", k3, raster.raster_hier_plain, main_prep,
                PAD_W, PAD_H)
        print(f"  (plain K3 included: {time.perf_counter() - t0:.1f} s)")
        ti, tf = setup_rows(*clipped_soup(), WIDTH, HEIGHT)
        compare("k3", "clipped soup (binning=hierarchy)", k3,
                raster.raster_hier_plain, raster.prepare_raster_inputs(ti, tf),
                PAD_W, PAD_H)
        return main_prep, lattice

    main_prep_k3, lattice = k3_inputs

    # -- 5. main path -----------------------------------------------------
    @phase("5 main path")
    def launches():
        scene, md = load_test_scene()
        k1.launches = 0
        k3.launches = 0

        r = Renderer(RenderConfig(width=WIDTH, height=HEIGHT), device=DEVICE)
        r.load_scene(scene, md)
        img, depth = r.render_and_read()
        cov = (img[..., :3].sum(-1) > 0).mean()
        print(f"  test scene {WIDTH}x{HEIGHT}: {img.shape} coverage={cov:.4f}"
              f", K1 launches so far {k1.launches}")
        if img.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(depth).all():
            raise AssertionError("bad main-path frame")
        if cov <= MIN_COVERAGE or k1.launches == 0:
            raise AssertionError("test-scene frame empty or not via K1")

        pw, ph = 256, 144
        rs = Renderer(RenderConfig(width=pw, height=ph), device=DEVICE)
        rs.load_scene(scene, md)
        img_dev, depth_dev = rs.render_and_read()
        img_cpu, depth_cpu = raster_cpu.render_scene_cpu(scene, md, pw, ph)
        diff = np.abs(img_dev.astype(np.int32) - img_cpu.astype(np.int32))
        bad = int((diff > 0).any(-1).sum())
        both = (depth_dev < 1.0) & (depth_cpu < 1.0)
        ulp = np.abs(depth_dev.view(np.int32).astype(np.int64)
                     - depth_cpu.view(np.int32).astype(np.int64))[both]
        cov_diff = int(((depth_dev < 1.0) != (depth_cpu < 1.0)).sum())
        print(f"  parity vs NumPy oracle at {pw}x{ph}: max_diff="
              f"{int(diff.max())} LSB, {bad}/{pw * ph} px differ, coverage "
              f"mismatch {cov_diff} px, depth max {int(ulp.max())} ulp")
        if int(diff.max()) > PARITY_MAX_LSB or bad >= PARITY_MAX_PX:
            raise AssertionError("256x144 frame outside the parity threshold")
        if int(ulp.max()) > DEPTH_MAX_ULP or cov_diff >= PARITY_MAX_PX:
            raise AssertionError("256x144 depth outside the parity threshold")

        k3_before = k3.launches
        rl = Renderer(RenderConfig(width=WIDTH, height=HEIGHT), device=DEVICE)
        rl.load_scene(*lattice)
        img_l, _ = rl.render_and_read()
        cov_l = (img_l[..., :3].sum(-1) > 0).mean()
        print(f"  lattice {WIDTH}x{HEIGHT}: coverage={cov_l:.4f}, K3 launches "
              f"{k3.launches - k3_before}")
        if cov_l <= MIN_COVERAGE or k3.launches == k3_before:
            raise AssertionError("lattice frame empty or not via K3")
        counts = {"k1": k1.launches, "k3": k3.launches}
        print(f"  launches in the main-path run: {counts}")
        return counts, r, rl

    counts, r_scene, r_lattice = launches

    # -- 6. timing --------------------------------------------------------
    def event_ms(fn, reps):
        """Time per call from CUDA events around ``reps`` back-to-back
        calls: device time where the device is the bottleneck, host
        dispatch time where the host is."""
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device_trace(fn):
        """Run ``fn`` under torch.profiler; returns (device events, the
        trace's window in us).  Device events are the kernels, copies and
        memsets of the chrome trace as (name, start us, duration us)."""
        from torch.profiler import ProfilerActivity, profile

        fn()  # warm-up outside the trace
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        on_device = [(e["name"], float(e["ts"]), float(e["dur"]))
                     for e in timed
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if not on_device:
            raise AssertionError("the profiler recorded no device activity")
        t0 = min(float(e["ts"]) for e in timed)
        t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
        return on_device, t1 - t0

    def busy_us(events):
        """Union of the device events' intervals, in us."""
        total, end = 0.0, float("-inf")
        for _, ts, dur in sorted(events, key=lambda e: e[1]):
            if ts + dur > end:
                total += ts + dur - max(ts, end)
                end = ts + dur
        return total

    def kernel_device_ms(fn, kernel_name, reps):
        """Mean device duration of ``kernel_name`` over ``reps`` calls."""
        events, _ = device_trace(lambda: [fn() for _ in range(reps)])
        durs = [d for name, _, d in events if kernel_name in name]
        if len(durs) != reps:
            raise AssertionError(f"{kernel_name}: {len(durs)} launches in "
                                 f"the trace, expected {reps}")
        return sum(durs) / len(durs) / 1000.0

    @phase("6 timing")
    def timing():
        frames = ANIM_FRAMES
        for label, r in (("test scene (K1)", r_scene),
                         ("lattice (K3)", r_lattice)):
            digests, _ = r.render_animation(num_frames=frames)  # warm-up
            sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            digests, _ = r.render_animation(num_frames=frames)
            end.record()
            d = digests.cpu().numpy()
            wall = (time.perf_counter() - t0) * 1000.0 / frames
            dev_ms = start.elapsed_time(end) / frames
            if not (d > 0).all() or not (d == d[0]).all():
                raise AssertionError(f"{label}: bad digests {d[:4]}")
            print(f"  render_animation {WIDTH}x{HEIGHT} {label}: {dev_ms:.4f} ms/frame"
                  f" (CUDA events), {1000.0 / dev_ms:.1f} FPS; host clock "
                  f"{wall:.4f} ms/frame incl. digest read; digest {d[0]:.6e}")

            n = PROFILE_FRAMES
            events, window = device_trace(
                lambda r=r: r.render_animation(num_frames=n)[0].cpu())
            busy = busy_us(events)
            kernels = {"k1": "raster_small_kernel", "k3": "raster_hier_kernel"}
            raster_us = sum(dur for name, _, dur in events
                            if any(k in name for k in kernels.values()))
            print(f"  profiled render_animation({n}) {label}: "
                  f"{len(events) / n:.1f} device ops/frame, device busy "
                  f"{busy / n / 1000.0:.4f} ms/frame (raster kernels "
                  f"{raster_us / n / 1000.0:.4f}), idle share "
                  f"{1.0 - busy / window:.4f} of {window / n / 1000.0:.4f} "
                  f"ms/frame traced (host slowed by the profiler)")

        # Stage breakdown of one test-scene frame (each stage in a loop).
        b = r_scene._buffers()
        mats = torch.from_numpy(r_scene.camera_matrices()).to(dev)
        cfg = r_scene.config
        ti, tf = tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"],
                                           mats, cfg.width, cfg.height)
        prep = raster.prepare_binned_small(ti, tf, cfg.pad_width,
                                           cfg.pad_height)
        packed, _ = k1(*prep, cfg.pad_width, cfg.pad_height)
        stages = {
            "geometry": lambda: tg.geometry_pipeline_cols(
                b["corner_cols"], b["tri_node"], mats, cfg.width, cfg.height),
            "prepare_binned_small": lambda: raster.prepare_binned_small(
                ti, tf, cfg.pad_width, cfg.pad_height),
            "K1 wrapper": lambda: k1(*prep, cfg.pad_width, cfg.pad_height),
            "digest": lambda: frame_digest(packed),
        }
        for name, fn in stages.items():
            ops = len(device_trace(fn)[0])
            print(f"  stage {name}: {event_ms(fn, 50):.4f} ms/call "
                  f"(CUDA events, host dispatch included), {ops} device "
                  f"ops/call (profiler)")

        for key, kname, prep_k, reps, plain_fn, plain_reps in (
                ("k1", "raster_small_kernel", k1_inputs, 50,
                 raster.raster_small_plain, 3),
                ("k3", "raster_hier_kernel", main_prep_k3, 20,
                 raster.raster_hier_plain, 1)):
            kern = k1 if key == "k1" else k3
            results[key]["ms"] = kernel_device_ms(
                lambda: kern(*prep_k, PAD_W, PAD_H), kname, reps)
            results[key]["wrapper_ms"] = event_ms(
                lambda: kern(*prep_k, PAD_W, PAD_H), reps)
            results[key]["plain_ms"] = event_ms(
                lambda: plain_fn(*prep_k, PAD_W, PAD_H), plain_reps)
        for key, label in (("k1", "K1 test scene"), ("k3", "K3 lattice")):
            res = results[key]
            print(f"  {label} {PAD_W}x{PAD_H}: kernel {res['ms']:.4f} ms "
                  f"device time (profiler), wrapper {res['wrapper_ms']:.4f} "
                  f"ms/call (CUDA events); plain version "
                  f"{res['plain_ms']:.4f} ms/call (CUDA events)")

    # -- 7. app -----------------------------------------------------------
    @phase("7 app")
    def app():
        with tempfile.TemporaryDirectory() as tmp:
            rc = app_main(["--scene", SCENE_DIR, "--width", str(WIDTH),
                           "--height", str(HEIGHT), "--frames", "2",
                           "--out", tmp, "--device", DEVICE])
            img = read_png(os.path.join(tmp, "frame_0001.png"))
        cov = (img[..., :3].astype(np.int32).sum(-1) > 0).mean()
        print(f"  app rc={rc}, frame_0001.png {img.shape} coverage={cov:.4f}")
        if rc != 0 or img.shape[:2] != (HEIGHT, WIDTH) or cov <= MIN_COVERAGE:
            raise AssertionError("app frame missing or empty")

    # -- 8. hygiene -------------------------------------------------------
    @phase("8 hygiene")
    def hygiene():
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "zrenderer_tpu"))
        if loaded:
            raise AssertionError(f"reference modules loaded: {loaded[:5]}")
        print("  neither jax nor the JAX package (zrenderer_tpu) loaded")

    kernels = [
        {"name": "k1_raster_small", "route": "cuda",
         "source": "zrenderer_tpu_torch/csrc/raster_small.cu",
         "replaces": "zrenderer_tpu/ops/raster_pallas.py:2915",
         "launches": counts["k1"], "max_abs_err": results["k1"]["err"],
         "ms": results["k1"]["ms"], "plain_ms": results["k1"]["plain_ms"]},
        {"name": "k3_raster_hier", "route": "cuda",
         "source": "zrenderer_tpu_torch/csrc/raster_hier.cu",
         "replaces": "zrenderer_tpu/ops/raster_pallas.py:750",
         "launches": counts["k3"], "max_abs_err": results["k3"]["err"],
         "ms": results["k3"]["ms"], "plain_ms": results["k3"]["plain_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
