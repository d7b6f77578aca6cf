#!/usr/bin/env python3
"""Same-call A/B of the record-streaming rasters K4 and K4d, and of the
frames whose pace they set, between this tree and another checkout (for
example a parent commit unpacked with ``git archive``) on one CUDA card.

    python3 chip_ab.py --other path/to/checkout

Each tree runs in a process of its own, which builds that tree's kernels,
in turns: other, this, this, other.  Every run uses chip_smoke.py's sizes
and builders (``frame_rows``, ``light_rows``, ``config4``) from this tree
on the tree's own package.  A run times, with CUDA events after a
warm-up: K4 on the 1M lattice and on the 1M soup (``auto``'s inputs at
the padded 1080p target), K4d on the 1M lattice's shadow map, and
``render_animation`` ms/frame of the flat and the shadowed 1M lattice at
1080p and of config 4 (K4 and ``taa_resolve_packed`` over
CONFIG4_FRAMES jittered frames).  Every run must give the same planes
(their digests are compared).  Prints the card's name and power limit
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


def measure() -> dict:
    """One run in the tree that ``zrenderer_tpu_torch`` imports from."""
    import torch

    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import Renderer
    from zrenderer_tpu_torch.ops import raster
    from zrenderer_tpu_torch.scene.procedural import (
        make_stress_scene,
        make_triangle_soup,
    )

    def event_ms(fn, reps):
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
        return int(sum(int(p.contiguous().view(torch.int32).to(torch.int64)
                           .sum().item()) for p in planes))

    def renderer(scene_md, **kw):
        r = Renderer(RenderConfig(width=cs.WIDTH, height=cs.HEIGHT, **kw),
                     device="cuda")
        r.load_scene(*scene_md)
        return r

    def anim_ms(r):
        frames = cs.LARGE_FRAMES
        r.render_animation(num_frames=frames)
        torch.cuda.synchronize()
        return event_ms(lambda: r.render_animation(num_frames=frames),
                        1) / frames

    w, h = cs.PAD_W, cs.PAD_H
    out = {"root": imported_root(), "k4": {}, "frames": {}, "digests": {}}
    lattice = make_stress_scene(cs.LARGE_TRIS)
    r4 = renderer(lattice)
    prep = raster.prepare_binned_hbm_inputs(*cs.frame_rows(r4), w, h)
    k4 = raster.raster_binned_kernel
    out["k4"]["lattice1M"] = event_ms(lambda: k4(*prep, w, h), 10)
    out["digests"]["k4 lattice1M"] = digest(*k4(*prep, w, h))
    out["frames"]["flat lattice1M"] = anim_ms(r4)
    frames = cs.CONFIG4_FRAMES
    out["frames"]["config 4"] = event_ms(
        lambda: cs.config4(r4, frames), 1) / frames
    del prep, r4

    rs = renderer(lattice, pipeline="shadowed", shadow_size=cs.SHADOW_SIZE)
    rs.set_environment()
    s = cs.SHADOW_SIZE
    prep = raster.prepare_binned_hbm_inputs(*cs.light_rows(rs), s, s)
    k4d = raster.depth_binned_kernel
    out["k4d"] = {"lattice1M map": event_ms(lambda: k4d(*prep, s, s), 10)}
    out["digests"]["k4d lattice1M map"] = digest(k4d(*prep, s, s))
    out["frames"]["shadowed lattice1M"] = anim_ms(rs)
    del prep, rs, lattice

    soup = make_triangle_soup(cs.LARGE_TRIS, seed=1, extent=cs.SOUP_EXTENT)
    prep = raster.prepare_binned_hbm_inputs(
        *cs.frame_rows(renderer(soup)), w, h)
    out["k4"]["soup1M"] = event_ms(lambda: k4(*prep, w, h), 3)
    out["digests"]["k4 soup1M"] = digest(*k4(*prep, w, h))
    return out


def imported_root() -> str:
    """The checkout whose package this process imported."""
    import zrenderer_tpu_torch

    return os.path.dirname(os.path.dirname(zrenderer_tpu_torch.__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--worker", help="(internal) measure the package of "
                    "this checkout root")
    args = ap.parse_args(argv)
    if args.worker:
        # The package from the given root, chip_smoke from this tree.
        root = os.path.abspath(args.worker)
        sys.path[:] = [root] + [p for p in sys.path
                                if os.path.abspath(p or ".") != HERE]
        res = measure()
        if os.path.abspath(res["root"]) != root:
            raise RuntimeError(f"imported {res['root']}, not {root}")
        print(json.dumps(res), flush=True)
        return 0
    other = os.path.abspath(args.other)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card (name, power limit): {smi}", flush=True)
    runs = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], capture_output=True,
                             text=True)
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
    print("every run gave the same K4 and K4d planes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
