#!/usr/bin/env python3
"""Same-call A/B of the raster kernels K3g, K3d and K4g and the tiled
light kernel K7, and of the frames whose pace they set, between this tree
and another checkout (for example a parent commit unpacked with ``git
archive``) on one CUDA card.

    python3 chip_ab.py --other path/to/checkout

Each tree runs in a process of its own, which builds that tree's kernels,
in turns: other, this, this, other.  Every run uses chip_smoke.py's sizes
and builders (``lit_frame_rows``, ``deferred_frame_inputs``,
``baseline_lights``, ``checker_texture``) from this tree on the tree's own
package.  A run times, with CUDA events after a warm-up: K3g on the lit
20K lattice's inputs and K3d on its 1024x1024 shadow map (the hierarchy
prepare), K4g on the lit 1M lattice's inputs (``auto``, the padded 1080p
target), K7 on the deferred test scene's 1080p G-buffer with BASELINE
config 3's wide and r2 lights (f32 planes), and ``render_animation``
ms/frame of the lit and the shadowed 20K and 1M lattices and of the
deferred test scene with the wide lights at 1080p.  Every run must give the same planes (their digests are
compared).  Prints the card's name and power limit first, then one JSON
line per run.
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
    from zrenderer_tpu_torch.ops import light_kernel, raster
    from zrenderer_tpu_torch.scene.mesh import MeshData
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene
    from zrenderer_tpu_torch.scene.scene import Scene

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
        r = Renderer(RenderConfig(width=cs.WIDTH, height=cs.HEIGHT,
                                  tri_align=256, **kw), device="cuda")
        r.load_scene(*scene_md)
        return r

    def anim_ms(r, frames):
        r.render_animation(num_frames=frames)
        torch.cuda.synchronize()
        return event_ms(lambda: r.render_animation(num_frames=frames),
                        1) / frames

    w, h = cs.PAD_W, cs.PAD_H
    out = {"root": imported_root(), "k3g": {}, "k3d": {}, "k4g": {},
           "k7": {}, "frames": {}, "digests": {}}
    lattice = make_stress_scene(20000)
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
    out["frames"]["shadowed lattice20k"] = anim_ms(r, cs.ANIM_FRAMES)
    out["digests"]["shadowed lattice20k"] = digest(r.render()[0])
    del prep, r

    lattice = make_stress_scene(cs.LARGE_TRIS)
    r = renderer(lattice, pipeline="lit")
    r.set_environment(texture=cs.checker_texture())
    prep = raster.prepare_binned_hbm_inputs(*cs.lit_frame_rows(r), w, h)
    k4g = raster.gbuffer_binned_kernel
    out["k4g"]["lit lattice1M"] = event_ms(lambda: k4g(*prep, w, h), 10)
    out["digests"]["k4g lit lattice1M"] = digest(*k4g(*prep, w, h))
    out["frames"]["lit lattice1M"] = anim_ms(r, cs.LARGE_FRAMES)
    del prep, r
    r = renderer(lattice, pipeline="shadowed", shadow_size=cs.SHADOW_SIZE)
    r.set_environment()
    out["frames"]["shadowed lattice1M"] = anim_ms(r, cs.LARGE_FRAMES)
    out["digests"]["shadowed lattice1M"] = digest(r.render()[0])
    del r, lattice

    scene_md = (Scene.load(os.path.join(cs.SCENE_DIR, "scene.bin")),
                MeshData.load(os.path.join(cs.SCENE_DIR, "meshes.bin")))
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
    print("every run gave the same K3g, K3d, K4g, K7 and frame planes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
