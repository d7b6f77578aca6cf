"""Same-call A/B of the tiled light kernel K7 on one CUDA card.

Builds this tree's kernels and a second ``light_tiled.cu`` (for example a
parent commit's, unpacked with ``git archive``) into its own library,
checks that both give the same bits on the 1080p test scene's deferred
inputs (BASELINE config 3's 256 "wide" and "r2" lights), and times them
in turns, other, this, this, other, with CUDA events:

    python -m zrenderer_tpu_torch.tools.light_ab --other path/to/light_tiled.cu

Both sources must export ``zr_light_tiled`` with the same C signature.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from zrenderer_tpu_torch.engine import passes
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.ops import _build, shading
from zrenderer_tpu_torch.scene.mesh import MeshData
from zrenderer_tpu_torch.scene.scene import Scene

SCENE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "content",
                         "scenes", "test_scene")


def baseline_lights(scale: float):
    """BASELINE config 3's 256 point lights (benchmarks/configs.py),
    colours times ``scale`` (1 for "wide", 0.008 for "r2")."""
    rng = np.random.default_rng(3)
    pos = rng.uniform([-6, 0.5, -6], [6, 6, 6], (256, 3)).astype(np.float32)
    col = rng.uniform(0.1, 1.0, (256, 3)).astype(np.float32)
    return pos, (col * np.float32(scale)).astype(np.float32)


def light_inputs(lights):
    """K7's f32 inputs of the deferred 1080p test-scene frame."""
    scene = Scene.load(os.path.join(SCENE_DIR, "scene.bin"))
    md = MeshData.load(os.path.join(SCENE_DIR, "meshes.bin"))
    r = Renderer(RenderConfig(width=1920, height=1080, pipeline="deferred"),
                 device="cuda")
    r.load_scene(scene, md)
    r.set_environment(lights=lights)
    cfg = r.config
    c = {k: torch.from_numpy(v).to(r.device)
         for k, v in r._lit_constants().items()}
    g = passes._gbuffer(r._buffers(), c["matrices"], c["normal_mats"],
                        cfg.width, cfg.height, cfg.pad_height, cfg.pad_width,
                        cfg.binning)
    world = shading.reconstruct_world_pos(g[1], c["inv_view_proj"],
                                          cfg.width, cfg.height)
    return passes.deferred_light_inputs(
        g, world, c["cam_pos"], c["view_proj"], *r.lights, cfg.width,
        cfg.height, cfg.pad_height, cfg.pad_width)


def load_other(source: str, out_dir: str) -> ctypes.CDLL:
    lib_path = os.path.join(out_dir, "libother_light.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    source, "-o", lib_path], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zr_light_tiled.argtypes = [p, i, p, p, p, i, p, i, p, i, i, p]
    lib.zr_light_tiled.restype = i
    return lib


def launch(lib, inputs):
    planes, mask, bounds, lights, consts = inputs
    h, w = mask.shape
    out = torch.empty((3, h, w), dtype=torch.float32, device=planes.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    err = lib.zr_light_tiled(
        ptr(planes), 0, ptr(mask), ptr(bounds), ptr(lights),
        bounds.shape[0], ptr(consts), 0, ptr(out), h, w,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"zr_light_tiled: CUDA error {err}")
    return out


def launch_ms(lib, inputs, reps: int = 30) -> float:
    launch(lib, inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch(lib, inputs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="light_ab")
    parser.add_argument("--other", required=True,
                        help="another light_tiled.cu to hold against")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("light_ab: no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    this = _build.load_library()
    with tempfile.TemporaryDirectory() as tmp:
        other = load_other(args.other, tmp)
        for name, scale in (("wide", 1.0), ("r2", 0.008)):
            inputs = light_inputs(baseline_lights(scale))
            same = torch.equal(launch(other, inputs).view(torch.int32),
                               launch(this, inputs).view(torch.int32))
            turns = [("other", other), ("this", this), ("this", this),
                     ("other", other)]
            times = " ".join(f"{label} {launch_ms(lib, inputs):.4f}"
                             for label, lib in turns)
            print(f"K7 1920x1088 test scene, {name} lights: bit-equal "
                  f"{same}; ms a launch (CUDA events, 30 launches): {times}")
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
