"""Headless renderer application, flat, lit, shadowed and deferred
pipelines, with optional TAA, UI overlay and camera orbit (counterpart of
``zrenderer_tpu/app/main.py``).

Loads a scene folder (scene.bin + meshes.bin) or a .gltf/.glb file (read
at run time by ``scene/gltf_runtime.load_gltf``, no conversion step),
prints the scene outliner, renders frames on the chosen device and writes
them as PNGs:

    python -m zrenderer_tpu_torch.app.main --scene content/scenes/test_scene \
        --width 1920 --height 1080 --frames 60 --out out/ --device cuda \
        [--pipeline lit|shadowed|deferred] [--taa] [--overlay|--ui] [--orbit] \
        [--debug] [--ssaa N] [--trace DIR]
    python -m zrenderer_tpu_torch.app.main \
        --scene content/scenes/showcase_src/showcase.gltf --pipeline lit

The lit and shadowed pipelines bind the scene's TEXS textures (any format
``utils/image.read_image`` decodes, resolved against the scene folder or
the glTF file's folder) where it has them, else a 256x256 checkerboard; the
deferred pipeline lights the frame with the default point light. ``--taa``
jitters each frame's projection by the 8-frame Halton sequence and resolves
it into a history carried from frame to frame. ``--overlay`` burns the
stats line and the scene outliner into each frame as one panel, ``--ui`` as
the imgui Stats and Scene Outliner windows: the frame is composited on the
renderer's device (K8 and K8b on a card), read back, and written or
dropped. ``--orbit`` moves the camera on a turntable around the scene.
``--debug`` validates each frame (the debug layer), ``--ssaa N`` renders
the flat pipeline at N times the size and box-resolves it, and ``--trace
DIR`` records the run, scene load included, under torch.profiler with the
profiling zones on and writes a Chrome trace JSON in DIR.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys

import numpy as np

from zrenderer_tpu_torch.app.camera import CameraController
from zrenderer_tpu_torch.app.overlay_ui import ImguiOverlay, OverlayUI
from zrenderer_tpu_torch.engine.config import PIPELINES, RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.engine.textures import (
    Texture,
    checkerboard,
    textures_from_mesh_data,
)
from zrenderer_tpu_torch.ops import taa
from zrenderer_tpu_torch.ops.raster import BINNINGS
from zrenderer_tpu_torch.profiling import ztracy
from zrenderer_tpu_torch.scene.gltf_runtime import load_gltf
from zrenderer_tpu_torch.scene.mesh import MeshData
from zrenderer_tpu_torch.scene.scene import Scene
from zrenderer_tpu_torch.utils.png import write_png


def scene_outliner(scene) -> str:
    """The scene outliner panel, as text."""
    lines = ["Scene Outliner"]
    for node in scene.nodes:
        lines.append(f"  * {node.name}")
    return "\n".join(lines)


def load_scene_path(path):
    """``--scene``: a folder of scene.bin + meshes.bin, or a .gltf/.glb
    file.  Returns (scene, mesh_data, the folder its texture uris resolve
    against)."""
    if path.endswith((".gltf", ".glb")):
        scene, mesh_data = load_gltf(path)
        return scene, mesh_data, os.path.dirname(path)
    return (Scene.load(os.path.join(path, "scene.bin")),
            MeshData.load(os.path.join(path, "meshes.bin")), path)


def bind_scene_textures(renderer, mesh_data, texture_dir) -> None:
    """Per-material textures from the scene's TEXS table when present,
    the checker otherwise."""
    tex_list, mat_tex = textures_from_mesh_data(mesh_data, texture_dir)
    if tex_list is not None:
        renderer.set_environment(textures=tex_list,
                                 material_textures=mat_tex)
    else:
        renderer.set_environment(
            texture=Texture.from_array(checkerboard(256)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="zrenderer-tpu-torch")
    parser.add_argument("--scene", default="content/scenes/test_scene",
                        help="folder containing scene.bin + meshes.bin, "
                             "or a .gltf/.glb file")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--out", default=None, help="PNG output folder")
    parser.add_argument("--binning", default="auto", choices=BINNINGS,
                        help="raster binning (auto: small-scene lists up to "
                             "1024 head rows, hierarchy up to 32768 setup "
                             "rows, record streaming above)")
    parser.add_argument("--pipeline", default="flat", choices=PIPELINES,
                        help="flat vertex color, lit (textured "
                             "Blinn-Phong, one point light), shadowed "
                             "(directional shadow map with PCF) or deferred "
                             "(G-buffer + tiled GGX over point lights)")
    parser.add_argument("--taa", action="store_true",
                        help="temporal anti-aliasing (jitter + history "
                             "resolve)")
    parser.add_argument("--orbit", action="store_true",
                        help="animate the camera on a turntable orbit")
    parser.add_argument("--overlay", action="store_true",
                        help="rasterize the stats/outliner overlay into "
                             "frames")
    parser.add_argument("--ui", action="store_true",
                        help="the imgui-window UI (stats and scene outliner "
                             "windows) instead of the simple overlay panel")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda, cuda:N or cpu")
    parser.add_argument("--debug", action="store_true",
                        help="the debug layer: validate each frame's depth "
                             "and count the clipper's drops")
    parser.add_argument("--ssaa", type=int, default=1,
                        help="ordered-grid supersampling factor (flat "
                             "pipeline only)")
    parser.add_argument("--trace", default=None,
                        help="write a torch.profiler Chrome trace of the "
                             "run to this folder")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    if args.trace:
        with ztracy.trace(args.trace) as capture:
            _run(args)
        print(f"trace: {capture.path}")
    else:
        _run(args)
    return 0


def _run(args) -> None:
    scene, mesh_data, texture_dir = load_scene_path(args.scene)
    config = RenderConfig(width=args.width, height=args.height,
                          binning=args.binning, pipeline=args.pipeline,
                          debug=args.debug, supersample=args.ssaa)
    renderer = Renderer(config, device=args.device)
    renderer.load_scene(scene, mesh_data)
    if args.pipeline != "flat":
        bind_scene_textures(renderer, mesh_data, texture_dir)
    orbit_ctl = None
    if args.orbit:
        orbit_ctl = CameraController(scene.active_camera)
        orbit_radius = float(np.linalg.norm(scene.active_camera.position))
    print(scene_outliner(scene))

    overlay = None
    if args.ui:
        overlay = ImguiOverlay(config.width, config.height,
                               device=renderer.device)
    elif args.overlay:
        overlay = OverlayUI(config.width, config.height,
                            device=renderer.device)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    jitters = taa.jitter_sequence(8) if args.taa else None
    history = None
    for frame_i in range(args.frames):
        if orbit_ctl is not None:
            orbit_ctl.orbit((0.0, 0.5, 0.0), orbit_radius,
                            azimuth=2 * math.pi * frame_i / max(args.frames, 1),
                            elevation=0.35)
        if args.taa:
            color, depth = renderer.render(jitter=jitters[frame_i % 8])
            if history is None:
                history = taa.taa_init_history(color)
            history, color = taa.taa_resolve(history, color)
            renderer._pending = (color, depth)
        else:
            color, _depth = renderer.render()
        img = None
        if overlay is not None:
            # Composited on the renderer's device, then read back.
            line = renderer.stats.format_line()
            if args.ui:
                img = overlay.compose(color, line, scene)
            else:
                img = overlay.compose(
                    color, [line] + scene_outliner(scene).split("\n"))
        renderer.present()  # fence pacing; the frame stays on the device
        if args.out:
            if img is None:
                img, _depth = renderer.read_frame()
            write_png(os.path.join(args.out, f"frame_{frame_i:04d}.png"), img)
        if frame_i % 30 == 0 or frame_i == args.frames - 1:
            print(renderer.stats.format_line())
    renderer.finish_gpu_commands()


if __name__ == "__main__":
    sys.exit(main())
