"""Author the textured multi-material showcase scene (VERDICT r3 item 10).

Generates ``content/scenes/showcase_src/`` — a real glTF 2.0 scene with
TWO materials bound to TWO real PNG textures (checker + gradient), two
textured cube meshes, a vertex-colored ground slab, and a camera — then
converts it through the production converter into
``content/scenes/showcase/`` (scene.bin + meshes.bin + captured PNGs).

This is the end-to-end fixture for the TEXS -> TextureArray -> per-draw
layer path (tests/test_golden.py::test_showcase_lit_golden); the shipped
test_scene has no textures, so that path was previously exercised only
synthetically.

    python -m zrenderer_tpu_torch.tools.make_showcase

The port's copy of ``zrenderer_tpu/tools/make_showcase.py``, so the port
builds the showcase scene without the JAX package;
``tests/test_torch_assets.py`` holds the two equal.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _checker_png(size: int = 32) -> bytes:
    from zrenderer_tpu_torch.utils.native import encode_png

    yy, xx = np.mgrid[0:size, 0:size]
    c = ((xx // 4 + yy // 4) % 2).astype(np.uint8)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = np.where(c > 0, 230, 40)
    img[..., 1] = np.where(c > 0, 60, 160)
    img[..., 2] = np.where(c > 0, 40, 230)
    img[..., 3] = 255
    return encode_png(img)


def _gradient_png(size: int = 32) -> bytes:
    from zrenderer_tpu_torch.utils.native import encode_png

    yy, xx = np.mgrid[0:size, 0:size]
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = (xx * 255 // (size - 1)).astype(np.uint8)
    img[..., 1] = (yy * 255 // (size - 1)).astype(np.uint8)
    img[..., 2] = 200
    img[..., 3] = 255
    return encode_png(img)


def _cube(half: float):
    """24-vert cube with per-face normals and 0..1 face UVs."""
    faces = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),    # +z
        ((0, 0, -1), (-1, 0, 0), (0, 1, 0)),  # -z
        ((1, 0, 0), (0, 0, -1), (0, 1, 0)),   # +x
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),   # -x
        ((0, 1, 0), (1, 0, 0), (0, 0, -1)),   # +y
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),   # -y
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, u, v in faces:
        n = np.array(n, np.float32)
        u_ = np.array(u, np.float32)
        v_ = np.array(v, np.float32)
        base = len(pos)
        for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
            pos.append((n + u_ * (du * 2 - 1) + v_ * (dv * 2 - 1)) * half)
            nrm.append(n)
            uv.append((du, dv))
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (np.array(pos, np.float32), np.array(nrm, np.float32),
            np.array(uv, np.float32), np.array(idx, np.uint16))


def build(src_dir: str) -> str:
    os.makedirs(src_dir, exist_ok=True)
    with open(os.path.join(src_dir, "checker.png"), "wb") as f:
        f.write(_checker_png())
    with open(os.path.join(src_dir, "gradient.png"), "wb") as f:
        f.write(_gradient_png())

    cube_p, cube_n, cube_uv, cube_i = _cube(1.0)
    slab_p = np.array([
        [-6, -1.2, -6], [6, -1.2, -6], [6, -1.2, 6], [-6, -1.2, 6],
    ], np.float32)
    slab_n = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    slab_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    slab_i = np.array([0, 2, 1, 0, 3, 2], np.uint16)

    blob = bytearray()
    views = []
    accessors = []

    def add(arr, target, ctype, atype):
        off = len(blob)
        blob.extend(arr.tobytes())
        while len(blob) % 4:
            blob.append(0)
        views.append({
            "buffer": 0, "byteOffset": off, "byteLength": arr.nbytes,
            "target": target,
        })
        acc = {
            "bufferView": len(views) - 1, "componentType": ctype,
            "count": len(arr), "type": atype,
        }
        if atype == "VEC3" and ctype == 5126:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    def prim(p, n, uv, i, material):
        return {
            "attributes": {
                "POSITION": add(p, 34962, 5126, "VEC3"),
                "NORMAL": add(n, 34962, 5126, "VEC3"),
                "TEXCOORD_0": add(uv, 34962, 5126, "VEC2"),
            },
            "indices": add(i, 34963, 5123, "SCALAR"),
            "material": material,
        }

    doc = {
        "asset": {"version": "2.0", "generator": "zrenderer-tpu showcase"},
        "scenes": [{"nodes": [0, 1, 2, 3]}],
        "nodes": [
            {"name": "CheckerCube", "mesh": 0,
             "translation": [-1.6, 0.0, 0.0],
             "extras": {"static": 1.0}},
            {"name": "GradientCube", "mesh": 1,
             "translation": [1.6, 0.3, 0.5],
             "rotation": [0.0, 0.3826834, 0.0, 0.9238795],
             "extras": {"static": 1.0}},
            {"name": "Ground", "mesh": 2},
            {"name": "Camera", "translation": [0.0, 2.2, 7.0],
             "children": [4]},
            {"name": "Camera_Orientation", "camera": 0,
             "rotation": [-0.1305262, 0.0, 0.0, 0.9914449]},
        ],
        "cameras": [{
            "type": "perspective",
            "perspective": {"yfov": 0.7, "znear": 0.1, "zfar": 100.0},
        }],
        "meshes": [
            {"name": "CheckerCubeMesh",
             "primitives": [prim(cube_p, cube_n, cube_uv, cube_i, 0)]},
            {"name": "GradientCubeMesh",
             "primitives": [prim(cube_p * 1.2, cube_n, cube_uv, cube_i, 1)]},
            {"name": "GroundMesh",
             "primitives": [prim(slab_p, slab_n, slab_uv, slab_i, 2)]},
        ],
        "materials": [
            {"name": "Checker", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicFactor": 0.0, "roughnessFactor": 0.6}},
            {"name": "Gradient", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 1},
                "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                "metallicFactor": 0.1, "roughnessFactor": 0.3}},
            {"name": "Flat", "pbrMetallicRoughness": {
                "baseColorFactor": [0.35, 0.4, 0.45, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 0.9}},
        ],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"uri": "checker.png"}, {"uri": "gradient.png"}],
        "buffers": [{"uri": "buffer.bin", "byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    with open(os.path.join(src_dir, "buffer.bin"), "wb") as f:
        f.write(bytes(blob))
    gltf_path = os.path.join(src_dir, "showcase.gltf")
    with open(gltf_path, "w") as f:
        json.dump(doc, f, indent=1)
    return gltf_path


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    src = os.path.join(here, "content", "scenes", "showcase_src")
    out = os.path.join(here, "content", "scenes", "showcase")
    gltf_path = build(src)

    from zrenderer_tpu_torch.tools.gltf_converter import main as conv_main

    rc = conv_main(["-s", gltf_path, "-O", "-o", out])
    print(f"showcase built: {src} -> {out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
