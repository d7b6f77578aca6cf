"""Offline glTF -> binary asset converter (the reference's gltf_converter CLI).

Same contract as ``gltf_converter.exe`` (gltf_converter.zig:477-481):

    python -m zrenderer_tpu_torch.tools.gltf_converter -s path/to/scene.gltf -o outdir/
    python -m zrenderer_tpu_torch.tools.gltf_converter -i path/to/gltf_dir/  -o outdir/

Scene mode writes ``scene.bin`` + ``meshes.bin``; mesh-folder mode converts
every ``*.gltf`` in the folder into one ``meshes.bin``.

Semantics preserved from the reference:
  * interleave POSITION/TEXCOORD_0/COLOR_0/NORMAL/TANGENT into the 16-float
    vertex layout (gltf_converter.zig:69-115);
  * u16-normalized vertex colors scaled by 1/65535 (gltf_converter.zig:100-112);
  * node ``extras.static`` JSON -> Mobility (gltf_converter.zig:336-351);
  * mesh dedup by glTF mesh name (gltf_converter.zig:359-386);
  * camera node = node whose single child holds a camera; position from the
    parent translation, orientation from parent (x) child quats, perspective
    params incl. optional zfar (gltf_converter.zig:258-320).

Deliberate fixes over the reference (docs/QUIRKS.md):
  * Camera.forward is actually computed (rotate (0,0,-1) by the combined
    orientation) — the reference serializes uninitialized memory and then
    uses it as the look-at focus (SURVEY.md §8 item 3).
  * Quaternion composition order is child-then-parent (the row-vector local
    -> world order); the reference composes parent-then-child, unobservable
    in its test scene because both rotations share the X axis.
  * Node rotation quats use all four components (the reference has a
    ``rotation[2]`` where ``[3]`` typo, gltf_converter.zig:405).
  * TRS transforms compose v @ S @ R @ T (glTF semantics; see
    zmath.trs_matrix).

This is host-side asset tooling in both designs (the reference runs it
offline on CPU); a native C++ fast path for big scenes lives in ``native/``.

The port's copy of ``zrenderer_tpu/tools/gltf_converter.py``, so the port
converts glTF scenes without the JAX package; ``tests/test_torch_assets.py``
holds the two equal.
"""

from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import sys

import numpy as np

from zrenderer_tpu_torch.math import zmath as zm
from zrenderer_tpu_torch.scene.mesh import (
    Material,
    MeshData,
    V_COLOR,
    V_NORMAL,
    V_POSITION,
    V_TANGENT,
    V_UV,
    VERTEX_FLOATS,
)
from zrenderer_tpu_torch.scene.scene import Camera, Mobility, Node, Scene

log = logging.getLogger("gltf_converter")

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


GLB_MAGIC = 0x46546C67  # 'glTF'
_GLB_CHUNK_JSON = 0x4E4F534A
_GLB_CHUNK_BIN = 0x004E4942


def _parse_glb(data: bytes):
    """GLB container (glTF 2.0 binary): 12-byte header + chunks.  Returns
    (json_doc, bin_chunk_or_None) — the cgltf GLB capability
    (gltf_converter.zig:7-11 parses via cgltf, which handles .glb)."""
    import struct as _struct

    magic, version, length = _struct.unpack_from("<3I", data, 0)
    if magic != GLB_MAGIC:
        raise ValueError(f"bad GLB magic {magic:#x}")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    if length > len(data):
        raise ValueError("GLB header length exceeds file size")
    doc = None
    bin_chunk = None
    off = 12
    while off + 8 <= length:
        chunk_len, chunk_type = _struct.unpack_from("<2I", data, off)
        off += 8
        if off + chunk_len > length:
            raise ValueError("GLB chunk overruns file")
        chunk = data[off : off + chunk_len]
        if chunk_type == _GLB_CHUNK_JSON:
            doc = json.loads(chunk.decode("utf-8"))
        elif chunk_type == _GLB_CHUNK_BIN and bin_chunk is None:
            bin_chunk = chunk
        off += chunk_len + ((-chunk_len) % 4)  # chunks are 4-byte aligned
    if doc is None:
        raise ValueError("GLB has no JSON chunk")
    return doc, bin_chunk


class Gltf:
    """Minimal glTF 2.0 reader: JSON (+ GLB container), external / data-URI
    / GLB-BIN buffers."""

    def __init__(self, path: str):
        self.path = path
        bin_chunk = None
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] == b"glTF":
            self.doc, bin_chunk = _parse_glb(raw)
        else:
            self.doc = json.loads(raw.decode("utf-8"))
        self.buffers = []
        base_dir = os.path.dirname(os.path.abspath(path))
        for buf in self.doc.get("buffers", []):
            uri = buf.get("uri")
            if uri is None:
                if bin_chunk is None:
                    raise ValueError(
                        "buffer without uri outside a GLB container"
                    )
                data = bin_chunk
            elif uri.startswith("data:"):
                payload = uri.split(",", 1)[1]
                data = base64.b64decode(payload)
            else:
                with open(os.path.join(base_dir, uri), "rb") as f:
                    data = f.read()
            assert len(data) >= buf["byteLength"]
            self.buffers.append(data)

    def accessor(self, index: int) -> np.ndarray:
        """Read accessor ``index`` as an (count, components) array in its
        native dtype (no normalization applied)."""
        acc = self.doc["accessors"][index]
        view = self.doc["bufferViews"][acc["bufferView"]]
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        buf = self.buffers[view["buffer"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride", 0) or dtype.itemsize * ncomp
        if stride == dtype.itemsize * ncomp:
            out = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(
                count, ncomp
            )
        else:
            raw = np.frombuffer(buf, np.uint8, count * stride, offset)
            raw = raw.reshape(count, stride)[:, : dtype.itemsize * ncomp]
            out = raw.view(dtype).reshape(count, ncomp)
        return out.copy()


def _extract_primitive(gltf: Gltf, primitive: dict, mesh_data: MeshData,
                       optimize: bool = False, lods: int = 1) -> int:
    """Interleave one glTF primitive into MeshData; returns the mesh index.

    Mirrors extractGLTFPrimitive + extractVertexData + extractIndexData
    (gltf_converter.zig:173-204, :69-115, :32-67).  ``optimize`` runs the
    native mesh-optimization pass (vertex dedup + vertex-cache + spatial
    triangle ordering — the meshoptimizer role, which the reference links
    but never calls, gltf_converter.zig:155).  ``lods`` > 1 fills the mesh
    format's LOD slots with simplified index ranges (QEM edge collapse,
    each level targeting half the previous index count).
    """
    attrs = primitive["attributes"]
    num_vertices = gltf.doc["accessors"][next(iter(attrs.values()))]["count"]
    verts = np.zeros((num_vertices, VERTEX_FLOATS), np.float32)
    verts[:, V_COLOR] = 1.0  # default white like a missing COLOR_0 stream

    for name, acc_index in attrs.items():
        data = gltf.accessor(acc_index)
        assert len(data) == num_vertices
        if name == "POSITION":
            verts[:, V_POSITION] = data.astype(np.float32)
        elif name == "NORMAL":
            verts[:, V_NORMAL] = data.astype(np.float32)
        elif name == "TANGENT":
            verts[:, V_TANGENT] = data.astype(np.float32)
        elif name == "TEXCOORD_0":
            verts[:, V_UV] = data.astype(np.float32)
        elif name == "COLOR_0":
            # u16-normalized RGBA -> f32 / 65535 (gltf_converter.zig:100-112).
            acc = gltf.doc["accessors"][acc_index]
            if acc["componentType"] == 5123:
                verts[:, V_COLOR] = data.astype(np.float32) / np.float32(65535.0)
            elif acc["componentType"] == 5121:
                verts[:, V_COLOR] = data.astype(np.float32) / np.float32(255.0)
            else:
                verts[:, V_COLOR] = data.astype(np.float32)

    _record_material(gltf, primitive, mesh_data)
    indices = gltf.accessor(primitive["indices"]).reshape(-1).astype(np.uint32)
    if optimize:
        from zrenderer_tpu_torch.utils import native

        remap, unique = native.generate_vertex_remap(verts)
        verts, indices = native.apply_remap(verts, remap, unique, indices)
        indices = native.optimize_vertex_cache(indices, unique)
        indices = native.spatial_sort_triangles(indices, verts)
        # Last: vertex-fetch reorder (vertices into first-use order of the
        # final triangle order) — completes the meshoptimizer compiled set
        # (indexgenerator/vcache/spatialorder/vfetch).
        verts, indices, _ = native.optimize_vertex_fetch(verts, indices)
    if lods <= 1:
        return mesh_data.append_mesh(verts, indices)

    # LOD chain: each level simplifies the previous to half its indices
    # (quadric edge collapse onto existing vertices — all LODs share the
    # vertex block, matching the format's per-LOD index ranges).
    from zrenderer_tpu_torch.utils import native

    chains = [indices]
    for _level in range(1, lods):
        prev = chains[-1]
        target = max(3, (len(prev) // 2) // 3 * 3)
        simplified = native.simplify(prev, verts, target)
        if len(simplified) == 0 or len(simplified) >= len(prev):
            break  # cannot simplify further (all borders / tiny mesh)
        chains.append(simplified)
    all_idx = np.concatenate(chains)
    return mesh_data.append_mesh(
        verts, all_idx, lod_index_counts=[len(c) for c in chains]
    )


def _record_material(gltf: Gltf, primitive: dict, mesh_data: MeshData) -> None:
    """Carry the primitive's glTF material into the MATL section (a
    capability beyond the reference, which drops materials entirely)."""
    mat_idx = primitive.get("material")
    if mat_idx is None:
        mesh_data.mesh_material.append(-1)
        return
    # The dedup map lives on the Gltf document: glTF material indices are
    # per-file, so a map on the shared MeshData would alias material 0 of
    # every file in mesh-folder (-i) mode to the first file's material 0.
    if not hasattr(gltf, "_material_map"):
        gltf._material_map = {}
    mapping = gltf._material_map
    if mat_idx not in mapping:
        gm = gltf.doc.get("materials", [])[mat_idx]
        pbr = gm.get("pbrMetallicRoughness", {})
        mapping[mat_idx] = len(mesh_data.materials)
        mesh_data.materials.append(
            Material(
                base_color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
                metallic=float(pbr.get("metallicFactor", 1.0)),
                roughness=float(pbr.get("roughnessFactor", 1.0)),
                emissive=tuple(gm.get("emissiveFactor", [0, 0, 0])),
                name=gm.get("name", ""),
            )
        )
        mesh_data.material_texture.append(
            _record_texture(gltf, pbr.get("baseColorTexture"), mesh_data)
        )
    mesh_data.mesh_material.append(mapping[mat_idx])


def _record_texture(gltf: Gltf, tex_ref, mesh_data: MeshData) -> int:
    """Resolve a glTF textureInfo to a uri slot in the TEXS table
    (dedup by uri); -1 when absent or non-uri (GLB-embedded images are not
    extracted — the runtime loads uris relative to the scene)."""
    if tex_ref is None:
        return -1
    try:
        tex = gltf.doc["textures"][tex_ref["index"]]
        image = gltf.doc["images"][tex["source"]]
        uri = image.get("uri")
    except (KeyError, IndexError):
        return -1
    if not uri or uri.startswith("data:"):
        return -1
    if uri not in mesh_data.texture_uris:
        mesh_data.texture_uris.append(uri)
    return mesh_data.texture_uris.index(uri)


def _camera_from_nodes(gltf: Gltf, parent: dict, child: dict) -> Camera:
    """Build a Camera from a parent node + child orientation node
    (gltf_converter.zig:258-320)."""
    cam = Camera(name=parent.get("name", ""))
    cam.position = np.array(
        parent.get("translation", [0.0, 0.0, 0.0]), np.float32
    )

    orientation = zm.quat_identity()
    # Row-vector local->world: child rotation applied first, then parent.
    if "rotation" in child:
        orientation = zm.qmul(orientation, np.array(child["rotation"], np.float32))
    if "rotation" in parent:
        orientation = zm.qmul(orientation, np.array(parent["rotation"], np.float32))

    pitch, yaw, _roll = zm.quat_to_euler(orientation)
    cam.pitch = float(pitch)
    cam.yaw = float(yaw)
    # glTF cameras look down -Z in local space.
    cam.forward = zm.rotate_vec3(orientation, (0.0, 0.0, -1.0))[:3]

    gltf_camera = gltf.doc["cameras"][child["camera"]]
    assert gltf_camera["type"] == "perspective"
    persp = gltf_camera["perspective"]
    cam.yfov = float(persp["yfov"])
    cam.znear = float(persp["znear"])
    cam.zfar = float(persp.get("zfar", 0.0))
    return cam


def convert_gltf_scene(gltf_path: str, optimize: bool = False,
                       lods: int = 1) -> tuple:
    """Scene mode: one glTF file -> (Scene, MeshData).

    Mirrors convertGLTFScene (gltf_converter.zig:225-421).
    """
    gltf = Gltf(gltf_path)
    assert len(gltf.doc.get("scenes", [])) == 1, "expected exactly one glTF scene"

    scene = Scene()
    mesh_data = MeshData()
    mesh_dedup: dict = {}  # glTF mesh name -> list of mesh indices

    nodes = gltf.doc["nodes"]
    for node_index in gltf.doc["scenes"][0]["nodes"]:
        gnode = nodes[node_index]
        log.debug("Converting node '%s'", gnode.get("name"))

        children = gnode.get("children", [])
        if len(children) == 1 and "camera" in nodes[children[0]]:
            scene.cameras.append(_camera_from_nodes(gltf, gnode, nodes[children[0]]))
            continue

        if "mesh" not in gnode:
            log.debug("Skipping meshless node '%s'", gnode.get("name"))
            continue

        node = Node(name=gnode.get("name", ""))
        extras = gnode.get("extras", None)
        if extras is not None and "static" in extras:
            node.mobility = (
                Mobility.STATIC if float(extras["static"]) > 0.5 else Mobility.MOVEABLE
            )

        gmesh = gltf.doc["meshes"][gnode["mesh"]]
        mesh_name = gmesh.get("name", f"mesh{gnode['mesh']}")
        if mesh_name in mesh_dedup:
            node.mesh_indices = list(mesh_dedup[mesh_name])
        else:
            indices = [
                _extract_primitive(gltf, prim, mesh_data, optimize=optimize,
                                   lods=lods)
                for prim in gmesh["primitives"]
            ]
            mesh_dedup[mesh_name] = indices
            node.mesh_indices = list(indices)

        node.transform_index = len(scene.transforms)
        if "matrix" in gnode:
            # glTF stores column-major column-vector matrices; transpose to
            # our row-vector convention. (The reference asserts(false) here.)
            col_major = np.array(gnode["matrix"], np.float32).reshape(4, 4, order="F")
            scene.transforms.append(col_major.T.copy())
        else:
            scene.transforms.append(
                zm.trs_matrix(
                    gnode.get("translation"),
                    np.array(gnode["rotation"], np.float32)
                    if "rotation" in gnode
                    else None,
                    gnode.get("scale"),
                )
            )
        scene.nodes.append(node)

    return scene, mesh_data


def convert_gltf_meshes(gltf_path: str, mesh_data: MeshData,
                        optimize: bool = False, lods: int = 1) -> None:
    """Mesh-folder mode: append every primitive of every mesh
    (convertGLTF, gltf_converter.zig:117-171)."""
    gltf = Gltf(gltf_path)
    for gmesh in gltf.doc.get("meshes", []):
        for prim in gmesh["primitives"]:
            _extract_primitive(gltf, prim, mesh_data, optimize=optimize,
                               lods=lods)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gltf_converter",
        description="Convert glTF scenes/meshes to scene.bin/meshes.bin",
    )
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("-i", dest="mesh_folder", help="folder of .gltf mesh files")
    group.add_argument("-s", dest="scene_file", help="scene .gltf file")
    parser.add_argument("-o", dest="output", required=True, help="output folder")
    parser.add_argument(
        "-O", "--optimize", action="store_true",
        help="native mesh optimization: vertex dedup + vertex-cache + "
             "spatial triangle ordering",
    )
    parser.add_argument(
        "--lods", type=int, default=1, metavar="N",
        help="generate N LOD levels per mesh (QEM simplification, each "
             "level half the previous index count; max 7)",
    )
    args = parser.parse_args(argv)
    assert 1 <= args.lods <= 7, "--lods must be 1..7 (format has 8 slots)"

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    os.makedirs(args.output, exist_ok=True)

    if args.mesh_folder:
        mesh_data = MeshData()
        for entry in sorted(os.listdir(args.mesh_folder)):
            if entry.endswith((".gltf", ".glb")):
                log.info("Converting %s", entry)
                convert_gltf_meshes(
                    os.path.join(args.mesh_folder, entry), mesh_data,
                    optimize=args.optimize, lods=args.lods,
                )
        mesh_data.save(os.path.join(args.output, "meshes.bin"))
    else:
        log.info("Converting scene %s...", args.scene_file)
        scene, mesh_data = convert_gltf_scene(
            args.scene_file, optimize=args.optimize, lods=args.lods
        )
        mesh_data.save(os.path.join(args.output, "meshes.bin"))
        scene.save(os.path.join(args.output, "scene.bin"))
        # Texture capture: copy TEXS-referenced images next to the bins so
        # the output folder is a self-contained runtime scene (the runtime
        # resolves uris relative to the scene folder,
        # engine/textures.py:textures_from_mesh_data).
        src_dir = os.path.dirname(os.path.abspath(args.scene_file))
        for uri in mesh_data.texture_uris:
            src = os.path.join(src_dir, uri)
            dst = os.path.join(args.output, uri)
            if os.path.abspath(src) == os.path.abspath(dst):
                continue
            if not os.path.exists(src):
                log.warning("texture %s referenced but missing; skipped", src)
                continue
            os.makedirs(os.path.dirname(dst) or args.output, exist_ok=True)
            import shutil

            shutil.copyfile(src, dst)
            log.info("Captured texture %s", uri)
    log.info("Wrote output to %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
