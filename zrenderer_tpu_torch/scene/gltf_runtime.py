"""Runtime glTF loading — the ``parseAndLoadGltfFile``/``appendMeshPrimitive``
capability (zrenderer/libs/common/src/common.zig:539-667): an app can load a
.gltf/.glb directly, without running the offline converter first.

The heavy lifting reuses the converter's reader (same semantics, one code
path); these wrappers expose it as a runtime scene API.

The port's copy of ``zrenderer_tpu/scene/gltf_runtime.py``, so the port
loads glTF files at run time without the JAX package;
``tests/test_torch_assets.py`` holds the two equal.
"""

from __future__ import annotations


def load_gltf(path: str, optimize: bool = False):
    """Load a .gltf or .glb file into runtime (Scene, MeshData) — the
    parseAndLoadGltfFile analog (common.zig:539-553)."""
    from zrenderer_tpu_torch.tools.gltf_converter import convert_gltf_scene

    return convert_gltf_scene(str(path), optimize=optimize)


def append_gltf_primitives(mesh_data, path: str, mesh_index: int = 0,
                           optimize: bool = False) -> list:
    """Append one glTF mesh's primitives into an existing MeshData —
    the appendMeshPrimitive analog (common.zig:555-667).  Returns the new
    mesh indices."""
    from zrenderer_tpu_torch.tools.gltf_converter import Gltf, _extract_primitive

    gltf = Gltf(str(path))
    gmesh = gltf.doc["meshes"][mesh_index]
    return [
        _extract_primitive(gltf, prim, mesh_data, optimize=optimize)
        for prim in gmesh["primitives"]
    ]
