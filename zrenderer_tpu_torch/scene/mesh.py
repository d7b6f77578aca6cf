"""Mesh data model and the ``meshes.bin`` container format.

The port's copy of ``zrenderer_tpu/scene/mesh.py``, so the port loads
scenes without the JAX package; ``tests/test_torch_host.py`` holds the
two equal.

Capability parity with the reference's mesh layer
(``zrenderer/src/scene/mesh.zig:3-118``): mesh descriptors with LOD slots
(MAX_LODS=8) and stream slots (MAX_STREAMS=8), one shared u32 index array and
one interleaved f32 vertex array, file magic ``0x12345678``.

The reference serializes Zig structs byte-for-byte, which makes its file
layout implementation-defined (SURVEY.md §5.4). We define an explicit,
documented little-endian layout instead (docs/FORMATS.md):

    header   : 5 x u32  (magic, num_meshes, data_block_start_offset,
                         index_data_size, vertex_data_size)
    meshes   : num_meshes x 148 bytes (see MESH_RECORD below)
    vertices : vertex_data_size bytes of f32 (written BEFORE indices,
               matching the reference's serialize order, mesh.zig:79-81)
    indices  : index_data_size bytes of u32

Two deliberate fixes over the reference (docs/QUIRKS.md):
  * ``Mesh.vertex_offset`` counts VERTICES (the reference stores a
    float-array offset, gltf_converter.zig:133+149).
  * vertex data is sized ``num_vertices * 16`` floats (the reference
    over-allocates 4x by confusing bytes with floats,
    gltf_converter.zig:152).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

MESH_MAGIC = 0x12345678
MAX_LODS = 8
MAX_STREAMS = 8

# Interleaved vertex layout (mesh.zig:54-60): 16 f32 = 64 bytes.
VERTEX_FLOATS = 16
STREAM_ELEMENT_SIZE = VERTEX_FLOATS * 4
V_POSITION = slice(0, 3)
V_UV = slice(3, 5)
V_COLOR = slice(5, 9)
V_NORMAL = slice(9, 12)
V_TANGENT = slice(12, 16)

_HEADER = struct.Struct("<5I")
# num_lods, num_streams, index_offset, vertex_offset, num_vertices,
# lod_offset[8], stream_offset[8] (u64), stream_element_size[8]
_MESH_RECORD = struct.Struct("<5I8I8Q8I")

# Optional trailing material section (a capability the reference lacks —
# its converter drops glTF materials entirely): tag 'MATL', u32 count, then
# per-material records.  Old files without the section load fine; old
# loaders reading a new file stop at the declared index/vertex sizes.
_MATL_TAG = b"MATL"
# base_color rgba, metallic, roughness, emissive rgb, material_of_mesh u32
# is stored as a parallel u32 table after the records.
_MATERIAL_RECORD = struct.Struct("<4f f f 3f 64s")

# Optional texture section (follows MATL): tag 'TEXS', u32 count, count x
# 128-byte relative-uri strings, then a per-material i32 texture index
# table (-1 = untextured).  Carries glTF baseColorTexture bindings so the
# runtime can build the texture array (per-draw SRV analog).
_TEXS_TAG = b"TEXS"
_TEX_URI_LEN = 128


@dataclass
class Mesh:
    """Descriptor of one mesh inside the shared index/vertex arrays."""

    num_lods: int = 1
    num_streams: int = 1
    index_offset: int = 0  # in indices, relative to the shared index array
    vertex_offset: int = 0  # in vertices, relative to the shared vertex array
    num_vertices: int = 0
    lod_offset: list = field(default_factory=lambda: [0] * MAX_LODS)
    stream_offset: list = field(default_factory=lambda: [0] * MAX_STREAMS)
    stream_element_size: list = field(default_factory=lambda: [0] * MAX_STREAMS)

    def lod_size(self, lod: int) -> int:
        """Index count of one LOD (mesh.zig:32-34); the last offset is a marker."""
        return self.lod_offset[lod + 1] - self.lod_offset[lod]

    def pack(self) -> bytes:
        return _MESH_RECORD.pack(
            self.num_lods,
            self.num_streams,
            self.index_offset,
            self.vertex_offset,
            self.num_vertices,
            *([*self.lod_offset, *([0] * MAX_LODS)][:MAX_LODS]),
            *([*self.stream_offset, *([0] * MAX_STREAMS)][:MAX_STREAMS]),
            *([*self.stream_element_size, *([0] * MAX_STREAMS)][:MAX_STREAMS]),
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Mesh":
        v = _MESH_RECORD.unpack(data)
        return cls(
            num_lods=v[0],
            num_streams=v[1],
            index_offset=v[2],
            vertex_offset=v[3],
            num_vertices=v[4],
            lod_offset=list(v[5:13]),
            stream_offset=list(v[13:21]),
            stream_element_size=list(v[21:29]),
        )


MESH_RECORD_SIZE = _MESH_RECORD.size


@dataclass
class Material:
    """PBR material parameters (glTF pbrMetallicRoughness subset)."""

    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 0.5
    emissive: tuple = (0.0, 0.0, 0.0)
    name: str = ""

    def pack(self) -> bytes:
        return _MATERIAL_RECORD.pack(
            *self.base_color, self.metallic, self.roughness, *self.emissive,
            self.name.encode("utf-8")[:63].ljust(64, b"\x00"),
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Material":
        v = _MATERIAL_RECORD.unpack(data)
        return cls(
            base_color=tuple(v[0:4]),
            metallic=v[4],
            roughness=v[5],
            emissive=tuple(v[6:9]),
            name=v[9].split(b"\x00", 1)[0].decode("utf-8", errors="replace"),
        )


@dataclass
class MeshData:
    """Shared geometry arrays + mesh descriptors (mesh.zig:62-118)."""

    index_data: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    vertex_data: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)  # Material records
    mesh_material: list = field(default_factory=list)  # per-mesh index, -1=none
    texture_uris: list = field(default_factory=list)  # relative image paths
    material_texture: list = field(default_factory=list)  # per-material, -1=none

    def vertices_of(self, mesh: Mesh) -> np.ndarray:
        """Interleaved (num_vertices, 16) f32 view of one mesh's vertices."""
        start = mesh.vertex_offset * VERTEX_FLOATS
        end = start + mesh.num_vertices * VERTEX_FLOATS
        return self.vertex_data[start:end].reshape(-1, VERTEX_FLOATS)

    def indices_of(self, mesh: Mesh, lod: int = 0) -> np.ndarray:
        start = mesh.index_offset + mesh.lod_offset[lod]
        return self.index_data[start : start + mesh.lod_size(lod)]

    def serialize(self) -> bytes:
        """Write the documented meshes.bin layout (vertices before indices,
        matching the reference's field order, mesh.zig:67-82)."""
        out = io.BytesIO()
        header = _HEADER.pack(
            MESH_MAGIC,
            len(self.meshes),
            _HEADER.size + len(self.meshes) * MESH_RECORD_SIZE,
            4 * len(self.index_data),
            4 * len(self.vertex_data),
        )
        out.write(header)
        for m in self.meshes:
            out.write(m.pack())
        out.write(np.ascontiguousarray(self.vertex_data, np.float32).tobytes())
        out.write(np.ascontiguousarray(self.index_data, np.uint32).tobytes())
        if self.materials:
            out.write(_MATL_TAG)
            out.write(struct.pack("<I", len(self.materials)))
            for m in self.materials:
                out.write(m.pack())
            mm = list(self.mesh_material) + [-1] * (
                len(self.meshes) - len(self.mesh_material)
            )
            out.write(np.asarray(mm, np.int32).tobytes())
            if self.texture_uris:
                out.write(_TEXS_TAG)
                out.write(struct.pack("<I", len(self.texture_uris)))
                for uri in self.texture_uris:
                    out.write(
                        uri.encode("utf-8")[: _TEX_URI_LEN - 1]
                        .ljust(_TEX_URI_LEN, b"\x00")
                    )
                mt = list(self.material_texture) + [-1] * (
                    len(self.materials) - len(self.material_texture)
                )
                out.write(np.asarray(mt, np.int32).tobytes())
        return out.getvalue()

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    @classmethod
    def deserialize(cls, data: bytes) -> "MeshData":
        magic, num_meshes, data_start, index_size, vertex_size = _HEADER.unpack_from(
            data, 0
        )
        if magic != MESH_MAGIC:
            raise ValueError(f"bad meshes.bin magic: {magic:#x}")
        meshes = []
        off = _HEADER.size
        for _ in range(num_meshes):
            meshes.append(Mesh.unpack(data[off : off + MESH_RECORD_SIZE]))
            off += MESH_RECORD_SIZE
        assert off == data_start, "mesh table does not end at data block start"
        vertex_data = np.frombuffer(data, np.float32, vertex_size // 4, off).copy()
        off += vertex_size
        index_data = np.frombuffer(data, np.uint32, index_size // 4, off).copy()
        off += index_size
        materials = []
        mesh_material: list = []
        if data[off : off + 4] == _MATL_TAG:
            off += 4
            (count,) = struct.unpack_from("<I", data, off)
            off += 4
            for _ in range(count):
                materials.append(
                    Material.unpack(data[off : off + _MATERIAL_RECORD.size])
                )
                off += _MATERIAL_RECORD.size
            mesh_material = np.frombuffer(
                data, np.int32, num_meshes, off
            ).tolist()
            off += 4 * num_meshes
        texture_uris: list = []
        material_texture: list = []
        if data[off : off + 4] == _TEXS_TAG:
            off += 4
            (tcount,) = struct.unpack_from("<I", data, off)
            off += 4
            for _ in range(tcount):
                raw = data[off : off + _TEX_URI_LEN]
                texture_uris.append(
                    raw.split(b"\x00", 1)[0].decode("utf-8", errors="replace")
                )
                off += _TEX_URI_LEN
            material_texture = np.frombuffer(
                data, np.int32, len(materials), off
            ).tolist()
        return cls(
            index_data=index_data,
            vertex_data=vertex_data,
            meshes=meshes,
            materials=materials,
            mesh_material=mesh_material,
            texture_uris=texture_uris,
            material_texture=material_texture,
        )

    @classmethod
    def load(cls, path) -> "MeshData":
        with open(path, "rb") as f:
            return cls.deserialize(f.read())

    def append_mesh(
        self,
        vertices: np.ndarray,
        indices: np.ndarray,
        lod_index_counts=None,
    ) -> int:
        """Append an interleaved (n, 16) f32 vertex block + u32 indices as a
        new mesh; returns its index.  ``lod_index_counts`` optionally gives
        index counts per LOD (defaults to one LOD covering all indices)."""
        vertices = np.ascontiguousarray(vertices, np.float32)
        indices = np.ascontiguousarray(indices, np.uint32)
        assert vertices.ndim == 2 and vertices.shape[1] == VERTEX_FLOATS
        if lod_index_counts is None:
            lod_index_counts = [len(indices)]
        assert sum(lod_index_counts) == len(indices)
        assert len(lod_index_counts) < MAX_LODS

        mesh = Mesh(
            num_lods=len(lod_index_counts),
            num_streams=1,
            index_offset=len(self.index_data),
            vertex_offset=len(self.vertex_data) // VERTEX_FLOATS,
            num_vertices=len(vertices),
        )
        mesh.stream_element_size[0] = STREAM_ELEMENT_SIZE
        mesh.stream_offset[0] = mesh.vertex_offset * STREAM_ELEMENT_SIZE
        running = 0
        for i, count in enumerate(lod_index_counts):
            mesh.lod_offset[i] = running
            running += count
        mesh.lod_offset[len(lod_index_counts)] = running

        self.vertex_data = np.concatenate([self.vertex_data, vertices.reshape(-1)])
        self.index_data = np.concatenate([self.index_data, indices])
        self.meshes.append(mesh)
        return len(self.meshes) - 1


def make_vertex(position, uv=(0, 0), color=(1, 1, 1, 1), normal=(0, 0, 1), tangent=(1, 0, 0, 1)):
    """Build one interleaved 16-float vertex."""
    v = np.zeros(VERTEX_FLOATS, np.float32)
    v[V_POSITION] = position
    v[V_UV] = uv
    v[V_COLOR] = color
    v[V_NORMAL] = normal
    v[V_TANGENT] = tangent
    return v
