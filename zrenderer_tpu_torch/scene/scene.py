"""Scene data model and the ``scene.bin`` container format.

The port's copy of ``zrenderer_tpu/scene/scene.py``, so the port loads
scenes without the JAX package; ``tests/test_torch_host.py`` holds the
two equal.

Capability parity with the reference's scene layer
(``zrenderer/src/scene/scene.zig:5-124``): a flat list of nodes (no
hierarchy), each referencing up to MAX_NUM_MESHES_PER_NODE meshes and one
row-major 4x4 transform; a camera list with an active index; file magic
``0x87654321``.

Explicit little-endian layout (the reference dumps Zig structs including
padding — implementation-defined, SURVEY.md §5.4; see docs/FORMATS.md):

    header      : 4 x u32 (magic, num_nodes, num_transforms, num_cameras)
    nodes       : num_nodes x 108 bytes
                  (num_meshes u32, mesh_indices 8xu32, transform_index u32,
                   mobility u32, name 64 bytes zero-padded utf-8)
    transforms  : num_transforms x 16 f32 (row-major, row-vector convention)
    active_camera_index : u32
    cameras     : num_cameras x 108 bytes
                  (position 3xf32, forward 3xf32, pitch f32, yaw f32,
                   yfov f32, zfar f32, znear f32, name 64 bytes)

Field order inside records follows the reference structs
(scene.zig:13-41); serialization section order follows the reference's
serialize() (scene.zig:71-89).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

SCENE_MAGIC = 0x87654321
MAX_NAME_LENGTH = 64
MAX_NUM_MESHES_PER_NODE = 8

_HEADER = struct.Struct("<4I")
_NODE = struct.Struct(f"<I8III{MAX_NAME_LENGTH}s")
_CAMERA = struct.Struct(f"<3f3f2f3f{MAX_NAME_LENGTH}s")


class Mobility(IntEnum):
    """scene.zig:8-11."""

    STATIC = 0
    MOVEABLE = 1


def _pack_name(name: str) -> bytes:
    raw = name.encode("utf-8")[: MAX_NAME_LENGTH - 1]
    return raw.ljust(MAX_NAME_LENGTH, b"\x00")


def _unpack_name(raw: bytes) -> str:
    return raw.split(b"\x00", 1)[0].decode("utf-8", errors="replace")


@dataclass
class Node:
    """scene.zig:13-27."""

    mesh_indices: list = field(default_factory=list)  # into MeshData.meshes
    transform_index: int = 0  # into Scene.transforms
    mobility: Mobility = Mobility.STATIC
    name: str = ""

    @property
    def num_meshes(self) -> int:
        return len(self.mesh_indices)

    def pack(self) -> bytes:
        assert len(self.mesh_indices) <= MAX_NUM_MESHES_PER_NODE
        padded = list(self.mesh_indices) + [0xFFFFFFFF] * (
            MAX_NUM_MESHES_PER_NODE - len(self.mesh_indices)
        )
        return _NODE.pack(
            self.num_meshes,
            *padded,
            self.transform_index,
            int(self.mobility),
            _pack_name(self.name),
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Node":
        v = _NODE.unpack(data)
        num = v[0]
        return cls(
            mesh_indices=list(v[1 : 1 + num]),
            transform_index=v[9],
            mobility=Mobility(v[10]),
            name=_unpack_name(v[11]),
        )


@dataclass
class Camera:
    """scene.zig:29-41.

    The reference never writes ``forward`` in its converter and then uses it
    as the look-at focus (undefined memory — SURVEY.md §8 item 3).  We store
    a real unit forward vector derived from the camera's orientation; the
    renderer looks at ``position + forward``.
    """

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    forward: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, -1], np.float32)
    )
    pitch: float = 0.0
    yaw: float = 0.0
    yfov: float = 1.0
    zfar: float = 1000.0
    znear: float = 0.1
    name: str = ""

    def pack(self) -> bytes:
        return _CAMERA.pack(
            *np.asarray(self.position, np.float32),
            *np.asarray(self.forward, np.float32),
            self.pitch,
            self.yaw,
            self.yfov,
            self.zfar,
            self.znear,
            _pack_name(self.name),
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Camera":
        v = _CAMERA.unpack(data)
        return cls(
            position=np.array(v[0:3], np.float32),
            forward=np.array(v[3:6], np.float32),
            pitch=v[6],
            yaw=v[7],
            yfov=v[8],
            zfar=v[9],
            znear=v[10],
            name=_unpack_name(v[11]),
        )


NODE_RECORD_SIZE = _NODE.size
CAMERA_RECORD_SIZE = _CAMERA.size


@dataclass
class Scene:
    """scene.zig:58-124: flat node list, transform list, camera list."""

    nodes: list = field(default_factory=list)
    transforms: list = field(default_factory=list)  # 4x4 f32 row-major each
    active_camera_index: int = 0
    cameras: list = field(default_factory=list)

    def serialize(self) -> bytes:
        out = io.BytesIO()
        out.write(
            _HEADER.pack(
                SCENE_MAGIC, len(self.nodes), len(self.transforms), len(self.cameras)
            )
        )
        for n in self.nodes:
            out.write(n.pack())
        for t in self.transforms:
            out.write(np.ascontiguousarray(t, np.float32).reshape(16).tobytes())
        out.write(struct.pack("<I", self.active_camera_index))
        for cam in self.cameras:
            out.write(cam.pack())
        return out.getvalue()

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    @classmethod
    def deserialize(cls, data: bytes) -> "Scene":
        magic, num_nodes, num_transforms, num_cameras = _HEADER.unpack_from(data, 0)
        if magic != SCENE_MAGIC:
            raise ValueError(f"bad scene.bin magic: {magic:#x}")
        off = _HEADER.size
        scene = cls()
        for _ in range(num_nodes):
            scene.nodes.append(Node.unpack(data[off : off + NODE_RECORD_SIZE]))
            off += NODE_RECORD_SIZE
        for _ in range(num_transforms):
            scene.transforms.append(
                np.frombuffer(data, np.float32, 16, off).reshape(4, 4).copy()
            )
            off += 64
        (scene.active_camera_index,) = struct.unpack_from("<I", data, off)
        off += 4
        for _ in range(num_cameras):
            scene.cameras.append(Camera.unpack(data[off : off + CAMERA_RECORD_SIZE]))
            off += CAMERA_RECORD_SIZE
        return scene

    @classmethod
    def load(cls, path) -> "Scene":
        with open(path, "rb") as f:
            return cls.deserialize(f.read())

    @property
    def active_camera(self) -> Camera:
        return self.cameras[self.active_camera_index]
