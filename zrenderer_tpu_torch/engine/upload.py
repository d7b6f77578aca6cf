"""Host-side scene flattening and the host -> device carry.

Counterpart of ``zrenderer_tpu/engine/upload.py``.  The draw loop is
flattened at load time into dense arrays: every (node, mesh) draw's
vertices are appended (instanced meshes are duplicated per draw) and each
vertex records its draw's transform index.  Triangle order in ``tri_vidx``
is the submission order (node order, then index order), the canonical
depth-tie order (docs/RASTER_SPEC.md §3).

The flattening is host NumPy code, ported as it is so both packages build
identical arrays.  ``flat_scene_to_device`` moves those arrays onto the
port's device; it takes plain NumPy arrays, so a test can hand both
packages the same scene state.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zrenderer_tpu_torch.scene.mesh import (
    V_COLOR,
    V_NORMAL,
    V_POSITION,
    V_TANGENT,
    V_UV,
)

# FlatScene fields that flat_scene_to_device carries, in upload order.
DEVICE_FIELDS = ("positions", "attrs", "tri_vidx", "vert_node",
                 "node_to_world", "corner_cols", "tri_node")


@dataclass
class FlatScene:
    """Draw-expanded host arrays ready for device upload."""

    positions: np.ndarray  # (N, 4) f32, w = 1
    attrs: np.ndarray  # (N, 12) f32: color4, uv2, normal3, tangent3
    tri_vidx: np.ndarray  # (T, 3) int32, submission order
    vert_node: np.ndarray  # (N,) int32 -> index into node_to_world
    node_to_world: np.ndarray  # (D, 4, 4) f32, one per draw
    num_triangles: int  # valid triangles before padding
    num_vertices: int
    draw_mesh: np.ndarray = None  # (D,) int32 mesh index of each draw

    @property
    def draw_count(self) -> int:
        return len(self.node_to_world)

    def build_meshlet_table(self, block: int = 128):
        """Per-meshlet culling metadata: a meshlet is a block of ``block``
        consecutive triangles of the flattened submission order, aligned
        with the raster's RASTER_BLOCK so that a culled meshlet's rows
        leave whole blocks.

        Returns (bounds (M, 8) f32, mdraw (M,) i32, enabled (M,) bool):
        bounds rows are [cx, cy, cz, radius, ax, ay, az, cone_cutoff] in
        draw-local space (cutoff < 0: the cone never culls).  Blocks that
        mix draws are disabled (kept)."""
        B = block
        T = len(self.tri_vidx)
        if T % B:
            raise ValueError(f"{T} triangles: pad to a multiple of {B}")
        M = T // B
        tnode = self.vert_node[self.tri_vidx[:, 0]].reshape(M, B)
        enabled = (tnode == tnode[:, :1]).all(axis=1)
        mdraw = tnode[:, 0].astype(np.int32)

        p = self.positions[self.tri_vidx.reshape(-1), :3].astype(np.float32)
        p = p.reshape(M, B, 3, 3)
        flatp = p.reshape(M, B * 3, 3)
        lo = flatp.min(axis=1)
        hi = flatp.max(axis=1)
        center = (lo + hi) * np.float32(0.5)
        radius = np.sqrt(
            ((flatp - center[:, None]) ** 2).sum(axis=2).max(axis=1)
        )

        e1 = p[:, :, 1] - p[:, :, 0]
        e2 = p[:, :, 2] - p[:, :, 0]
        nrm = np.cross(e1, e2)
        ln = np.linalg.norm(nrm, axis=2, keepdims=True)
        live = ln[..., 0] > 0
        nrm = np.where(ln > 0, nrm / np.where(ln > 0, ln, 1), 0.0)
        axis = nrm.sum(axis=1)
        alen = np.linalg.norm(axis, axis=1, keepdims=True)
        axis = np.where(alen > 1e-20, axis / np.where(alen > 1e-20, alen, 1),
                        0.0)
        dots = (nrm * axis[:, None]).sum(axis=2)
        cutoff = np.where(live, dots, 2.0).min(axis=1)
        cutoff = np.where(
            (alen[:, 0] > 1e-20) & live.any(axis=1), cutoff, -1.0
        ).astype(np.float32)

        bounds = np.concatenate(
            [center, radius[:, None], axis, cutoff[:, None]], axis=1
        ).astype(np.float32)
        return bounds, mdraw, enabled

    def expand_corner_cols(self):
        """Column (SoA) per-corner expansion: one (48, T) f32 buffer whose
        row c*16+j holds channel j of triangle corner c (channels 0:4
        object-space position, 4:16 vertex attrs), plus the (T,) i32 draw
        id of each triangle (corners of a triangle share a draw)."""
        merged = np.concatenate([self.positions, self.attrs], axis=1)
        corners = merged[self.tri_vidx.reshape(-1)].reshape(-1, 3, 16)
        ccols = np.ascontiguousarray(
            corners.transpose(1, 2, 0).reshape(48, -1))
        tri_node = np.ascontiguousarray(self.vert_node[self.tri_vidx[:, 0]])
        return ccols, tri_node

    def host_arrays(self) -> dict:
        """The DEVICE_FIELDS as NumPy arrays (corner columns expanded)."""
        ccols, tri_node = self.expand_corner_cols()
        return {
            "positions": self.positions, "attrs": self.attrs,
            "tri_vidx": self.tri_vidx, "vert_node": self.vert_node,
            "node_to_world": self.node_to_world,
            "corner_cols": ccols, "tri_node": tri_node,
        }


def flatten_scene(scene, mesh_data, pad: bool = True,
                  vert_align: int = 128, tri_align: int = 256,
                  lod: int = 0, apply_materials: bool = False) -> FlatScene:
    """``lod`` selects the mesh LOD used for every draw.  ``apply_materials``
    folds each mesh's material base color into its vertex colors (the lit
    pipelines); the flat pipeline keeps raw vertex colors."""
    positions = []
    attrs = []
    tri_vidx = []
    vert_node = []
    node_mats = []
    draw_mesh = []
    vbase = 0

    for node in scene.nodes:
        transform = np.asarray(
            scene.transforms[node.transform_index], np.float32
        )
        for mesh_index in node.mesh_indices:
            mesh = mesh_data.meshes[mesh_index]
            verts = mesh_data.vertices_of(mesh)  # (nv, 16)
            mesh_lod = min(lod, mesh.num_lods - 1)
            idx = mesh_data.indices_of(mesh, lod=mesh_lod).astype(np.int64)

            draw_id = len(node_mats)
            node_mats.append(transform)
            draw_mesh.append(mesh_index)

            pos = np.ones((len(verts), 4), np.float32)
            pos[:, :3] = verts[:, V_POSITION]
            positions.append(pos)

            a = np.zeros((len(verts), 12), np.float32)
            a[:, 0:4] = verts[:, V_COLOR]
            if apply_materials and mesh_data.mesh_material:
                mi = mesh_data.mesh_material[mesh_index]
                if mi >= 0:
                    a[:, 0:4] *= np.asarray(
                        mesh_data.materials[mi].base_color, np.float32
                    )
            a[:, 4:6] = verts[:, V_UV]
            a[:, 6:9] = verts[:, V_NORMAL]
            a[:, 9:12] = verts[:, V_TANGENT][:, :3]
            attrs.append(a)

            vert_node.append(np.full(len(verts), draw_id, np.int32))
            tri_vidx.append((idx.reshape(-1, 3) + vbase).astype(np.int32))
            vbase += len(verts)

    positions = np.concatenate(positions, axis=0)
    attrs = np.concatenate(attrs, axis=0)
    tri_vidx = np.concatenate(tri_vidx, axis=0)
    vert_node = np.concatenate(vert_node, axis=0)
    num_triangles = len(tri_vidx)
    num_vertices = len(positions)

    if pad:
        nv = -(-num_vertices // vert_align) * vert_align
        nt = -(-num_triangles // tri_align) * tri_align
        if nv > num_vertices:
            extra = nv - num_vertices
            positions = np.concatenate(
                [positions, np.tile(np.array([[0, 0, 0, 1]], np.float32), (extra, 1))]
            )
            attrs = np.concatenate([attrs, np.zeros((extra, 12), np.float32)])
            vert_node = np.concatenate([vert_node, np.zeros(extra, np.int32)])
        if nt > num_triangles:
            # Degenerate (0,0,0) triangles: zero area -> culled in setup.
            padt = np.zeros((nt - num_triangles, 3), np.int32)
            tri_vidx = np.concatenate([tri_vidx, padt])

    return FlatScene(
        positions=positions,
        attrs=attrs,
        tri_vidx=tri_vidx,
        vert_node=vert_node,
        node_to_world=np.stack(node_mats, axis=0).astype(np.float32),
        num_triangles=num_triangles,
        num_vertices=num_vertices,
        draw_mesh=np.asarray(draw_mesh, np.int32),
    )


def flat_scene_to_device(arrays: dict, device) -> dict:
    """FlatScene fields as NumPy arrays -> the port's device buffers.

    ``arrays`` maps each name of DEVICE_FIELDS (the JAX package's
    ``FlatScene`` fields plus its ``expand_corner_cols`` output) to a NumPy
    array; returns contiguous tensors of the same dtype and shape on
    ``device`` (f32 stays f32, i32 stays i32)."""
    missing = [k for k in DEVICE_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"flat_scene_to_device: missing fields {missing}")
    out = {}
    for name in DEVICE_FIELDS:
        a = np.ascontiguousarray(arrays[name])
        if a.dtype not in (np.float32, np.int32):
            raise TypeError(f"{name}: expected float32 or int32, got {a.dtype}")
        # A copy on every device: the buffers never alias caller memory.
        out[name] = torch.from_numpy(a).to(device, copy=True)
    return out
