"""Procedural scenes of the port: the cube-lattice stress scene and the
random triangle soup, which ``chip_smoke.py`` drives through K3 and
through the clipper; the sphere field of the meshlet-culling frames; the
two-material cube pair; and ``one_tile_rows``, setup rows that crowd one
tile's list (K1's and K2d's staging, ``chip_smoke.py`` and the tests).

The scenes are copied from ``zrenderer_tpu/scene/procedural.py`` (only
these fixtures) so the port and ``chip_smoke.py`` build them without the
JAX package; ``tests/test_torch_host.py`` holds each equal to the
reference's.  Random draws come from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import numpy as np
import torch

from zrenderer_tpu_torch.math import zmath as zm
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.scene.mesh import Material, MeshData, make_vertex
from zrenderer_tpu_torch.scene.scene import Camera, Mobility, Node, Scene

# Placement constants of the reference test scene (test.gltf nodes).
CUBE2_TRANSLATION = (-2.2731475830078125, 0.9120144844055176, 2.2185516357421875)
CAMERA_TRANSLATION = (-1.5, 3.0, 10.0)
CAMERA_PARENT_QUAT = (0.6087614297866821, 0.0, 0.0, 0.7933533191680908)
CAMERA_CHILD_QUAT = (-0.7071067690849304, 0.0, 0.0, 0.7071067690849304)
CAMERA_YFOV = 0.39959652046304894
CAMERA_ZNEAR = 0.10000000149011612
CAMERA_ZFAR = 1000.0

_FACES = [
    # (normal, tangent, four corners CCW seen from outside, color)
    ((0, 0, 1), (1, 0, 0, 1), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)], (1, 0, 0, 1)),
    ((0, 0, -1), (-1, 0, 0, 1), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)], (0, 1, 0, 1)),
    ((1, 0, 0), (0, 0, -1, 1), [(1, -1, 1), (1, -1, -1), (1, 1, -1), (1, 1, 1)], (0, 0, 1, 1)),
    ((-1, 0, 0), (0, 0, 1, 1), [(-1, -1, -1), (-1, -1, 1), (-1, 1, 1), (-1, 1, -1)], (1, 1, 0, 1)),
    ((0, 1, 0), (1, 0, 0, 1), [(-1, 1, 1), (1, 1, 1), (1, 1, -1), (-1, 1, -1)], (1, 0, 1, 1)),
    ((0, -1, 0), (1, 0, 0, 1), [(-1, -1, -1), (1, -1, -1), (1, -1, 1), (-1, -1, 1)], (0, 1, 1, 1)),
]


def _morton_sorted(grid):
    """The (n, 3) integer grid cells in 3D Morton order."""
    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    morton = (spread(grid[:, 0]) | (spread(grid[:, 1]) << np.uint64(1))
              | (spread(grid[:, 2]) << np.uint64(2)))
    return grid[np.argsort(morton)]


def make_cube_mesh(mesh_data: MeshData, size: float = 1.0,
                   face_colors: bool = True) -> int:
    """Append a unit cube with one color per face (24 verts, 36
    indices); returns the mesh index.  ``face_colors=False`` makes every
    vertex white (the material fixture)."""
    verts = []
    indices = []
    uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for normal, tangent, corners, color in _FACES:
        base = len(verts)
        if not face_colors:
            color = (1, 1, 1, 1)
        for corner, uv in zip(corners, uvs):
            pos = tuple(c * size for c in corner)
            verts.append(make_vertex(pos, uv=uv, color=color, normal=normal, tangent=tangent))
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return mesh_data.append_mesh(
        np.stack(verts), np.array(indices, np.uint32)
    )


def make_material_scene() -> tuple:
    """Two side-by-side white cubes with different materials: a smooth
    metal (left) and a rough dielectric with a green emissive (right)."""
    mesh_data = MeshData()
    left = make_cube_mesh(mesh_data, face_colors=False)
    right = make_cube_mesh(mesh_data, face_colors=False)
    mesh_data.materials = [
        Material(metallic=1.0, roughness=0.15, name="metal"),
        Material(metallic=0.0, roughness=0.9, emissive=(0.0, 0.35, 0.0),
                 name="rough-glow"),
    ]
    mesh_data.mesh_material = [0, 1]

    scene = Scene()
    scene.nodes.append(Node(mesh_indices=[left], transform_index=0,
                            name="MetalCube"))
    scene.transforms.append(zm.translation(-1.6, 0.0, 0.0))
    scene.nodes.append(Node(mesh_indices=[right], transform_index=1,
                            name="GlowCube"))
    scene.transforms.append(zm.translation(1.6, 0.0, 0.0))
    scene.cameras.append(
        Camera(position=np.array([0.0, 0.0, 7.0], np.float32),
               forward=np.array([0.0, 0.0, -1.0], np.float32),
               yfov=0.8, znear=0.1, zfar=100.0, name="Camera"))
    return scene, mesh_data


def make_test_camera() -> Camera:
    """The reference test scene's camera, forward derived from its
    orientation."""
    orientation = zm.qmul(
        np.array(CAMERA_CHILD_QUAT, np.float32),
        np.array(CAMERA_PARENT_QUAT, np.float32),
    )
    pitch, yaw, _ = zm.quat_to_euler(orientation)
    return Camera(
        position=np.array(CAMERA_TRANSLATION, np.float32),
        forward=zm.rotate_vec3(orientation, (0.0, 0.0, -1.0))[:3],
        pitch=float(pitch),
        yaw=float(yaw),
        yfov=CAMERA_YFOV,
        znear=CAMERA_ZNEAR,
        zfar=CAMERA_ZFAR,
        name="Camera",
    )


def make_test_scene() -> tuple:
    """Two cube nodes and one camera, the reference test scene's layout
    (the scene of the stored 160x96 goldens)."""
    mesh_data = MeshData()
    cube = make_cube_mesh(mesh_data)

    scene = Scene()
    scene.nodes.append(Node(mesh_indices=[cube], transform_index=0,
                            mobility=Mobility.STATIC, name="Cube"))
    scene.transforms.append(zm.identity())
    scene.nodes.append(Node(mesh_indices=[cube], transform_index=1,
                            mobility=Mobility.STATIC, name="Cube.002"))
    scene.transforms.append(zm.translation(*CUBE2_TRANSLATION))
    scene.cameras.append(make_test_camera())
    return scene, mesh_data


def make_stress_scene(num_triangles: int = 1_000_000, seed: int = 0) -> tuple:
    """A dense lattice of colored cubes baked into one mesh, about
    ``num_triangles`` triangles, in Morton order so that consecutive raster
    blocks stay spatially coherent (what the block/superblock bbox skips
    exploit)."""
    rng = np.random.default_rng(seed)
    cubes = max(1, num_triangles // 12)
    side = int(np.ceil(cubes ** (1.0 / 3.0)))
    grid = np.stack(
        np.meshgrid(np.arange(side), np.arange(side), np.arange(side),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)[:cubes]
    grid = _morton_sorted(grid)

    spacing = 2.6
    centers = (grid - (side - 1) / 2.0) * spacing  # centered lattice

    # One canonical cube (24 verts, 36 indices), tiled per cube.
    base_md = MeshData()
    make_cube_mesh(base_md, size=1.0)
    base_verts = base_md.vertices_of(base_md.meshes[0])  # (24, 16)
    base_idx = base_md.indices_of(base_md.meshes[0]).astype(np.int64)  # (36,)

    verts = np.tile(base_verts, (cubes, 1)).reshape(cubes, 24, 16)
    verts[:, :, 0:3] += centers[:, None, :].astype(np.float32)
    colors = rng.uniform(0.1, 1.0, (cubes, 1, 3)).astype(np.float32)
    verts[:, :, 5:8] = colors  # per-cube flat color
    verts[:, :, 8] = 1.0
    verts = verts.reshape(cubes * 24, 16)

    idx = (base_idx[None, :] + (np.arange(cubes) * 24)[:, None]).reshape(-1)
    mesh_data = MeshData()
    mesh_data.append_mesh(verts, idx.astype(np.uint32))

    scene = Scene()
    scene.nodes.append(Node(mesh_indices=[0], transform_index=0, name="lattice"))
    scene.transforms.append(zm.identity())
    dist = side * spacing * 1.35
    eye = np.array([dist * 0.55, dist * 0.4, dist], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    scene.cameras.append(
        Camera(
            position=eye,
            forward=fwd.astype(np.float32),
            yfov=0.9,
            znear=0.5,
            zfar=float(6 * dist),
            name="stress-cam",
        )
    )
    return scene, mesh_data


def make_triangle_soup(
    num_triangles: int,
    seed: int = 0,
    extent: float = 4.0,
    behind_camera_fraction: float = 0.0,
    triangle_size: float = 1.0,
) -> tuple:
    """Random triangle soup.  ``behind_camera_fraction`` of the triangles
    are pushed past the camera (clipping); ``triangle_size`` scales each
    triangle around its center."""
    rng = np.random.default_rng(seed)
    n = num_triangles * 3
    verts = np.zeros((n, 16), np.float32)
    centers = rng.uniform(-extent, extent, size=(num_triangles, 1, 3))
    offsets = rng.uniform(-1.0, 1.0, size=(num_triangles, 3, 3)) * triangle_size
    pos = (centers + offsets).reshape(n, 3)
    if behind_camera_fraction > 0:
        k = int(num_triangles * behind_camera_fraction) * 3
        pos[:k, 2] += 40.0  # push past the camera to exercise clipping
    verts[:, 0:3] = pos
    verts[:, 5:9] = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    verts[:, 8] = 1.0
    indices = np.arange(n, dtype=np.uint32)

    mesh_data = MeshData()
    mesh = mesh_data.append_mesh(verts, indices)
    scene = Scene()
    scene.nodes.append(Node(mesh_indices=[mesh], transform_index=0, name="soup"))
    scene.transforms.append(zm.identity())
    scene.cameras.append(
        Camera(
            position=np.array([0, 0, 12], np.float32),
            forward=np.array([0, 0, -1], np.float32),
            yfov=0.8,
            znear=0.1,
            zfar=100.0,
            name="soupcam",
        )
    )
    return scene, mesh_data


def make_sphere_field(num_triangles: int = 1_000_000, seed: int = 0,
                      stacks: int = 64, slices: int = 128) -> tuple:
    """A field of UV spheres, the meshlet-culling fixture: closed convex
    surfaces where about half of every sphere's 128-triangle meshlets face
    away from any camera.  Spheres are Morton-ordered on a grid and each
    sphere's triangles go in 8x8 (stack, slice) patches, so each meshlet
    is one compact angular patch with a tight normal cone."""
    rng = np.random.default_rng(seed)
    per_sphere = 2 * stacks * slices
    count = max(1, num_triangles // per_sphere)
    side = int(np.ceil(count ** (1.0 / 3.0)))
    grid = np.stack(
        np.meshgrid(np.arange(side), np.arange(side), np.arange(side),
                    indexing="ij"),
        axis=-1,
    ).reshape(-1, 3)[:count]
    grid = _morton_sorted(grid)
    spacing = 3.0
    centers = (grid - (side - 1) / 2.0) * spacing

    # One canonical UV sphere.
    theta = np.linspace(0.0, np.pi, stacks + 1)
    phi = np.linspace(0.0, 2.0 * np.pi, slices + 1)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    sx = np.sin(tt) * np.cos(pp)
    sy = np.cos(tt)
    sz = np.sin(tt) * np.sin(pp)
    sv = np.stack([sx, sy, sz], axis=-1).reshape(-1, 3).astype(np.float32)
    nv = len(sv)
    base_verts = np.zeros((nv, 16), np.float32)
    base_verts[:, 0:3] = sv
    base_verts[:, 8] = 1.0
    base_verts[:, 9:12] = sv  # outward normal

    i0 = (np.arange(stacks)[:, None] * (slices + 1)
          + np.arange(slices)[None, :])
    quads = np.stack(
        [i0, i0 + slices + 1, i0 + slices + 2, i0 + 1], axis=-1
    ).reshape(-1, 4)
    # Patch-major quad order: 8x8 (stack, slice) tiles, one patch a
    # 128-triangle meshlet.
    P = 8
    if stacks % P == 0 and slices % P == 0:
        tiles = (np.arange(stacks * slices)
                 .reshape(stacks // P, P, slices // P, P)
                 .transpose(0, 2, 1, 3).reshape(-1))
        quads = quads[tiles]
    # CCW front faces seen from outside; both halves of a quad in one
    # meshlet.
    base_idx = np.stack(
        [quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]], axis=1
    ).reshape(-1, 3).astype(np.int64)

    verts = np.tile(base_verts, (count, 1)).reshape(count, nv, 16)
    verts[:, :, 0:3] += centers[:, None, :].astype(np.float32)
    colors = rng.uniform(0.1, 1.0, (count, 1, 3)).astype(np.float32)
    verts[:, :, 5:8] = colors
    verts = verts.reshape(count * nv, 16)
    idx = (base_idx[None] + (np.arange(count) * nv)[:, None, None])
    idx = idx.reshape(-1)

    mesh_data = MeshData()
    mesh_data.append_mesh(verts, idx.astype(np.uint32))
    scene = Scene()
    scene.nodes.append(
        Node(mesh_indices=[0], transform_index=0, name="sphere-field"))
    scene.transforms.append(zm.identity())
    dist = max(side * spacing * 1.35, 6.0)
    eye = np.array([dist * 0.55, dist * 0.4, dist], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    scene.cameras.append(
        Camera(
            position=eye,
            forward=fwd.astype(np.float32),
            yfov=0.9,
            znear=0.5,
            zfar=float(6 * dist),
            name="sphere-cam",
        )
    )
    return scene, mesh_data


def one_tile_rows(n: int = 1000, w: int = 128, h: int = 32, seed: int = 0,
                  device="cpu") -> tuple:
    """Setup rows (tri_i32, tri_f32) of n small front-facing triangles
    inside a (w, h) target through the identity matrix: at 128x32 one
    tile whose list holds most of them (n <= SMALL_BIN_MAX_ROWS head
    rows)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.9, 0.9, (n, 1, 2))
    ang = np.sort(rng.uniform(0.0, 2.0 * np.pi, (n, 3)), axis=1)
    r = rng.uniform(0.05, 0.3, (n, 1, 1))
    pos = np.zeros((n * 3, 4), np.float32)
    pos[:, :2] = (c + r * np.stack([np.cos(ang), np.sin(ang)],
                                   -1)).reshape(-1, 2)
    pos[:, 2] = np.repeat(rng.uniform(0.1, 0.9, n), 3)
    pos[:, 3] = 1.0
    attrs = rng.random((n * 3, 12), dtype=np.float32)
    attrs[:, 3] = 1.0
    return tg.geometry_pipeline(
        torch.from_numpy(pos).to(device), torch.from_numpy(attrs).to(device),
        torch.arange(n * 3, dtype=torch.int32, device=device).reshape(n, 3),
        torch.eye(4, device=device)[None],
        torch.zeros(n * 3, dtype=torch.int32, device=device), w, h)
