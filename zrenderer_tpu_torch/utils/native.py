"""ctypes bindings for the native runtime library (native/zrt_native.cpp).

The native layer covers what the reference implements in vendored C/C++
(SURVEY.md §2.2): fast binary asset IO (cgltf-era data path), mesh
optimization (meshoptimizer capabilities: index dedup/remap, vertex-cache
reordering, cache analysis), and PNG encode (frame dumping).  Everything
here has a pure-Python fallback, so the framework degrades gracefully when
the library cannot be built.

The port's copy of ``zrenderer_tpu/utils/native.py``: the same functions
and fallbacks, with its own build.  ``build_library`` compiles
``native/zrt_native.cpp`` in place with ``g++`` (the flags of
``native/Makefile``) into ``build/zrenderer_tpu_torch/native/<hash>/``,
keyed by a hash of the source and the command, as ``ops/_build.py`` does
for the CUDA kernels; it never writes into ``native/``.
``tests/test_torch_assets.py`` holds the two modules equal.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

log = logging.getLogger("zrenderer.native")

_LIB = None
_TRIED = False

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "zrt_native.cpp"
BUILD_ROOT = _ROOT / "build" / "zrenderer_tpu_torch" / "native"
LIB_NAME = "libzrt.so"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LD_FLAGS = ("-lz",)


def _lib_path() -> Path:
    """Where this source and command build (the file may not exist yet)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build_library() -> Path:
    """Compile the library unless this source hash was built already."""
    path = _lib_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build libzrt")
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        done = subprocess.run(
            [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp_lib), *LD_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{done.stdout}")
        os.replace(tmp_lib, path)  # atomic: readers see a whole library
    return path


def load(build_if_missing: bool = True):
    """Load (building on first use if needed) libzrt; returns None if
    unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not path.exists() and build_if_missing:
        try:
            path = build_library()
        except Exception as e:  # toolchain missing: fall back to Python
            log.warning("native build failed (%s); using Python fallbacks", e)
            return None
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))

    lib.zrt_version.restype = ctypes.c_uint32
    lib.zrt_meshes_probe.restype = ctypes.c_int
    lib.zrt_meshes_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.zrt_meshes_load.restype = ctypes.c_int
    lib.zrt_meshes_load.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.zrt_generate_vertex_remap.restype = ctypes.c_uint32
    lib.zrt_generate_vertex_remap.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.zrt_apply_remap.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
    ]
    lib.zrt_optimize_vertex_cache.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.zrt_analyze_vertex_cache.restype = ctypes.c_uint32
    lib.zrt_analyze_vertex_cache.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.zrt_spatial_sort_triangles.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
    ]
    lib.zrt_simplify.restype = ctypes.c_uint32
    lib.zrt_simplify.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_float, ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.zrt_optimize_vertex_fetch.restype = ctypes.c_uint32
    lib.zrt_optimize_vertex_fetch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.zrt_analyze_vertex_fetch.restype = ctypes.c_uint32
    lib.zrt_analyze_vertex_fetch.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32,
    ]
    lib.zrt_encode_png.restype = ctypes.c_uint64
    lib.zrt_encode_png.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
    ]
    lib.zrt_build_meshlets.restype = ctypes.c_uint32
    lib.zrt_build_meshlets.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.zrt_compute_meshlet_bounds.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_float),
    ]
    _LIB = lib
    log.info("libzrt loaded (version %d)", lib.zrt_version())
    return lib


def available() -> bool:
    return load() is not None


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def meshes_load(blob: bytes):
    """Fast meshes.bin payload load: (vertex_data f32, index_data u32)."""
    lib = load()
    if lib is None:
        from zrenderer_tpu_torch.scene.mesh import MeshData

        md = MeshData.deserialize(blob)
        return md.vertex_data, md.index_data
    nm = ctypes.c_uint32()
    nvf = ctypes.c_uint32()
    ni = ctypes.c_uint32()
    rc = lib.zrt_meshes_probe(blob, len(blob), nm, nvf, ni)
    if rc != 0:
        raise ValueError(f"bad meshes.bin (native rc={rc})")
    verts = np.empty(nvf.value, np.float32)
    idx = np.empty(ni.value, np.uint32)
    rc = lib.zrt_meshes_load(blob, len(blob), _f32p(verts), _u32p(idx))
    assert rc == 0
    return verts, idx


def generate_vertex_remap(vertices: np.ndarray) -> tuple:
    """Deduplicate (n, k) f32 vertices; returns (remap (n,) u32, unique count).
    Python fallback uses np.unique (order-preserving first-occurrence)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    n, k = vertices.shape
    lib = load()
    if lib is None:
        _, first_idx, inverse = np.unique(
            vertices.view([("", np.float32)] * k).reshape(n),
            return_index=True, return_inverse=True,
        )
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        return rank[inverse].astype(np.uint32), len(order)
    remap = np.empty(n, np.uint32)
    unique = lib.zrt_generate_vertex_remap(_f32p(vertices), n, k, _u32p(remap))
    return remap, int(unique)


def apply_remap(vertices: np.ndarray, remap: np.ndarray, unique: int,
                indices: np.ndarray) -> tuple:
    """Compact vertices by remap and rewrite indices; returns (verts, idx)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32).copy()
    n, k = vertices.shape
    out = np.empty((unique, k), np.float32)
    lib = load()
    if lib is None:
        out[remap] = vertices
        return out, remap[indices].astype(np.uint32)
    lib.zrt_apply_remap(
        _f32p(vertices), _f32p(out), n, k, _u32p(np.ascontiguousarray(remap)),
        _u32p(indices), len(indices),
    )
    return out, indices


def optimize_vertex_cache(indices: np.ndarray, vertex_count: int,
                          cache_size: int = 32) -> np.ndarray:
    """Reorder triangles for vertex-cache locality (native only; Python
    fallback returns the input unchanged — optimization is optional)."""
    indices = np.ascontiguousarray(indices, np.uint32).copy()
    lib = load()
    if lib is None:
        return indices
    lib.zrt_optimize_vertex_cache(
        _u32p(indices), len(indices), vertex_count, cache_size
    )
    return indices


def analyze_vertex_cache(indices: np.ndarray, vertex_count: int,
                         cache_size: int = 32) -> float:
    """Average cache miss rate (misses per triangle)."""
    indices = np.ascontiguousarray(indices, np.uint32)
    lib = load()
    if lib is None:  # simple Python FIFO model
        last = {}
        t = 0
        misses = 0
        for v in indices:
            v = int(v)
            if v not in last or t - last[v] > cache_size:
                misses += 1
                last[v] = t
                t += 1
        return misses / max(1, len(indices) // 3)
    return lib.zrt_analyze_vertex_cache(
        _u32p(indices), len(indices), vertex_count, cache_size
    ) / 1000.0


def optimize_vertex_fetch(vertices: np.ndarray, indices: np.ndarray) -> tuple:
    """Reorder vertices into first-use order of the index buffer (the
    meshoptimizer vfetchoptimizer capability): after vertex-cache triangle
    ordering, the vertex FETCH then walks memory near-sequentially.
    Returns (vertices_out, indices_out, unique_count); unused vertices are
    dropped.  Python fallback included.  Anchor: common/build.zig:49-52
    (compiled in the reference, never called — VERDICT r2 missing item 2)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32).copy()
    n, fpv = vertices.shape
    lib = load()
    if lib is None:
        order = []
        remap = np.full(n, 0xFFFFFFFF, np.uint32)
        for v in indices:
            if remap[v] == 0xFFFFFFFF:
                remap[v] = len(order)
                order.append(int(v))
        return vertices[order], remap[indices], len(order)
    out = np.empty_like(vertices)
    unique = lib.zrt_optimize_vertex_fetch(
        _f32p(vertices), _f32p(out), _u32p(indices), len(indices), n, fpv
    )
    return out[:unique].copy(), indices, int(unique)


def analyze_vertex_fetch(indices: np.ndarray, vertex_count: int,
                         bytes_per_vertex: int) -> float:
    """Fetch overfetch ratio: bytes pulled through a 64-B-line, 16-line
    FIFO cache while walking the index buffer, over the ideal (each used
    vertex once).  1.0 = perfect locality; lower is better."""
    indices = np.ascontiguousarray(indices, np.uint32)
    lib = load()
    if lib is None:  # Python model mirroring the native one
        lines: list = []
        fetched = 0
        seen = set()
        for v in indices:
            v = int(v)
            seen.add(v)
            b0 = v * bytes_per_vertex
            b1 = b0 + bytes_per_vertex - 1
            for line in range(b0 // 64, b1 // 64 + 1):
                if line not in lines:
                    fetched += 64
                    lines.append(line)
                    if len(lines) > 16:
                        lines.pop(0)
        ideal = len(seen) * bytes_per_vertex
        return fetched / max(ideal, 1)
    return lib.zrt_analyze_vertex_fetch(
        _u32p(indices), len(indices), vertex_count, bytes_per_vertex
    ) / 1000.0


def spatial_sort_triangles(indices: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Reorder triangles along a Morton curve of their centroids (the
    meshoptimizer spatialorder capability) — keeps raster-block union bboxes
    compact for the binning kernels.  Python fallback included."""
    indices = np.ascontiguousarray(indices, np.uint32).copy()
    vertices = np.ascontiguousarray(vertices, np.float32)
    lib = load()
    if lib is None:
        tri = indices.reshape(-1, 3)
        cent = vertices[tri.astype(np.int64), :3].mean(axis=1)
        lo = cent.min(axis=0)
        ext = np.maximum(cent.max(axis=0) - lo, 1e-12)
        q = ((cent - lo) / ext * 1023).astype(np.uint64)

        def spread(x):
            x = (x | (x << 16)) & np.uint64(0x30000FF)
            x = (x | (x << 8)) & np.uint64(0x300F00F)
            x = (x | (x << 4)) & np.uint64(0x30C30C3)
            x = (x | (x << 2)) & np.uint64(0x9249249)
            return x

        key = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
            spread(q[:, 2]) << np.uint64(2)
        )
        return tri[np.argsort(key, kind="stable")].reshape(-1)
    lib.zrt_spatial_sort_triangles(
        _u32p(indices), len(indices), _f32p(vertices), vertices.shape[1]
    )
    return indices


def simplify(indices: np.ndarray, vertices: np.ndarray,
             target_index_count: int, max_error: float = 0.05) -> np.ndarray:
    """Quadric-error edge-collapse simplification (the meshoptimizer
    simplify capability — LOD generation for the mesh format's LOD slots).
    Collapses onto existing vertices only, so LOD index ranges share one
    vertex buffer; border vertices are locked.  ``max_error`` is relative
    to the bounding-box diagonal.  Python fallback implements the same
    algorithm (slower; fine for offline conversion of small meshes)."""
    indices = np.ascontiguousarray(indices, np.uint32)
    vertices = np.ascontiguousarray(vertices, np.float32)
    n, k = vertices.shape
    lib = load()
    if lib is not None:
        out = np.empty(len(indices), np.uint32)
        count = lib.zrt_simplify(
            _u32p(indices), len(indices), _f32p(vertices), n, k,
            int(target_index_count), float(max_error), _u32p(out),
        )
        return out[:count].copy()
    return _simplify_py(indices, vertices, target_index_count, max_error)


def _simplify_py(indices, vertices, target_index_count, max_error):
    """Pure-Python QEM edge collapse (same semantics as zrt_simplify)."""
    import heapq

    pos = vertices[:, :3].astype(np.float64)
    tris = indices.reshape(-1, 3).astype(np.int64).tolist()
    nv = len(pos)
    diag2 = float(((pos.max(0) - pos.min(0)) ** 2).sum())
    limit = max_error * max_error * diag2

    quad = [np.zeros((4, 4)) for _ in range(nv)]
    edge_count: dict = {}
    vtx_tris = [[] for _ in range(nv)]
    tri_dead = [False] * len(tris)
    for t, (a, b, c) in enumerate(tris):
        n = np.cross(pos[b] - pos[a], pos[c] - pos[a])
        ln = np.linalg.norm(n)
        area = 0.5 * ln
        if ln > 1e-30:
            n = n / ln
        d = -np.dot(n, pos[a])
        p = np.append(n, d)
        q = area * np.outer(p, p)
        for v in (a, b, c):
            quad[v] += q
            vtx_tris[v].append(t)
        for e in ((a, b), (b, c), (c, a)):
            e = (min(e), max(e))
            edge_count[e] = edge_count.get(e, 0) + 1
    border = [False] * nv
    for (u, w), cnt in edge_count.items():
        if cnt == 1:
            border[u] = border[w] = True

    remap = list(range(nv))

    def find(v):
        while remap[v] != v:
            remap[v] = remap[remap[v]]
            v = remap[v]
        return v

    gen = [0] * nv
    heap: list = []

    def err_of(v, w):
        q = quad[v] + quad[w]
        h = np.append(pos[w], 1.0)
        return float(h @ q @ h)

    def push(v):
        v = find(v)
        if border[v]:
            return
        for t in vtx_tris[v]:
            if tri_dead[t]:
                continue
            for w0 in tris[t]:
                w = find(w0)
                if w != v:
                    heapq.heappush(
                        heap, (err_of(v, w), v, w, gen[v] + gen[w])
                    )

    for v in range(nv):
        push(v)

    live = len(tris)
    target = target_index_count // 3
    while live > target and heap:
        e, frm, to, g_ = heapq.heappop(heap)
        if find(frm) != frm or find(to) != to or frm == to:
            continue
        if g_ != gen[frm] + gen[to] or border[frm]:
            continue
        if e > limit:
            break
        remap[frm] = to
        quad[to] = quad[to] + quad[frm]
        gen[to] += 1
        for t in vtx_tris[frm]:
            if tri_dead[t]:
                continue
            a, b, c = (find(x) for x in tris[t])
            if a == b or b == c or c == a:
                tri_dead[t] = True
                live -= 1
            else:
                vtx_tris[to].append(t)
        push(to)
        for t in vtx_tris[to]:
            if not tri_dead[t]:
                for w in tris[t]:
                    push(find(w))

    out = []
    for t, dead in enumerate(tri_dead):
        if dead:
            continue
        a, b, c = (find(x) for x in tris[t])
        if a != b and b != c and c != a:
            out += [a, b, c]
    return np.asarray(out, np.uint32)


def encode_png(rgba: np.ndarray) -> bytes:
    """Native PNG encode with pure-Python fallback."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    assert rgba.ndim == 3 and rgba.shape[2] == 4
    lib = load()
    if lib is None:
        from zrenderer_tpu_torch.utils.png import encode_png as py_encode

        return py_encode(rgba)
    h, w = rgba.shape[:2]
    cap = rgba.nbytes + 4096
    out = np.empty(cap, np.uint8)
    size = lib.zrt_encode_png(
        rgba.tobytes(), w, h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if size == 0:
        from zrenderer_tpu_torch.utils.png import encode_png as py_encode

        return py_encode(rgba)
    return out[:size].tobytes()


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def build_meshlets(indices: np.ndarray, vertices: np.ndarray,
                   max_vertices: int = 64, max_triangles: int = 126):
    """Split an indexed mesh into meshlets (the meshoptimizer clusterizer
    capability — compiled in the reference, never called:
    common/build.zig:49-52).  Greedy growth over vertex-shared adjacency
    from Morton-ordered seeds; each step adds the candidate introducing
    the fewest new unique vertices (tie: lowest Morton rank).

    Returns (desc, meshlet_vertices, meshlet_triangles):
    desc (n, 4) uint32 rows of (vertex_offset, triangle_offset,
    vertex_count, triangle_count) into the two pools; meshlet_vertices
    uint32 global vertex ids; meshlet_triangles (total_tris, 3) uint8
    local corner indices.  The Python fallback implements the identical
    algorithm (asserted equal in tests/test_native.py)."""
    indices = np.ascontiguousarray(indices, np.uint32)
    vertices = np.ascontiguousarray(vertices, np.float32)
    tri_count = len(indices) // 3
    n, fpv = vertices.shape
    assert 3 <= max_vertices <= 256 and max_triangles >= 1
    lib = load()
    if lib is not None:
        desc = np.empty((tri_count, 4), np.uint32)
        mv = np.empty(3 * tri_count, np.uint32)
        mt = np.empty(3 * tri_count, np.uint8)
        count = lib.zrt_build_meshlets(
            _u32p(indices), len(indices), _f32p(vertices), n, fpv,
            max_vertices, max_triangles, _u32p(desc.reshape(-1)),
            _u32p(mv), _u8p(mt),
        )
        desc = desc[:count].copy()
        total_v = int(desc[:, 0][-1] + desc[:, 2][-1]) if count else 0
        total_t = int(desc[:, 1][-1] + desc[:, 3][-1]) if count else 0
        return desc, mv[:total_v].copy(), mt[:3 * total_t].reshape(-1, 3).copy()

    # Python fallback: the same greedy algorithm.
    # Single-precision quantization throughout, matching the native path
    # exactly (the seed order must agree for identical output).
    cent = (vertices[indices.reshape(-1, 3), :3].sum(
        axis=1, dtype=np.float32) / np.float32(3.0))
    mn = cent.min(axis=0)
    ext = cent.max(axis=0) - mn
    scale = np.where(
        ext > 0, np.float32(2097151.0) / np.where(ext > 0, ext, 1), 0.0
    ).astype(np.float32)
    q = ((cent - mn) * scale).astype(np.uint32)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    key = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    order = np.argsort(key, kind="stable").astype(np.uint32)
    rank = np.empty(tri_count, np.uint32)
    rank[order] = np.arange(tri_count, dtype=np.uint32)

    tris = indices.reshape(-1, 3)
    vt: list = [[] for _ in range(n)]
    for t in range(tri_count):
        for v in tris[t]:
            vt[v].append(t)

    tri_used = np.zeros(tri_count, bool)
    vert_epoch = np.zeros(n, np.int64)
    vert_local = np.zeros(n, np.uint32)
    cand_epoch = np.zeros(tri_count, np.int64)
    desc_rows = []
    pool_v: list = []
    pool_t: list = []
    seed_cursor = 0
    epoch = 0
    while True:
        while seed_cursor < tri_count and tri_used[order[seed_cursor]]:
            seed_cursor += 1
        if seed_cursor >= tri_count:
            break
        epoch += 1
        cand: list = []
        mv_n = mt_n = 0
        vbase, tbase = len(pool_v), len(pool_t)
        next_tri = int(order[seed_cursor])
        while next_tri != -1:
            t = next_tri
            tri_used[t] = True
            row = []
            for v in tris[t]:
                v = int(v)
                if vert_epoch[v] != epoch:
                    vert_epoch[v] = epoch
                    vert_local[v] = mv_n
                    pool_v.append(v)
                    mv_n += 1
                    for t2 in vt[v]:
                        if not tri_used[t2] and cand_epoch[t2] != epoch:
                            cand_epoch[t2] = epoch
                            cand.append(t2)
                row.append(int(vert_local[v]))
            pool_t.append(row)
            mt_n += 1
            next_tri = -1
            if mt_n < max_triangles:
                best_new, best_rank = 4, 1 << 32
                keep = []
                for t2 in cand:
                    if tri_used[t2]:
                        continue
                    keep.append(t2)
                    nn = sum(
                        1 for v in tris[t2] if vert_epoch[int(v)] != epoch
                    )
                    if mv_n + nn > max_vertices:
                        continue
                    if nn < best_new or (nn == best_new
                                         and rank[t2] < best_rank):
                        best_new, best_rank, next_tri = nn, int(rank[t2]), t2
                cand = keep
        desc_rows.append((vbase, tbase, mv_n, mt_n))
    desc = np.asarray(desc_rows, np.uint32).reshape(-1, 4)
    return (desc, np.asarray(pool_v, np.uint32),
            np.asarray(pool_t, np.uint8).reshape(-1, 3))


def compute_meshlet_bounds(desc: np.ndarray, meshlet_vertices: np.ndarray,
                           meshlet_triangles: np.ndarray,
                           vertices: np.ndarray) -> np.ndarray:
    """Per-meshlet culling bounds: (n, 8) float32 rows of
    [cx, cy, cz, radius, ax, ay, az, cutoff] — centroid bounding sphere
    + normal cone (axis = normalized mean unit geometric normal; cutoff
    = min dot(axis, normal); -1 for degenerate cones, never cullable)."""
    desc = np.ascontiguousarray(desc, np.uint32)
    meshlet_vertices = np.ascontiguousarray(meshlet_vertices, np.uint32)
    meshlet_triangles = np.ascontiguousarray(meshlet_triangles, np.uint8)
    vertices = np.ascontiguousarray(vertices, np.float32)
    count = len(desc)
    fpv = vertices.shape[1]
    lib = load()
    if lib is not None:
        bounds = np.empty((count, 8), np.float32)
        lib.zrt_compute_meshlet_bounds(
            _u32p(desc.reshape(-1)), count, _u32p(meshlet_vertices),
            _u8p(meshlet_triangles.reshape(-1)), _f32p(vertices), fpv,
            _f32p(bounds.reshape(-1)),
        )
        return bounds
    bounds = np.empty((count, 8), np.float32)
    for m, (vb, tb, nv, nt) in enumerate(desc):
        pos = vertices[meshlet_vertices[vb:vb + nv], :3]
        # float32 accumulation to match the native single-precision path
        c = pos.sum(axis=0, dtype=np.float32) / np.float32(max(nv, 1))
        r = np.sqrt(((pos - c) ** 2).sum(axis=1).max()) if nv else 0.0
        local = meshlet_triangles[tb:tb + nt]
        p = vertices[meshlet_vertices[vb + local.astype(np.uint32)], :3]
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        nrm = np.cross(e1, e2)
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = np.where(ln > 0, nrm / np.where(ln > 0, ln, 1), 0.0)
        axis = nrm.sum(axis=0)
        alen = np.linalg.norm(axis)
        if alen > 1e-20:
            axis = axis / alen
            cutoff = float((nrm @ axis).min()) if nt else 1.0
        else:
            axis = np.zeros(3)
            cutoff = -1.0
        bounds[m] = [*c, r, *axis, cutoff]
    return bounds
