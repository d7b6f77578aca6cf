"""Geometry stage in torch: transform -> capped clip -> snap -> setup.

Counterpart of ``zrenderer_tpu/ops/geometry.py``: the column path
(``geometry_pipeline_cols``, ``clip_triangles_cols``, ``_setup_cols``),
the indexed path the sharded frames call (``geometry_pipeline`` with
``transform_positions``, ``transform_normals``, ``assemble_triangles``, the
capped and the dense clipper, the vertex-shader hook), the binning helpers
(``compact_triangles``, ``block_bounds``, ``super_bounds``), the
meshlet visibility test (``meshlet_keep_mask``), plus the setup-row
layout, the size rules and the per-frame view-projection they depend on.

The indexed path transforms each vertex once, gathers the triangles'
corners into the column form and shares the column path's clipper and
setup: both only move the per-corner values, so its rows are the bits of
the reference's indexed stage.

Parity (docs/RASTER_SPEC.md §5): every f32 expression keeps the reference's
association, and eager torch rounds after every op, so the port is
bit-identical to the NumPy path on the CPU.  Rules that keep it so:

* the vertex transform is written as explicit multiply-adds, never
  ``matmul``/``einsum`` (the reduction order is part of the contract);
* no fused torch ops (``addcmul``, ``lerp``) and no division of a tensor by
  a Python scalar (CUDA turns that into a multiply by the reciprocal);
  ``1/x`` is ``torch.reciprocal``;
* Python-float constants are rounded to float32 first (``_f32``), so they
  equal the reference's ``xp.float32(...)`` scalars.

Where the reference shapes its code around TPU limits the port keeps the
semantics and drops the workaround: the one-hot ``dot_general`` matrix
expansion is a plain gather, and the clipper's chains of static-row
selects are one gather (cyclic successor) and two scatters (compaction)
over a (channel, slot, triangle) tensor.  Both only move values, so the
results are the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from zrenderer_tpu_torch.math import zmath as zm

# --- Layout constants and size rules (docs/RASTER_SPEC.md §1-2) -------------
# The same values as ``zrenderer_tpu/ops/geometry.py``, which the setup rows'
# bit parity depends on; tests/test_torch_host.py holds the two equal.
SUBPIXEL_BITS = 3
SUBPIXEL = 1 << SUBPIXEL_BITS  # 8 subpixel positions per axis
GUARD_PX = 960  # preferred guard band beyond each viewport edge, in pixels
MAX_SPAN_PX = 4096  # (W + 2*guard) must stay <= this (int32 exactness)
CLIP_MAX_VERTS = 8  # 3 verts + 5 planes (near + 4 guard)
FAN_SLOTS = CLIP_MAX_VERTS - 2  # 6 triangles per input after full clipping
CLIP_CAP_MIN = 1024
ATTR_FLOATS = 16  # clip xyzw, color rgba, uv, normal, tangent.xyz
RASTER_BLOCK = 128  # rows per raster block (block-skip granularity)
SUPER_BLOCK = 32  # blocks per superblock (level-1 skip granularity)

# Setup row integer columns (NI32): snapped corners, edge deltas, fill-rule
# biases, pixel bbox, valid flag.
I_X0, I_Y0, I_X1, I_Y1, I_X2, I_Y2 = range(6)
I_DX0, I_DY0, I_DX1, I_DY1, I_DX2, I_DY2 = range(6, 12)
I_BIAS0, I_BIAS1, I_BIAS2 = range(12, 15)
I_JMIN, I_JMAX, I_IMIN, I_IMAX = range(15, 19)
I_VALID = 19
NI32 = 20

# Setup row float columns (NF32): per-edge-function coefficients of z,
# 1/w and the perspective-correct color, uv and normal numerators (the flat
# kernels read the first 15), then the per-triangle constants the G-buffer
# kernels latch without interpolation: metallic, roughness, emissive rgb
# and texture layer (zero without a material table).  The rest is zero.
F_ZA0, F_ZA1, F_ZA2 = range(3)
F_RW0, F_RW1, F_RW2 = range(3, 6)
F_CR0, F_CR1, F_CR2 = range(6, 9)
F_CG0, F_CG1, F_CG2 = range(9, 12)
F_CB0, F_CB1, F_CB2 = range(12, 15)
F_U0, F_U1, F_U2 = range(15, 18)
F_V0, F_V1, F_V2 = range(18, 21)
F_NX0, F_NX1, F_NX2 = range(21, 24)
F_NY0, F_NY1, F_NY2 = range(24, 27)
F_NZ0, F_NZ1, F_NZ2 = range(27, 30)
F_MET, F_RGH, F_EMR, F_EMG, F_EMB, F_TEX = range(30, 36)
MATERIAL_COLS = 6  # metallic, roughness, emissive rgb, texture layer
NF32 = 40

_INT_MAX = 2**31 - 1
F32 = torch.float32
I32 = torch.int32


def guard_px(extent: int) -> int:
    """Guard band for a viewport extent: the preferred 960 px, shrunk so
    the snapped span stays inside the exact-int32 budget."""
    assert extent <= MAX_SPAN_PX - 64, f"viewport extent {extent} too large"
    return min(GUARD_PX, (MAX_SPAN_PX - extent) // 2)


def clip_cap_for(num_tris: int) -> int:
    """Capacity of the capped clipper's subset of T triangles."""
    return min(num_tris, max(CLIP_CAP_MIN, num_tris // 64))


def capped_rows(num_tris: int) -> int:
    """Setup rows of the capped layout for T input triangles."""
    return num_tris + FAN_SLOTS * clip_cap_for(num_tris)


def head_count(total_rows: int) -> int:
    """Invert ``capped_rows`` (it is strictly increasing in T)."""
    lo, hi = 1, total_rows
    while lo < hi:
        mid = (lo + hi) // 2
        if capped_rows(mid) < total_rows:
            lo = mid + 1
        else:
            hi = mid
    assert capped_rows(lo) == total_rows, (total_rows, lo)
    return lo


def view_proj_from_camera(camera, width: int, height: int) -> np.ndarray:
    """Per-frame view-projection matrix (host f32): RH look-at toward
    position + forward, RH perspective with the viewport's aspect, then
    view @ proj."""
    view = zm.look_at_rh(
        zm.load_vec3(camera.position),
        zm.load_vec3(np.asarray(camera.position) + np.asarray(camera.forward)),
        zm.f32x4(0.0, 1.0, 0.0, 0.0),
    )
    zfar = camera.zfar if camera.zfar > camera.znear else 1000.0
    proj = zm.perspective_fov_rh(
        camera.yfov, float(width) / float(height), camera.znear, zfar
    )
    return zm.mul(view, proj)


def _f32(x: float) -> float:
    """``x`` rounded to float32 (the value ``np.float32(x)`` holds)."""
    return float(np.float32(x))


def _guard_scales(width: int, height: int):
    gx = _f32(1.0 + 2.0 * guard_px(width) / float(width))
    gy = _f32(1.0 + 2.0 * guard_px(height) / float(height))
    return gx, gy


def _plane_distance(x, y, z, w, plane: int, gx: float, gy: float):
    """Signed inside-distance to clip plane ``plane`` (near, then the four
    guard planes), the reference's ``_plane_distance_col``."""
    if plane == 0:
        return z
    if plane == 1:
        return gx * w - x
    if plane == 2:
        return gx * w + x
    if plane == 3:
        return gy * w - y
    return gy * w + y


def geometry_pipeline_cols(ccols, tri_node, matrices, width: int,
                           height: int, normal_matrices=None,
                           material_table=None, clip_cap="auto"):
    """Column-form per-corner geometry stage.

    ``ccols``: (48, T) f32, row c*16+j = channel j of triangle corner c
    (``FlatScene.expand_corner_cols``).  ``tri_node``: (T,) i32 draw of
    each triangle.  ``matrices``: (D, 4, 4) f32 object_to_clip per draw
    (row-vector convention).  ``normal_matrices``: optional (D, 3, 3) f32
    per-draw normal transforms (row-vector convention).
    ``material_table``: optional (T, MATERIAL_COLS) per-triangle or
    (D, MATERIAL_COLS) per-draw f32 constants for columns F_MET..F_TEX.
    All on one device.

    Returns (tri_i32 (R, NI32) i32, tri_f32 (R, NF32) f32) with
    R = capped_rows(T): T slot-0 rows in submission order, then
    FAN_SLOTS * cap subset-fan rows, slot-major.
    """
    t = ccols.shape[1]
    clip = _clip_positions(ccols, tri_node, matrices)  # (corner, j, T)
    attr = ccols.reshape(3, ATTR_FLOATS, t)[:, 4:]
    if normal_matrices is not None:
        nm = normal_matrices.reshape(-1, 9)[tri_node.long()].T.reshape(3, 3, t)
        n = attr[:, 6:9]  # (corner, i, T): channels 10-12
        normal = ((n[:, 0:1] * nm[0] + n[:, 1:2] * nm[1])
                  + n[:, 2:3] * nm[2])  # (corner, j, T)
        attr = torch.cat([attr[:, :6], normal, attr[:, 9:]], dim=1)
    cols = torch.cat([clip, attr], dim=1)  # (corner, channel, T)
    per_tri = None
    if material_table is not None:
        per_tri = (material_table if material_table.shape[0] == t
                   else material_table[tri_node.long()])
    return _clip_and_setup(cols, per_tri, width, height, clip_cap)


def _clip_and_setup(cols, per_tri, width: int, height: int, clip_cap):
    """Clip and set up (corner, channel, T) clip-space corner columns.
    ``per_tri``: None or (T, MATERIAL_COLS) material constants.
    ``clip_cap``: "auto", an int (the capped layout) or None (the dense
    slot-major layout)."""
    t = cols.shape[2]
    dev = cols.device
    if clip_cap is None:
        fan, valid = clip_triangles_cols(cols, width, height)
        consts = None if per_tri is None else per_tri.repeat(FAN_SLOTS, 1)
        return _setup_cols(fan, valid, width, height,
                           None if consts is None else consts.T.to(F32))
    cap = clip_cap_for(t) if clip_cap == "auto" else min(clip_cap, t)

    # -- clip classification + capped subset selection.
    needs, slot0_valid = _classify(cols[:, 0:4], width, height)

    # First ``cap`` crossing triangles in ascending order: slot j takes
    # the first i with cumsum(needs)[i] == j + 1 (no host sync).
    c_ = torch.cumsum(needs.to(I32), dim=0, dtype=I32)
    j_ = torch.arange(cap, dtype=I32, device=dev)
    idx = torch.searchsorted(c_, j_ + 1, side="left").to(I32)
    live = j_ < c_[-1]
    idx = torch.where(live, torch.clamp_max(idx, t - 1), 0)

    fan, valid_s = clip_triangles_cols(cols[:, :, idx.long()], width, height)
    valid_s = valid_s & live.repeat(FAN_SLOTS)
    valid = torch.cat([slot0_valid, valid_s])

    consts = None
    if per_tri is not None:
        sub = per_tri[idx.long()]
        consts = torch.cat([per_tri, sub.repeat(FAN_SLOTS, 1)]).T.to(F32)
    return _setup_cols(torch.cat([cols, fan], dim=2), valid, width, height,
                       consts)


# ---------------------------------------------------------------------------
# Indexed geometry (per-vertex rows + triangle vertex indices)
# ---------------------------------------------------------------------------


def transform_positions(positions, matrices, node_ids):
    """Object -> clip transform of (N, 4) positions by each vertex's draw
    matrix (row-vector: p @ M), as explicit multiply-adds in the
    reference's association.  ``node_ids``: (N,) i32."""
    m = matrices.reshape(-1, 16)[node_ids.long()].reshape(-1, 4, 4)
    p = positions
    return ((p[:, 0:1] * m[:, 0] + p[:, 1:2] * m[:, 1])
            + (p[:, 2:3] * m[:, 2] + p[:, 3:4] * m[:, 3]))


def transform_normals(attrs, normal_matrices, node_ids):
    """Rotate the (N, 12) attrs' normals (channels 6:9) by each vertex's
    (3, 3) draw normal matrix (row-vector: n @ NM)."""
    nm = normal_matrices.reshape(-1, 9)[node_ids.long()].reshape(-1, 3, 3)
    n = attrs[:, 6:9]
    out = (n[:, 0:1] * nm[:, 0] + n[:, 1:2] * nm[:, 1]) + n[:, 2:3] * nm[:, 2]
    return torch.cat([attrs[:, 0:6], out, attrs[:, 9:]], dim=1)


def assemble_triangles(clip_pos, attrs, tri_vidx):
    """(T, 3, ATTR_FLOATS) corners: clip position in channels 0:4, then
    the attrs, gathered by the (T, 3) vertex indices."""
    merged = torch.cat([clip_pos, attrs], dim=-1)
    return merged[tri_vidx.long()]


def _indexed_corners(positions, attrs, tri_vidx, matrices, node_ids,
                     normal_matrices=None, vertex_shader=None):
    """(corner, channel, T) clip-space corner columns of the indexed
    inputs: the vertex shader (object space), the transform, the normals,
    the corner gather."""
    if vertex_shader is not None:
        positions, attrs = vertex_shader(positions, attrs)
    clip_pos = transform_positions(positions, matrices, node_ids)
    if normal_matrices is not None:
        attrs = transform_normals(attrs, normal_matrices, node_ids)
    return assemble_triangles(clip_pos, attrs, tri_vidx).permute(1, 2, 0)


def geometry_pipeline(positions, attrs, tri_vidx, matrices, node_ids,
                      width: int, height: int, normal_matrices=None,
                      material_table=None, vertex_shader=None,
                      clip_cap="auto"):
    """Indexed geometry stage (the reference's ``geometry_pipeline`` with
    per-vertex rows).

    ``positions`` (N, 4) and ``attrs`` (N, 12) f32 per-vertex rows,
    ``tri_vidx`` (T, 3) i32, ``matrices`` (D, 4, 4) f32 object_to_clip per
    draw, ``node_ids`` (N,) i32 each vertex's draw.  ``normal_matrices``:
    optional (D, 3, 3).  ``material_table``: optional (T, MATERIAL_COLS)
    per-triangle or (D, MATERIAL_COLS) per-draw rows (a triangle takes its
    vertex 0's draw).  ``vertex_shader``: optional ``fn(positions (N, 4),
    attrs (N, 12)) -> (positions, attrs)`` on torch tensors, applied in
    object space before the transform.  ``clip_cap``: "auto" or an int
    for the capped layout (``capped_rows(T)`` rows: T slot-0 rows, then
    FAN_SLOTS * cap subset-fan rows, slot-major), None for the dense
    slot-major FAN_SLOTS * T layout.  Returns (tri_i32, tri_f32)."""
    cols = _indexed_corners(positions, attrs, tri_vidx, matrices, node_ids,
                            normal_matrices, vertex_shader)
    per_tri = None
    if material_table is not None:
        t = tri_vidx.shape[0]
        per_tri = (material_table if material_table.shape[0] == t
                   else material_table[node_ids[tri_vidx[:, 0].long()].long()])
    return _clip_and_setup(cols, per_tri, width, height, clip_cap)


def clip_overflow_count_indexed(positions, attrs, tri_vidx, matrices,
                                node_ids, width: int, height: int,
                                clip_cap="auto", vertex_shader=None):
    """``clip_overflow_count`` of the indexed inputs: the crossing
    triangles the capped clipper drops, ``max(n_crossing - cap, 0)`` as an
    int32 device scalar."""
    t = tri_vidx.shape[0]
    cap = clip_cap_for(t) if clip_cap == "auto" else min(clip_cap, t)
    cols = _indexed_corners(positions, attrs, tri_vidx, matrices, node_ids,
                            vertex_shader=vertex_shader)
    needs, _ = _classify(cols[:, 0:4], width, height)
    return torch.clamp_min(needs.sum(dtype=I32) - cap, 0)


def _clip_positions(ccols, tri_node, matrices):
    """Clip-space corners (corner, j, T): each corner's position times its
    draw's matrix, as explicit multiply-adds (m[i, j] is row i, column j)."""
    t = ccols.shape[1]
    m = matrices.reshape(-1, 16)[tri_node.long()].T.reshape(4, 4, t)
    pos = ccols.reshape(3, ATTR_FLOATS, t)[:, 0:4]  # (corner, i, T)
    return ((pos[:, 0:1] * m[0] + pos[:, 1:2] * m[1])
            + (pos[:, 2:3] * m[2] + pos[:, 3:4] * m[3]))


def _classify(clip, width: int, height: int):
    """(needs, slot0_valid), each (T,) bool: a triangle crossing a plane
    without lying wholly outside one needs the clipper; slot 0 keeps the
    triangles inside every plane."""
    gx, gy = _guard_scales(width, height)
    x, y, z, w = clip[:, 0], clip[:, 1], clip[:, 2], clip[:, 3]
    t = clip.shape[2]
    crossing = torch.zeros(t, dtype=torch.bool, device=clip.device)
    fully_out = torch.zeros(t, dtype=torch.bool, device=clip.device)
    for plane in range(5):
        neg = _plane_distance(x, y, z, w, plane, gx, gy) < 0  # (corner, T)
        any_neg = neg.any(dim=0)
        all_neg = neg.all(dim=0)
        fully_out = fully_out | all_neg
        crossing = crossing | (any_neg & ~all_neg)
    return crossing & ~fully_out, ~(crossing | fully_out)


def clip_overflow_count(ccols, tri_node, matrices, width: int, height: int,
                        clip_cap="auto"):
    """Crossing triangles the capped clipper drops this frame:
    ``max(n_crossing - cap, 0)`` as an int32 device scalar (the
    reference's ``clip_overflow_count`` in column mode).  It reruns the
    transform and the plane classification only; ``geometry_pipeline_cols``
    holds the same count as its cumsum's last entry."""
    t = ccols.shape[1]
    cap = clip_cap_for(t) if clip_cap == "auto" else min(clip_cap, t)
    needs, _ = _classify(_clip_positions(ccols, tri_node, matrices), width,
                         height)
    return torch.clamp_min(needs.sum(dtype=I32) - cap, 0)


def clip_triangles_cols(sub, width: int, height: int):
    """Sutherland-Hodgman against near + 4 guard planes, vectorised.

    ``sub``: (3, ATTR_FLOATS, cap) corner columns.  Returns
    (fan (3, ATTR_FLOATS, FAN_SLOTS*cap), fan_valid (FAN_SLOTS*cap,) bool)
    in the reference's slot-major order (fan slot j of every input first).
    """
    V = CLIP_MAX_VERTS  # = FAN_SLOTS + 2
    A = sub.shape[1]
    cap = sub.shape[2]
    dev = sub.device
    gx, gy = _guard_scales(width, height)

    # Polygon state: ch[k, v, i] = channel k of polygon vertex v of input i.
    ch = torch.zeros((A, V, cap), dtype=F32, device=dev)
    ch[:, 0:3] = sub.permute(1, 0, 2)
    counts = torch.full((cap,), 3, dtype=I32, device=dev)
    slot = torch.arange(V, device=dev)[:, None]

    for plane in range(5):
        d = _plane_distance(ch[0], ch[1], ch[2], ch[3], plane, gx, gy)
        in_poly = slot < counts[None, :]
        # Cyclic successor: vertex v+1, or vertex 0 after the last valid one.
        nxt = torch.where(counts[None, :] <= slot + 1, 0, (slot + 1) % V)
        d_nxt = torch.gather(d, 0, nxt)
        keep = (d >= 0) & in_poly
        cross = ((d >= 0) != (d_nxt >= 0)) & in_poly
        denom = d - d_nxt
        safe = torch.where(denom == 0, 1.0, denom)
        t = d / safe
        v_nxt = torch.gather(ch, 1, nxt.expand(A, V, cap))
        v_is = ch + t * (v_nxt - ch)

        # Each slot emits [vertex if kept][intersection if crossing];
        # prefix sums give disjoint targets, non-emitters hit trash lane V.
        emit0 = keep.to(I32)
        emit1 = cross.to(I32)
        total = emit0 + emit1
        ends = torch.cumsum(total, dim=0, dtype=I32)
        starts = ends - total
        tgt0 = torch.where(keep, starts, V).long().expand(A, V, cap)
        tgt1 = torch.where(cross, starts + emit0, V).long().expand(A, V, cap)
        out = torch.zeros((A, V + 1, cap), dtype=F32, device=dev)
        out.scatter_(1, tgt0, ch)
        out.scatter_(1, tgt1, v_is)
        ch = out[:, :V]
        counts = ends[-1]

    # Fan: triangle j = (v0, v_{j+1}, v_{j+2}), valid while j+2 < count.
    # Vertices j+1 and j+2 of fan slot j are polygon slots 1..6 and 2..7.
    fan = torch.stack([
        ch[:, 0:1].expand(A, FAN_SLOTS, cap),
        ch[:, 1:FAN_SLOTS + 1],
        ch[:, 2:FAN_SLOTS + 2],
    ]).reshape(3, A, FAN_SLOTS * cap)
    fan_j = torch.arange(FAN_SLOTS, dtype=I32, device=dev)[:, None]
    fan_valid = (counts[None, :] >= fan_j + 3).reshape(-1)
    return fan, fan_valid


def _setup_sentinel(device) -> torch.Tensor:
    """Dead-row i32 sentinel: empty bbox, bias = INT32_MAX (never covers)."""
    s = torch.zeros(NI32, dtype=I32, device=device)
    s[I_JMIN] = 1
    s[I_IMIN] = 1
    s[I_BIAS0] = s[I_BIAS1] = s[I_BIAS2] = _INT_MAX
    return s


def _setup_cols(cols, valid, width: int, height: int, consts=None):
    """Viewport transform, subpixel snap, facing/cull, edge and
    interpolation setup.  ``cols``: (3, ATTR_FLOATS, R) post-clip corner
    columns; ``valid``: (R,) bool; ``consts``: None or (MATERIAL_COLS, R)
    f32 per-row constants.  Returns (tri_i32 (R, NI32) i32, tri_f32
    (R, NF32) f32); dead rows hold the sentinel and zeros."""
    gpx = guard_px(width)
    gpy = guard_px(height)
    r = valid.shape[0]
    dev = cols.device

    w_ = cols[:, 3]
    w_ = torch.where(w_ > 0, w_, 1.0)
    inv_w = torch.reciprocal(w_)
    ndc_x = cols[:, 0] * inv_w
    ndc_y = cols[:, 1] * inv_w
    xs = (ndc_x + 1.0) * _f32(0.5 * width)
    ys = (1.0 - ndc_y) * _f32(0.5 * height)
    X = torch.clamp(torch.floor(xs * float(SUBPIXEL) + 0.5),
                    float(-gpx * SUBPIXEL), float((width + gpx) * SUBPIXEL))
    Y = torch.clamp(torch.floor(ys * float(SUBPIXEL) + 0.5),
                    float(-gpy * SUBPIXEL), float((height + gpy) * SUBPIXEL))
    X = X.to(I32)
    Y = Y.to(I32)

    x0, x1, x2 = X[0], X[1], X[2]
    y0, y1, y2 = Y[0], Y[1], Y[2]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    alive = valid & (area2 < 0)  # back faces and degenerates culled

    # Canonicalize: swap v1 <-> v2 so interiors have positive edge values.
    x1, x2 = x2, x1
    y1, y2 = y2, y1
    area2 = -area2

    dx0, dy0 = x2 - x1, y2 - y1
    dx1, dy1 = x0 - x2, y0 - y2
    dx2, dy2 = x1 - x0, y1 - y0

    def bias(dx, dy):
        top_left = (dy < 0) | ((dy == 0) & (dx > 0))
        return (~top_left).to(I32)

    half = SUBPIXEL // 2
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    jmin = torch.clamp_min((xmin + (SUBPIXEL - 1 - half)) >> SUBPIXEL_BITS, 0)
    jmax = torch.clamp_max((xmax - half) >> SUBPIXEL_BITS, width - 1)
    imin = torch.clamp_min((ymin + (SUBPIXEL - 1 - half)) >> SUBPIXEL_BITS, 0)
    imax = torch.clamp_max((ymax - half) >> SUBPIXEL_BITS, height - 1)

    tri_i32 = torch.stack([
        x0, y0, x1, y1, x2, y2,
        dx0, dy0, dx1, dy1, dx2, dy2,
        bias(dx0, dy0), bias(dx1, dy1), bias(dx2, dy2),
        jmin, jmax, imin, imax,
        alive.to(I32),
    ], dim=1).to(I32)

    # Interpolation constants in canonical vertex order (0, 2, 1).
    safe_area = torch.where(area2 > 0, area2, 1)
    inv_area = torch.reciprocal(safe_area.to(F32))
    cv = torch.stack([cols[0], cols[2], cols[1]])
    wc = torch.where(alive[None, :], cv[:, 3], 1.0)
    rw = torch.reciprocal(wc)  # (vertex, R)
    za = (cv[:, 2] * rw) * inv_area
    # color rgb, uv, normal xyz: channels 4-6, 8-9, 10-12, each times 1/w.
    numer = torch.cat([cv[:, 4:7], cv[:, 8:13]], dim=1) * rw[:, None]
    f_rows = [za, rw] + [numer[:, k] for k in range(numer.shape[1])]
    if consts is None:
        consts = torch.zeros((MATERIAL_COLS, r), dtype=F32, device=dev)
    tri_f32 = torch.cat(f_rows + [consts, torch.zeros(
        (NF32 - 30 - MATERIAL_COLS, r), dtype=F32, device=dev)], dim=0).T

    mask = alive[:, None]
    tri_i32 = torch.where(mask, tri_i32, _setup_sentinel(dev))
    tri_f32 = torch.where(mask, tri_f32, 0.0).contiguous()
    return tri_i32.contiguous(), tri_f32


# ---------------------------------------------------------------------------
# Compaction + block metadata (binning level 0 and 1)
# ---------------------------------------------------------------------------


def compact_triangles(tri_i32, tri_f32):
    """Stable-partition live rows to the front (live order preserved, so
    the depth-tie submission order is unchanged)."""
    dead = (tri_i32[:, I_VALID] == 0).to(I32)
    order = torch.argsort(dead, stable=True)
    return tri_i32[order], tri_f32[order]


def block_bounds(tri_i32, block: int = RASTER_BLOCK):
    """Per-block union bbox: (num_blocks, 8) i32
    [jmin, jmax, imin, imax, any_valid, 0, 0, 0]; all-dead blocks get an
    empty bbox (jmin > jmax)."""
    t = tri_i32.shape[0]
    if t % block:
        raise ValueError(f"{t} rows: pad to a multiple of {block}")
    nb = t // block
    valid = tri_i32[:, I_VALID].reshape(nb, block) > 0

    def col(c):
        return tri_i32[:, c].reshape(nb, block)

    jmin = torch.where(valid, col(I_JMIN), _INT_MAX).amin(dim=1)
    jmax = torch.where(valid, col(I_JMAX), -_INT_MAX).amax(dim=1)
    imin = torch.where(valid, col(I_IMIN), _INT_MAX).amin(dim=1)
    imax = torch.where(valid, col(I_IMAX), -_INT_MAX).amax(dim=1)
    any_valid = valid.any(dim=1).to(I32)
    zero = torch.zeros_like(jmin)
    return torch.stack(
        [jmin, jmax, imin, imax, any_valid, zero, zero, zero], dim=1
    ).to(I32)


def super_bounds(blocks, super_block: int = SUPER_BLOCK):
    """Level-1 union bboxes over groups of ``super_block`` blocks.  Pads the
    block table with empty blocks to a multiple; returns
    (padded_blocks, supers), both (n, 8) i32."""
    nb = blocks.shape[0]
    pad = (-nb) % super_block
    if pad:
        empty = torch.zeros((pad, 8), dtype=I32, device=blocks.device)
        empty[:, 0] = 1  # jmin > jmax: empty bbox
        blocks = torch.cat([blocks, empty], dim=0)
    ns = blocks.shape[0] // super_block
    grp = blocks.reshape(ns, super_block, 8)
    alive = grp[:, :, 4] > 0
    jmin = torch.where(alive, grp[:, :, 0], _INT_MAX).amin(dim=1)
    jmax = torch.where(alive, grp[:, :, 1], -_INT_MAX).amax(dim=1)
    imin = torch.where(alive, grp[:, :, 2], _INT_MAX).amin(dim=1)
    imax = torch.where(alive, grp[:, :, 3], -_INT_MAX).amax(dim=1)
    any_valid = alive.any(dim=1).to(I32)
    zero = torch.zeros_like(jmin)
    supers = torch.stack(
        [jmin, jmax, imin, imax, any_valid, zero, zero, zero], dim=1
    ).to(I32)
    return blocks, supers


# ---------------------------------------------------------------------------
# Meshlet (cluster) visibility
# ---------------------------------------------------------------------------

# Clip-space half-space planes p with "visible => v_clip . p >= 0" in the
# row-vector convention with D3D [0, 1] depth: left, right, bottom, top,
# near, far (the reference's ``_FRUSTUM_PLANES``).
_FRUSTUM_PLANES = (
    (1.0, 0.0, 0.0, 1.0),
    (-1.0, 0.0, 0.0, 1.0),
    (0.0, 1.0, 0.0, 1.0),
    (0.0, -1.0, 0.0, 1.0),
    (0.0, 0.0, 1.0, 0.0),
    (0.0, 0.0, -1.0, 1.0),
)


def _sum3(a, b):
    """Row-wise dot of the last dimension's three channels, summed as
    ((a0 b0 + a1 b1) + a2 b2): NumPy's reduction and einsum order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def meshlet_keep_mask(bounds, mdraw, enabled, matrices, cam_local,
                      backface_margin: float = 0.1):
    """(M,) bool: the meshlets that may be visible this frame (the
    reference's ``meshlet_keep_mask``, op for op).

    ``bounds`` (M, 8) f32 draw-local [center, radius, cone axis, cone
    cutoff] (``FlatScene.build_meshlet_table``), ``mdraw`` (M,) i32 each
    meshlet's draw, ``enabled`` (M,) bool (a disabled meshlet is kept),
    ``matrices`` (D, 4, 4) object_to_clip (row-vector), ``cam_local``
    (D, 4) the camera position in each draw's local space.  A meshlet is
    culled when its bounding sphere lies outside a frustum plane pulled to
    local space (lp = M @ p), or when its normal cone faces away from the
    camera by more than ``backface_margin``; both tests are conservative
    for float geometry.  The reference's two einsums are written as
    explicit products: the 4-term plane transform summed as
    (p0 + p1) + (p2 + p3), the 3-term dots in order, as NumPy sums them,
    so every keep bit is the reference's."""
    planes = torch.tensor(_FRUSTUM_PLANES, dtype=F32, device=matrices.device)
    # lp[d, k, i] = sum_j matrices[d, i, j] * planes[k, j].
    prod = [matrices[:, None, :, j] * planes[None, :, None, j]
            for j in range(4)]
    lp = (prod[0] + prod[1]) + (prod[2] + prod[3])  # (D, 6, 4)
    lpm = lp[mdraw.long()]  # (M, 6, 4)
    c = bounds[:, 0:3]
    r = bounds[:, 3]
    dist_to_plane = _sum3(c[:, None, :], lpm[:, :, 0:3]) + lpm[:, :, 3]
    plane_norm = torch.sqrt(_sum3(lpm[:, :, 0:3], lpm[:, :, 0:3]))
    outside = (dist_to_plane < -r[:, None] * plane_norm).any(dim=1)

    axis = bounds[:, 4:7]
    w = bounds[:, 7]
    cam = cam_local[mdraw.long(), 0:3]
    d = cam - c
    dist = torch.sqrt(_sum3(d, d))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - w * w, 0.0))
    backface = (w >= 0.0) & (
        (_sum3(d, axis) * w + dist * sin_t) + r
        < _f32(-backface_margin) * dist
    )
    return ~enabled | ~(outside | backface)
