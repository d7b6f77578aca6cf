"""The plain geometry stage of docs/RASTER_SPEC.md §1-§3, in torch:
object -> clip transform, the capped near/guard-band clip, perspective
divide, viewport, subpixel snap, facing cull and triangle setup.

Written from the spec and from the JAX package's documented layout (its
``geometry_pipeline_cols`` with ``clip_cap="auto"``), imported from
neither: rows are the T input triangles in submission order (those
inside every plane), then the fan triangles of the first
``clip_cap(T)`` plane-crossing triangles, slot-major (fan slot 0 of every
clipped triangle first); crossing triangles past the cap are dropped.
The row index is the depth-tie order.

Every f32 product goes through ``prec.mul`` so that the control can run
the same stage in a lower precision (``perfbench/reference/precision.py``).
The association of every sum is the spec's, and eager torch rounds after
every op.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SUBPIXEL_BITS = 3
SUBPIXEL = 1 << SUBPIXEL_BITS
GUARD_PX = 960
MAX_SPAN_PX = 4096
CLIP_MAX_VERTS = 8
FAN_SLOTS = CLIP_MAX_VERTS - 2
CLIP_CAP_MIN = 1024
CHANNELS = 16  # clip xyzw, color rgba, uv, normal, tangent xyz

F32 = torch.float32
I32 = torch.int32


def f32(x: float) -> float:
    """``x`` rounded to float32."""
    return float(np.float32(x))


def guard_px(extent: int) -> int:
    return min(GUARD_PX, (MAX_SPAN_PX - extent) // 2)


def clip_cap(num_tris: int) -> int:
    return min(num_tris, max(CLIP_CAP_MIN, num_tris // 64))


@dataclass
class Rows:
    """Set-up rows of one pass, on one device.

    Integer columns (canonical winding: v1 and v2 swapped, area2 > 0):
    ``x``, ``y`` (3, R) snapped corners; ``dx``, ``dy`` (3, R) edge
    deltas; ``bias`` (3, R) fill-rule biases; ``bbox`` (4, R) jmin, jmax,
    imin, imax; ``alive`` (R,).  Float columns: ``za`` (3, R) z per edge
    function; ``rw`` (3, R) 1/w; ``attr`` (C, 3, R) the corners'
    attributes times 1/w (color rgb, uv, normal xyz)."""

    x: torch.Tensor
    y: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    bias: torch.Tensor
    bbox: torch.Tensor
    alive: torch.Tensor
    za: torch.Tensor
    rw: torch.Tensor
    attr: torch.Tensor


def corners(draws, device) -> torch.Tensor:
    """(3, 16, T) object-space corner columns of every draw's triangles in
    draw order: position xyz1, then the vertex colour rgba, uv, normal and
    tangent xyz."""
    out = []
    for d in draws:
        v = np.zeros((len(d.vertices), CHANNELS), np.float32)
        v[:, 0:3] = d.vertices[:, 0:3]
        v[:, 3] = 1.0
        v[:, 4:8] = d.vertices[:, 5:9]
        v[:, 8:10] = d.vertices[:, 3:5]
        v[:, 10:13] = d.vertices[:, 9:12]
        v[:, 13:16] = d.vertices[:, 12:15]
        tri = torch.from_numpy(v).to(device)[
            torch.from_numpy(d.indices.astype(np.int64)).to(device)]
        out.append(tri.reshape(-1, 3, CHANNELS).permute(1, 2, 0))
    return torch.cat(out, dim=2).contiguous()


def transform(obj: torch.Tensor, matrix: torch.Tensor, prec,
              normal_matrix: torch.Tensor | None = None) -> torch.Tensor:
    """Clip-space corners (3, 16, T): position @ matrix as
    ((x m0 + y m1) + (z m2 + w m3)); with ``normal_matrix`` the normals
    as ((n0 nm0 + n1 nm1) + n2 nm2).  ``matrix`` (4, 4, 1 or T) and
    ``normal_matrix`` (3, 3, 1 or T): one matrix, or one a triangle."""
    m = matrix  # (4 rows, 4 columns, 1 or T)
    p = obj[:, 0:4]  # (corner, i, T)
    mul = prec.mul
    clip = ((mul(p[:, 0:1], m[0]) + mul(p[:, 1:2], m[1]))
            + (mul(p[:, 2:3], m[2]) + mul(p[:, 3:4], m[3])))
    attr = obj[:, 4:]
    if normal_matrix is not None:
        nm = normal_matrix
        n = attr[:, 6:9]
        normal = ((mul(n[:, 0:1], nm[0]) + mul(n[:, 1:2], nm[1]))
                  + mul(n[:, 2:3], nm[2]))
        attr = torch.cat([attr[:, :6], normal, attr[:, 9:]], dim=1)
    return torch.cat([clip, attr], dim=1)


def _plane(x, y, z, w, plane: int, gx: float, gy: float, prec):
    """Inside distance to plane ``plane``: near, then the four guard
    planes x = +-gx w, y = +-gy w."""
    if plane == 0:
        return z
    if plane == 1:
        return prec.mul(w, gx) - x
    if plane == 2:
        return prec.mul(w, gx) + x
    if plane == 3:
        return prec.mul(w, gy) - y
    return prec.mul(w, gy) + y


def _guards(width: int, height: int):
    return (f32(1.0 + 2.0 * guard_px(width) / float(width)),
            f32(1.0 + 2.0 * guard_px(height) / float(height)))


def clip_polygons(tris: torch.Tensor, width: int, height: int, prec):
    """Sutherland-Hodgman of (3, 16, n) triangles against the near plane
    and the four guard planes.  Returns the fans (3, 16, 6n), slot-major,
    and their valid flags (6n,)."""
    gx, gy = _guards(width, height)
    n = tris.shape[2]
    dev = tris.device
    poly = torch.zeros((CLIP_MAX_VERTS, CHANNELS, n), dtype=F32, device=dev)
    poly[:3] = tris
    count = torch.full((n,), 3, dtype=torch.int64, device=dev)
    lanes = torch.arange(n, device=dev)
    for plane in range(5):
        d = _plane(poly[:, 0], poly[:, 1], poly[:, 2], poly[:, 3], plane,
                   gx, gy, prec)  # (vertex, n)
        out = torch.zeros((CLIP_MAX_VERTS + 1, CHANNELS, n), dtype=F32,
                          device=dev)
        filled = torch.zeros(n, dtype=torch.int64, device=dev)
        for v in range(CLIP_MAX_VERTS):
            live = v < count
            nxt = torch.where(v + 1 < count, v + 1, 0)
            cur_v = poly[v]
            nxt_v = poly[nxt, :, lanes].T
            d_cur = d[v]
            d_nxt = d[nxt, lanes]
            keep = live & (d_cur >= 0)
            cross = live & ((d_cur >= 0) != (d_nxt >= 0))
            slot = torch.where(keep, filled, CLIP_MAX_VERTS)
            out[slot, :, lanes] = cur_v.T
            filled = filled + keep.to(torch.int64)
            denom = d_cur - d_nxt
            t = d_cur / torch.where(denom == 0, 1.0, denom)
            cut = cur_v + prec.mul(t, nxt_v - cur_v)
            slot = torch.where(cross, filled, CLIP_MAX_VERTS)
            out[slot, :, lanes] = cut.T
            filled = filled + cross.to(torch.int64)
        poly = out[:CLIP_MAX_VERTS]
        count = filled
    fans = []
    valid = []
    for j in range(FAN_SLOTS):
        fans.append(torch.stack([poly[0], poly[j + 1], poly[j + 2]]))
        valid.append(count >= j + 3)
    return torch.cat(fans, dim=2), torch.cat(valid)


def clip_capped(cols: torch.Tensor, num_rows_in: int, width: int,
                height: int, prec):
    """The capped layout over (3, 16, T) clip-space corners, of which the
    first ``num_rows_in`` are the (padded) input triangles: returns
    (corners (3, 16, R), valid (R,)).  A triangle with every corner inside
    every plane keeps its row; one wholly outside some plane is dropped;
    the first ``clip_cap(T)`` of the others are clipped into fan rows."""
    gx, gy = _guards(width, height)
    x, y, z, w = cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3]
    t = cols.shape[2]
    crossing = torch.zeros(t, dtype=torch.bool, device=cols.device)
    outside = torch.zeros(t, dtype=torch.bool, device=cols.device)
    for plane in range(5):
        neg = _plane(x, y, z, w, plane, gx, gy, prec) < 0  # (corner, T)
        outside |= neg.all(dim=0)
        crossing |= neg.any(dim=0) & ~neg.all(dim=0)
    inside = ~(crossing | outside)
    needs = torch.nonzero(crossing & ~outside).flatten()
    cap = clip_cap(num_rows_in)
    picked = needs[:cap]
    fans, fan_valid = clip_polygons(cols[:, :, picked], width, height, prec)
    # Fan rows of the unused cap slots are dead rows.
    fan_rows = torch.zeros((3, CHANNELS, FAN_SLOTS, cap), dtype=F32,
                           device=cols.device)
    fan_live = torch.zeros((FAN_SLOTS, cap), dtype=torch.bool,
                           device=cols.device)
    k = picked.shape[0]
    fan_rows[:, :, :, :k] = fans.reshape(3, CHANNELS, FAN_SLOTS, k)
    fan_live[:, :k] = fan_valid.reshape(FAN_SLOTS, k)
    return (torch.cat([cols, fan_rows.reshape(3, CHANNELS, -1)], dim=2),
            torch.cat([inside, fan_live.reshape(-1)]))


def setup(cols: torch.Tensor, valid: torch.Tensor, width: int, height: int,
          prec) -> Rows:
    """Perspective divide, viewport, snap, facing cull and set-up of
    (3, 16, R) clip-space corners (RASTER_SPEC §1.4-§3)."""
    mul = prec.mul
    gpx, gpy = guard_px(width), guard_px(height)
    w = cols[:, 3]
    w = torch.where(w > 0, w, 1.0)
    inv_w = torch.reciprocal(w)
    ndc_x = mul(cols[:, 0], inv_w)
    ndc_y = mul(cols[:, 1], inv_w)
    xs = mul(ndc_x + 1.0, f32(0.5 * width))
    ys = mul(1.0 - ndc_y, f32(0.5 * height))
    X = torch.clamp(torch.floor(xs * float(SUBPIXEL) + 0.5),
                    float(-gpx * SUBPIXEL), float((width + gpx) * SUBPIXEL))
    Y = torch.clamp(torch.floor(ys * float(SUBPIXEL) + 0.5),
                    float(-gpy * SUBPIXEL), float((height + gpy) * SUBPIXEL))
    X = X.to(I32)
    Y = Y.to(I32)
    area2 = (X[1] - X[0]) * (Y[2] - Y[0]) - (X[2] - X[0]) * (Y[1] - Y[0])
    alive = valid & (area2 < 0)  # front faces are clockwise on screen
    # Canonical winding: swap corners 1 and 2.
    order = [0, 2, 1]
    X = X[order]
    Y = Y[order]
    area2 = -area2
    k1 = [1, 2, 0]
    k2 = [2, 0, 1]
    dx = X[k2] - X[k1]
    dy = Y[k2] - Y[k1]
    top_left = (dy < 0) | ((dy == 0) & (dx > 0))
    bias = (~top_left).to(I32)
    half = SUBPIXEL // 2
    jmin = torch.clamp_min((X.amin(0) + (SUBPIXEL - 1 - half)) >> SUBPIXEL_BITS, 0)
    jmax = torch.clamp_max((X.amax(0) - half) >> SUBPIXEL_BITS, width - 1)
    imin = torch.clamp_min((Y.amin(0) + (SUBPIXEL - 1 - half)) >> SUBPIXEL_BITS, 0)
    imax = torch.clamp_max((Y.amax(0) - half) >> SUBPIXEL_BITS, height - 1)
    bbox = torch.stack([jmin, jmax, imin, imax])
    inv_area = torch.reciprocal(torch.where(area2 > 0, area2, 1).to(F32))
    cv = cols[order]
    rw = torch.reciprocal(torch.where(alive[None, :], cv[:, 3], 1.0))
    za = mul(mul(cv[:, 2], rw), inv_area)
    attr = torch.cat([cv[:, 4:7], cv[:, 8:13]], dim=1)  # rgb, uv, normal
    attr = mul(attr, rw[:, None]).permute(1, 0, 2)  # (C, 3, R)
    return Rows(X, Y, dx, dy, bias, bbox, alive, za, rw, attr)


def geometry(obj: torch.Tensor, num_rows_in: int, matrix: torch.Tensor,
             width: int, height: int, prec,
             normal_matrix: torch.Tensor | None = None) -> Rows:
    """The whole stage: (3, 16, T) object-space corners of the unpadded
    input triangles, ``num_rows_in`` rows with the padding rows, and their
    matrices as ``transform`` takes them -> set-up rows."""
    cols = transform(obj, matrix, prec, normal_matrix)
    cols, valid = clip_capped(cols, num_rows_in, width, height, prec)
    return setup(cols, valid, width, height, prec)
