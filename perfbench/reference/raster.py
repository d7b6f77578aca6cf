"""The plain rasterizer of docs/RASTER_SPEC.md §2-§4 over set-up rows, in
torch, in blocks of (row, pixel) pairs so that it fits beside nothing.

It evaluates what the frozen ``raster_ref/raster_cpu.py`` (commit
1b17ee2) evaluates, pixel for pixel: every pixel of every live row's
bounding box, the three int32 edge functions at the pixel centre against
the fill-rule biases, z = (e0 za0 + e1 za1) + e2 za2, the test
0 <= z < z_buffer (cleared to 1) in submission order.  Instead of a
scalar loop it keeps, per pixel, the least (z, row) pair, which is the
row the sequential strict-less test leaves (ties keep the earlier row),
then evaluates the winner's interpolants at its pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.geometry import F32, I32, SUBPIXEL, Rows

PAIRS_PER_BLOCK = 1 << 25
CLEAR_KEY = (int(np.float32(1.0).view(np.int32)) << 32) | (2**31 - 1)


def _blocks(counts: torch.Tensor):
    """Row ranges [a, b) whose pair counts sum to about PAIRS_PER_BLOCK."""
    cum = np.cumsum(counts.cpu().numpy())
    total = int(cum[-1]) if len(cum) else 0
    edges = [0]
    target = PAIRS_PER_BLOCK
    while target < total:
        b = int(np.searchsorted(cum, target, side="right"))
        b = max(b, edges[-1] + 1)
        edges.append(b)
        target = int(cum[b - 1]) + PAIRS_PER_BLOCK
    edges.append(len(cum))
    return [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _edges(rows: Rows, r, py, px):
    """The three edge functions of rows ``r`` at subpixel points."""
    x, y, dx, dy = rows.x, rows.y, rows.dx, rows.dy
    k1 = (1, 2, 0)
    return [dx[k, r] * (py - y[k1[k], r]) - dy[k, r] * (px - x[k1[k], r])
            for k in range(3)]


def _interp(ef, coef, r, prec):
    """(ef0 c0 + ef1 c1) + ef2 c2 of rows ``r``'s coefficients (3, R)."""
    return ((prec.mul(ef[0], coef[0, r]) + prec.mul(ef[1], coef[1, r]))
            + prec.mul(ef[2], coef[2, r]))


def _pairs(rows: Rows, live: torch.Tensor, a: int, b: int):
    """Every (row, pixel) of the live rows [a, b)'s bounding boxes."""
    dev = live.device
    r = live[a:b]
    jmin, jmax, imin, imax = rows.bbox[:, r]
    bw = (jmax - jmin + 1).to(torch.int64)
    bh = (imax - imin + 1).to(torch.int64)
    counts = bw * bh
    rr = torch.repeat_interleave(torch.arange(r.shape[0], device=dev), counts)
    start = torch.cumsum(counts, 0) - counts
    local = torch.arange(int(counts.sum()), device=dev) - start[rr]
    j = jmin[rr] + (local % bw[rr]).to(I32)
    i = imin[rr] + (local // bw[rr]).to(I32)
    return r[rr], i, j


def winners(rows: Rows, width: int, height: int, prec):
    """Per pixel, the winning row (or -1) and its z (or the clear 1.0):
    the least (z, row) over the covered pairs with 0 <= z < 1.  Returns
    (row (H, W) i64, z (H, W) f32)."""
    dev = rows.alive.device
    jmin, jmax, imin, imax = rows.bbox
    live = torch.nonzero(rows.alive & (jmin <= jmax) & (imin <= imax)).flatten()
    counts = ((jmax[live] - jmin[live] + 1).to(torch.int64)
              * (imax[live] - imin[live] + 1).to(torch.int64))
    key = torch.full((height * width,), CLEAR_KEY, dtype=torch.int64,
                     device=dev)
    half = SUBPIXEL // 2
    for a, b in _blocks(counts):
        r, i, j = _pairs(rows, live, a, b)
        py = i * SUBPIXEL + half
        px = j * SUBPIXEL + half
        e = _edges(rows, r, py, px)
        cov = ((e[0] >= rows.bias[0, r]) & (e[1] >= rows.bias[1, r])
               & (e[2] >= rows.bias[2, r]))
        ef = [x.to(F32) for x in e]
        z = _interp(ef, rows.za, r, prec)
        ok = cov & (z >= 0.0) & (z < 1.0)
        zbits = (z[ok] + 0.0).view(I32).to(torch.int64)  # -0 -> +0
        k = (zbits << 32) | r[ok]
        key.scatter_reduce_(0, (i[ok].to(torch.int64) * width + j[ok]), k,
                            "amin")
        del r, i, j, e, ef, z, ok, cov
    won = key != CLEAR_KEY
    row = torch.where(won, key & 0xFFFFFFFF, -1)
    z = (key >> 32).to(I32).view(F32)
    return row.reshape(height, width), z.reshape(height, width)


def latch(rows: Rows, row: torch.Tensor, prec):
    """The winners' perspective numerators at their pixels: (den (H, W),
    numerators (C, H, W)), zero where no row won."""
    h, w = row.shape
    dev = row.device
    won = row >= 0
    r = row[won]
    i, j = torch.nonzero(won, as_tuple=True)
    half = SUBPIXEL // 2
    e = _edges(rows, r, i.to(I32) * SUBPIXEL + half, j.to(I32) * SUBPIXEL + half)
    ef = [x.to(F32) for x in e]
    den = torch.zeros((h, w), dtype=F32, device=dev)
    den[won] = _interp(ef, rows.rw, r, prec)
    num = torch.zeros((rows.attr.shape[0], h, w), dtype=F32, device=dev)
    for c in range(rows.attr.shape[0]):
        num[c][won] = _interp(ef, rows.attr[c], r, prec)
    return den, num


def resolve(den: torch.Tensor, num: torch.Tensor):
    """Interpolated attributes a = num / den where den > 0, else 0 (the
    single divide of RASTER_SPEC §3)."""
    covered = den > 0
    safe = torch.where(covered, den, 1.0)
    return torch.where(covered, num / safe, 0.0)


def pack_u8(c: torch.Tensor) -> torch.Tensor:
    """RASTER_SPEC §4: u8 = floor(clamp(c, 0, 1) * 255 + 0.5)."""
    return torch.floor(torch.clamp(c, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def rgba8(den, num) -> torch.Tensor:
    """The packed colour of the flat resolve: rgb from the first three
    numerators, the clear colour where uncovered, alpha 255."""
    attr = resolve(den, num[:3])
    rgb = pack_u8(attr).permute(1, 2, 0)
    alpha = torch.full_like(rgb[..., :1], 255)
    return torch.cat([rgb, alpha], dim=-1)


def covered_pairs(rows: Rows, width: int, height: int) -> int:
    """The (row, pixel) pairs that pass coverage: the frame's summed
    clipped screen area in pixel samples (the raster roofline's count)."""
    jmin, jmax, imin, imax = rows.bbox
    live = torch.nonzero(rows.alive & (jmin <= jmax) & (imin <= imax)).flatten()
    counts = ((jmax[live] - jmin[live] + 1).to(torch.int64)
              * (imax[live] - imin[live] + 1).to(torch.int64))
    total = 0
    half = SUBPIXEL // 2
    for a, b in _blocks(counts):
        r, i, j = _pairs(rows, live, a, b)
        e = _edges(rows, r, i * SUBPIXEL + half, j * SUBPIXEL + half)
        total += int(((e[0] >= rows.bias[0, r]) & (e[1] >= rows.bias[1, r])
                      & (e[2] >= rows.bias[2, r])).sum())
    return total
