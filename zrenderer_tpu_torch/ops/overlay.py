"""The 2D overlay pass, K8 and K8b (counterpart of
``zrenderer_tpu/ops/overlay_raster.py``).

Textured 2D triangles (the stats line, the imgui windows) are blended onto
a finished frame in submission order under per-triangle scissor rects:
``src*a + dst*(1-a)`` with the source ``vertex colour * atlas sample``.
The pass has two steps, as in the reference:

1. **The layered raster, K8** (``rasterize_overlay``): each covered pixel
   appends (u, v, RGBA8 colour) to a K-deep per-pixel stack, oldest first;
   the count is clamped to K and the excess reported as overflow (draws
   beyond K are dropped newest first).
2. **The composite, K8b** (``composite_layers``): for each live layer in
   order, the bilinear WRAP sample of the packed UI atlas at (u, v),
   modulated by the layer's colour and blended onto the frame; the result
   is quantized with alpha 255.

``overlay_pass`` runs both.  CUDA tensors go to the kernels
(``csrc/overlay.cu``, one launch each), CPU tensors to the plain torch
versions beside them (``rasterize_overlay_plain``, the reference's XLA form
``rasterize_overlay_xla``, and ``composite_layers_plain``, its
``composite_layers``).  There is no fallback between the two.

The triangle setup (``setup_overlay_triangles``) runs on the host in
NumPy, as the reference's draw lists and its oracle run it: positions snap
to 1/8 subpixels, coverage is exact int32 edge functions with the top-left
fill rule, negative-area triangles are rewound (no culling), and the pixel
rect is the triangle's bbox ∩ scissor ∩ viewport.

Layers are three (K, H, W) stacks: u f32, v f32 and the colour as u32 bits
in int32 (``r | g<<8 | b<<16 | a<<24``); layer k of a pixel past its count
is 0.  The atlas is (h, w) int32 holding the same u32 bits.

Numerics: every expression keeps the reference's association and eager
torch rounds after every op, so the plain versions are the XLA form's bits
on the CPU; the kernels pin the same order with ``__fmul_rn``/``__fadd_rn``.
The frame's u8 -> f32 is a true division by a tensor 255 (CUDA turns a
division by a Python scalar into a multiply by its reciprocal).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import geometry as g
from zrenderer_tpu_torch.ops.raster import _launch, _on_cpu, _ptr

F32 = torch.float32
I32 = torch.int32
U8 = torch.uint8

# Default per-pixel layer depth: overlapping translucent draws on a pixel.
DEFAULT_K = 8
# The depths csrc/overlay.cu instantiates; any other K raises on the card.
KERNEL_K = (2, 8)

# i32 setup columns: the main raster's layout (geometry.I_*).
NI32_2D = g.NI32  # 20
# f32 setup columns: per-vertex attribute numerators (attr * inv_area).
F2_U0, F2_U1, F2_U2 = range(3)
F2_V0, F2_V1, F2_V2 = range(3, 6)
F2_R0, F2_R1, F2_R2 = range(6, 9)
F2_G0, F2_G1, F2_G2 = range(9, 12)
F2_B0, F2_B1, F2_B2 = range(12, 15)
F2_A0, F2_A1, F2_A2 = range(15, 18)
NF32_2D = 24  # padded

_INV255 = float(np.float32(1.0 / 255.0))


# ---------------------------------------------------------------------------
# Host triangle setup
# ---------------------------------------------------------------------------


def setup_overlay_triangles(verts, scissors, width: int, height: int):
    """2D triangle setup on the host.  verts: (T, 3, 8) f32 (x, y in screen
    pixels, u, v in texture space, r, g, b, a straight alpha); scissors:
    (T, 4) i32 [x0, y0, x1, y1) pixel rects.  Returns (tri_i32 (T, 20)
    int32, tri_f32 (T, 24) float32) NumPy arrays.

    Dead triangles (zero area, empty rect) get valid 0 and the empty rect
    jmin = imin = 1 > jmax = imax = 0."""
    f32 = np.float32
    i32 = np.int32
    t = verts.shape[0]

    xs = verts[..., 0]
    ys = verts[..., 1]
    lo = f32(-g.guard_px(width) * g.SUBPIXEL)
    hix = f32((width + g.guard_px(width)) * g.SUBPIXEL)
    hiy = f32((height + g.guard_px(height)) * g.SUBPIXEL)
    X = np.clip(np.floor(xs * f32(g.SUBPIXEL) + f32(0.5)), lo, hix).astype(i32)
    Y = np.clip(np.floor(ys * f32(g.SUBPIXEL) + f32(0.5)), lo, hiy).astype(i32)

    x0, x1, x2 = X[:, 0], X[:, 1], X[:, 2]
    y0, y1, y2 = Y[:, 0], Y[:, 1], Y[:, 2]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)

    # No culling: negative-area triangles swap v1 and v2, so every live
    # triangle has positive interior edge values.
    flip = area2 < 0
    x1, x2 = np.where(flip, x2, x1), np.where(flip, x1, x2)
    y1, y2 = np.where(flip, y2, y1), np.where(flip, y1, y2)
    attr = verts[..., 2:8]  # (T, 3, 6): u, v, r, g, b, a
    a1 = np.where(flip[:, None], attr[:, 2], attr[:, 1])
    a2 = np.where(flip[:, None], attr[:, 1], attr[:, 2])
    varr = np.stack([attr[:, 0], a1, a2], axis=1)
    area2 = np.where(flip, -area2, area2)
    alive = area2 > 0  # degenerate triangles culled

    dx0, dy0 = x2 - x1, y2 - y1
    dx1, dy1 = x0 - x2, y0 - y2
    dx2, dy2 = x1 - x0, y1 - y0

    def bias(dx, dy):
        top_left = (dy < 0) | ((dy == 0) & (dx > 0))
        return np.where(top_left, i32(0), i32(1))

    # Pixel rect = triangle bbox ∩ scissor ∩ viewport: with the edge tests
    # it is exactly the scissor test.
    half = g.SUBPIXEL // 2
    xmin = np.minimum(np.minimum(x0, x1), x2)
    xmax = np.maximum(np.maximum(x0, x1), x2)
    ymin = np.minimum(np.minimum(y0, y1), y2)
    ymax = np.maximum(np.maximum(y0, y1), y2)
    sc = scissors.astype(i32)
    jmin = np.maximum((xmin + (g.SUBPIXEL - 1 - half)) >> g.SUBPIXEL_BITS, 0)
    jmax = np.minimum((xmax - half) >> g.SUBPIXEL_BITS, width - 1)
    imin = np.maximum((ymin + (g.SUBPIXEL - 1 - half)) >> g.SUBPIXEL_BITS, 0)
    imax = np.minimum((ymax - half) >> g.SUBPIXEL_BITS, height - 1)
    jmin = np.maximum(jmin, sc[:, 0])
    jmax = np.minimum(jmax, sc[:, 2] - 1)
    imin = np.maximum(imin, sc[:, 1])
    imax = np.minimum(imax, sc[:, 3] - 1)
    alive = alive & (jmin <= jmax) & (imin <= imax)
    jmin = np.where(alive, jmin, 1).astype(i32)
    jmax = np.where(alive, jmax, 0).astype(i32)
    imin = np.where(alive, imin, 1).astype(i32)
    imax = np.where(alive, imax, 0).astype(i32)

    tri_i32 = np.stack(
        [
            x0, y0, x1, y1, x2, y2,
            dx0, dy0, dx1, dy1, dx2, dy2,
            bias(dx0, dy0), bias(dx1, dy1), bias(dx2, dy2),
            jmin, jmax, imin, imax,
            alive.astype(i32),
        ],
        axis=1,
    ).astype(i32)

    safe_area = np.where(alive, area2, 1)
    inv_area = (f32(1.0) / safe_area.astype(f32)).astype(f32)
    num = (varr * inv_area[:, None, None]).astype(f32)  # (T, 3, 6)
    tri_f32 = np.concatenate(
        [num[:, c, a:a + 1] for a in range(6) for c in range(3)]
        + [np.zeros((t, NF32_2D - 18), f32)],
        axis=1,
    ).astype(f32)
    return tri_i32, tri_f32


# ---------------------------------------------------------------------------
# K8's plain version
# ---------------------------------------------------------------------------


def _quantize_channel(c):
    """f32 [0, 1] -> int32 [0, 255]: floor(clip(c, 0, 1) * 255 + 0.5)."""
    return torch.floor(torch.clamp(c, 0.0, 1.0) * 255.0 + 0.5).to(I32)


def rasterize_overlay_plain(tri_i32, tri_f32, width: int, height: int,
                            K: int = DEFAULT_K):
    """The plain torch version of K8, the reference's XLA form: triangles
    in order over full-frame planes.  Each triangle's work is cut to its
    pixel rect (outside it nothing is inside), read from a host copy of
    the rows.  Returns (cnt clamped to K, overflow, (lu, lv, lc))."""
    dev = tri_i32.device
    half = g.SUBPIXEL // 2
    cnt = torch.zeros((height, width), dtype=I32, device=dev)
    lu = torch.zeros((K, height, width), dtype=F32, device=dev)
    lv = torch.zeros((K, height, width), dtype=F32, device=dev)
    lc = torch.zeros((K, height, width), dtype=I32, device=dev)
    rows_i = tri_i32.cpu().numpy()
    rows_f = tri_f32.cpu().numpy()
    for r, f in zip(rows_i, rows_f):
        if r[g.I_VALID] <= 0:
            continue
        j0, j1 = max(int(r[g.I_JMIN]), 0), min(int(r[g.I_JMAX]), width - 1)
        i0, i1 = max(int(r[g.I_IMIN]), 0), min(int(r[g.I_IMAX]), height - 1)
        if j0 > j1 or i0 > i1:
            continue
        ri = [int(x) for x in r]
        cf = [float(x) for x in f]  # exact: f32 values
        px = (torch.arange(j0, j1 + 1, dtype=I32, device=dev) * g.SUBPIXEL
              + half)[None, :]
        py = (torch.arange(i0, i1 + 1, dtype=I32, device=dev) * g.SUBPIXEL
              + half)[:, None]

        def edge(dx, dy, x, y):
            return ri[dx] * (py - ri[y]) - ri[dy] * (px - ri[x])

        e0 = edge(g.I_DX0, g.I_DY0, g.I_X1, g.I_Y1)
        e1 = edge(g.I_DX1, g.I_DY1, g.I_X2, g.I_Y2)
        e2 = edge(g.I_DX2, g.I_DY2, g.I_X0, g.I_Y0)
        inside = ((e0 >= ri[g.I_BIAS0]) & (e1 >= ri[g.I_BIAS1])
                  & (e2 >= ri[g.I_BIAS2]))
        ef0, ef1, ef2 = e0.to(F32), e1.to(F32), e2.to(F32)

        def interp(c0):
            return (ef0 * cf[c0] + ef1 * cf[c0 + 1]) + ef2 * cf[c0 + 2]

        u = interp(F2_U0)
        v = interp(F2_V0)
        col = (_quantize_channel(interp(F2_R0))
               | (_quantize_channel(interp(F2_G0)) << 8)
               | (_quantize_channel(interp(F2_B0)) << 16)
               | (_quantize_channel(interp(F2_A0)) << 24))
        box = (slice(i0, i1 + 1), slice(j0, j1 + 1))
        c = cnt[box]
        for k in range(K):
            m = inside & (c == k)
            lu[k][box] = torch.where(m, u, lu[k][box])
            lv[k][box] = torch.where(m, v, lv[k][box])
            lc[k][box] = torch.where(m, col, lc[k][box])
        cnt[box] = c + inside.to(I32)
    return (torch.clamp_max(cnt, K), torch.clamp_min(cnt - K, 0),
            (lu, lv, lc))


# ---------------------------------------------------------------------------
# K8 on the card (csrc/overlay.cu)
# ---------------------------------------------------------------------------


def _check(name, t, dtype, dev, ndim=None, cols=None):
    if t.device != dev or t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor on {dev} expected, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} expected, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: contiguous tensor expected")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: {ndim} dimensions expected, got "
                         f"{tuple(t.shape)}")
    if cols is not None and t.shape[-1] != cols:
        raise ValueError(f"{name}: {cols} columns expected, got "
                         f"{tuple(t.shape)}")


def overlay_raster_kernel(tri_i32, tri_f32, width: int, height: int,
                          K: int = DEFAULT_K):
    """Launch K8 (``csrc/overlay.cu``) on the current stream; returns
    (cnt, overflow, (lu, lv, lc)) as ``rasterize_overlay_plain`` does."""
    dev = tri_i32.device
    _check("tri_i32", tri_i32, I32, dev, 2, NI32_2D)
    _check("tri_f32", tri_f32, F32, dev, 2, NF32_2D)
    if tri_f32.shape[0] != tri_i32.shape[0]:
        raise ValueError("tri_i32 and tri_f32 differ in rows")
    if K not in KERNEL_K:
        raise ValueError(f"K={K}: the kernel is built for K in {KERNEL_K}")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad frame size {width}x{height}")
    cnt = torch.empty((height, width), dtype=I32, device=dev)
    over = torch.empty((height, width), dtype=I32, device=dev)
    lu = torch.empty((K, height, width), dtype=F32, device=dev)
    lv = torch.empty((K, height, width), dtype=F32, device=dev)
    lc = torch.empty((K, height, width), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(_build.load_library().zr_overlay_raster, _ptr(tri_i32),
                _ptr(tri_f32), tri_i32.shape[0], K, _ptr(cnt), _ptr(over),
                _ptr(lu), _ptr(lv), _ptr(lc), height, width,
                ctypes.c_void_p(stream))
    overlay_raster_kernel.launches += 1
    return cnt, over, (lu, lv, lc)


def rasterize_overlay(tri_i32, tri_f32, width: int, height: int,
                      K: int = DEFAULT_K):
    """K8 for CUDA tensors, its plain version for CPU tensors: (cnt (H, W)
    int32 clamped to K, overflow (H, W) int32, layers (lu, lv, lc), each
    (K, H, W), oldest first)."""
    if _on_cpu(tri_i32):
        return rasterize_overlay_plain(tri_i32, tri_f32, width, height, K)
    return overlay_raster_kernel(tri_i32, tri_f32, width, height, K)


# ---------------------------------------------------------------------------
# The composite: K8b's plain version and the kernel
# ---------------------------------------------------------------------------


def _unpack(texel, shift: int):
    return ((texel >> shift) & 0xFF).to(F32) * _INV255


def sample_atlas_bilinear(atlas, uv_x, uv_y):
    """Bilinear WRAP sample of the packed atlas ((h, w) int32 of u32 RGBA8
    bits) at texture-space uv; returns (..., 4) f32 in [0, 1]."""
    h, w = atlas.shape
    x = uv_x * float(w) - 0.5
    y = uv_y * float(h) - 0.5
    x0 = torch.floor(x).to(I32)
    y0 = torch.floor(y).to(I32)
    fx = (x - x0.to(F32))[..., None]
    fy = (y - y0.to(F32))[..., None]
    flat = atlas.reshape(-1)

    def fetch(ix, iy):
        ix = torch.remainder(ix, w)
        iy = torch.remainder(iy, h)
        texel = flat[(iy * w + ix).long()]
        return torch.stack([_unpack(texel, s) for s in (0, 8, 16, 24)],
                           dim=-1)

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def composite_layers_plain(frame_u8, cnt, layers, atlas, K: int = DEFAULT_K):
    """The plain torch version of K8b, the reference's ``composite_layers``:
    every one of the K layers in order, blended with a = 0 past the
    count; the frame's alpha forced to 255.  Returns (H, W, 4) uint8."""
    lu, lv, lc = layers
    h, w = cnt.shape
    dst = frame_u8[..., :3].to(F32) / torch.tensor(255.0, dtype=F32,
                                                   device=cnt.device)
    for k in range(K):
        tex = sample_atlas_bilinear(atlas, lu[k], lv[k])
        col = lc[k]
        src_rgb = torch.stack([_unpack(col, s) for s in (0, 8, 16)],
                              dim=-1) * tex[..., :3]
        src_a = _unpack(col, 24) * tex[..., 3]
        live = (cnt > k)[..., None].to(F32)
        a = src_a[..., None] * live
        dst = src_rgb * a + dst * (1.0 - a)
    q = torch.floor(torch.clamp(dst, 0.0, 1.0) * 255.0 + 0.5).to(U8)
    alpha = torch.full((h, w, 1), 255, dtype=U8, device=cnt.device)
    return torch.cat([q, alpha], dim=-1)


def composite_aligned(*tensors) -> bool:
    """True when every tensor starts on a 16-byte boundary, as K8b's
    16-byte loads and stores need."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def overlay_composite_kernel(frame_u8, cnt, layers, atlas,
                             K: int = DEFAULT_K):
    """Launch K8b (``csrc/overlay.cu``: four pixels a thread, a pixel
    without a live layer copied with alpha 255) on the current stream;
    returns the composited (H, W, 4) uint8 frame.  The kernel reads the
    frame and the count and writes the output 16 bytes at a time: a frame
    or count that does not start on a 16-byte boundary (a view into a
    larger buffer) is copied into a fresh tensor first."""
    lu, lv, lc = layers
    dev = cnt.device
    h, w = cnt.shape
    _check("frame_u8", frame_u8, U8, dev, 3, 4)
    _check("cnt", cnt, I32, dev, 2)
    _check("lu", lu, F32, dev, 3)
    _check("lv", lv, F32, dev, 3)
    _check("lc", lc, I32, dev, 3)
    _check("atlas", atlas, I32, dev, 2)
    for name, t, shape in (("frame_u8", frame_u8, (h, w, 4)),
                           ("lu", lu, (K, h, w)), ("lv", lv, (K, h, w)),
                           ("lc", lc, (K, h, w))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {shape} expected, got "
                             f"{tuple(t.shape)}")
    if not composite_aligned(frame_u8):
        frame_u8 = frame_u8.clone()
    if not composite_aligned(cnt):
        cnt = cnt.clone()
    out = torch.empty((h, w, 4), dtype=U8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(_build.load_library().zr_overlay_composite, _ptr(frame_u8),
                _ptr(cnt), _ptr(lu), _ptr(lv), _ptr(lc), K, _ptr(atlas),
                atlas.shape[0], atlas.shape[1], _ptr(out), h, w,
                ctypes.c_void_p(stream))
    overlay_composite_kernel.launches += 1
    return out


OVERLAY_KERNELS = (overlay_raster_kernel, overlay_composite_kernel)
for _kernel in OVERLAY_KERNELS:
    _kernel.launches = 0
del _kernel


def composite_layers(frame_u8, cnt, layers, atlas, K: int = DEFAULT_K):
    """K8b for CUDA tensors, its plain version for CPU tensors."""
    if _on_cpu(cnt):
        return composite_layers_plain(frame_u8, cnt, layers, atlas, K)
    return overlay_composite_kernel(frame_u8, cnt, layers, atlas, K)


def overlay_pass(frame_u8, tri_i32, tri_f32, atlas, K: int = DEFAULT_K):
    """The overlay pass on an (H, W, 4) uint8 frame: K8 then K8b on the
    card, their plain versions on the CPU.  All tensors on one device."""
    h, w = frame_u8.shape[:2]
    cnt, _over, layers = rasterize_overlay(tri_i32, tri_f32, w, h, K)
    return composite_layers(frame_u8, cnt, layers, atlas, K)
