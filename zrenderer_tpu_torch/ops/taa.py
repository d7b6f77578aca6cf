"""Temporal anti-aliasing (counterpart of ``zrenderer_tpu/ops/taa.py``,
BASELINE config 4's "TAA resolve").

* The projection is jittered each frame by a Halton(2, 3) sub-pixel
  offset (``jitter_sequence``, ``jittered_view_proj``: host NumPy, copies
  of the reference's), which the fixed-point raster turns into varying
  coverage.
* The resolve blends the new frame into a history of 16-bit fixed-point
  colour (u8 * 257) with a 3x3 neighbourhood min/max clamp (wrapping at
  the frame's edges) and an alpha quantized to x/64.  It is integer
  arithmetic, so it gives the same bits on every device.

One planar implementation, ``_resolve_planes`` over (3, H, W) int32
channel planes, serves both entry points: ``taa_resolve`` on an
(H, W, 4) u8 frame with an (H, W, 3) history, and ``taa_resolve_packed``
on the raster's packed frame (u32 bits in an int32 (H, W) tensor) with a
(3, H, W) history.  Plain torch: the reference leaves it to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
FIXED_MAX = 65535
BLEND_DENOM = 64  # alpha quantized to x/64
_ALPHA_BITS = -(1 << 24)  # 0xFF000000 as int32


def halton(index: int, base: int) -> float:
    f, r = 1.0, 0.0
    i = index + 1
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def jitter_sequence(n: int = 8) -> np.ndarray:
    """(n, 2) sub-pixel jitters in [-0.5, 0.5) (Halton 2, 3)."""
    return np.array(
        [[halton(i, 2) - 0.5, halton(i, 3) - 0.5] for i in range(n)],
        np.float32,
    )


def jittered_view_proj(view_proj: np.ndarray, jitter_xy,
                       width: int, height: int) -> np.ndarray:
    """Offset the projection by a sub-pixel translate in NDC (row-vector:
    column 0 += jx * column 3, column 1 += jy * column 3)."""
    j = np.array(view_proj, np.float32)
    jx = 2.0 * float(jitter_xy[0]) / width
    jy = -2.0 * float(jitter_xy[1]) / height  # y flips in the viewport
    j[:, 0] = j[:, 0] + jx * j[:, 3]
    j[:, 1] = j[:, 1] + jy * j[:, 3]
    return j


def _blend_weight(alpha: float) -> int:
    w = int(round(alpha * BLEND_DENOM))
    if not 0 < w <= BLEND_DENOM:
        raise ValueError(
            f"alpha={alpha} quantizes to {w}/{BLEND_DENOM}; it must "
            f"round to a nonzero multiple of 1/{BLEND_DENOM} in (0, 1] "
            f"(minimum alpha is 1/{2 * BLEND_DENOM})")
    return w


def _neighborhood_minmax(planes):
    """3x3 min/max of (3, H, W) planes, wrapping at the edges: a vertical
    3-tap pass, then a horizontal one (integer min/max is associative, so
    this equals the dense 3x3)."""
    up = torch.roll(planes, 1, dims=1)
    dn = torch.roll(planes, -1, dims=1)
    lo_v = torch.minimum(torch.minimum(planes, up), dn)
    hi_v = torch.maximum(torch.maximum(planes, up), dn)
    lo = torch.minimum(torch.minimum(lo_v, torch.roll(lo_v, 1, dims=2)),
                       torch.roll(lo_v, -1, dims=2))
    hi = torch.maximum(torch.maximum(hi_v, torch.roll(hi_v, 1, dims=2)),
                       torch.roll(hi_v, -1, dims=2))
    return lo, hi


def _resolve_planes(history3, current3, w: int):
    """The integer resolve on (3, H, W) int32 fixed-point planes: returns
    (new history, resolved u8 values as int32).  The largest operand,
    65535 * 64 + 32, is below 2^23."""
    lo, hi = _neighborhood_minmax(current3)
    clamped = torch.minimum(torch.maximum(history3, lo), hi)
    out = (clamped * (BLEND_DENOM - w) + current3 * w
           + BLEND_DENOM // 2) >> (BLEND_DENOM.bit_length() - 1)
    return out, (out + 128) // 257


def taa_init_history(current_u8):
    """First-frame history: the (H, W, 4) u8 frame's colour in 16-bit
    fixed point, (H, W, 3) int32."""
    return current_u8[..., :3].to(I32) * 257


def taa_resolve(history_i32, current_u8, alpha: float = 0.1):
    """Blend the current (H, W, 4) u8 frame into the (H, W, 3) int32
    history with neighbourhood clamping.  Returns (new history (H, W, 3)
    int32, resolved (H, W, 4) u8 with alpha 255).  ``alpha`` is quantized
    to round(alpha * 64) / 64 and must not quantize to 0."""
    w = _blend_weight(alpha)
    current3 = current_u8[..., :3].to(I32).permute(2, 0, 1) * 257
    out, res = _resolve_planes(history_i32.permute(2, 0, 1), current3, w)
    resolved = torch.cat([res.to(torch.uint8),
                          torch.full_like(res[:1], 255, dtype=torch.uint8)])
    return (out.permute(1, 2, 0).contiguous(),
            resolved.permute(1, 2, 0).contiguous())


def taa_init_history_packed(packed):
    """First-frame history from the raster's packed frame (u32 RGBA8 bits
    in an int32 (H, W) tensor): (3, H, W) int32 fixed-point planes."""
    return torch.stack([(packed >> s) & 0xFF for s in (0, 8, 16)]) * 257


def taa_resolve_packed(history3, packed, alpha: float = 0.1):
    """``taa_resolve`` on the packed frame with (3, H, W) history planes:
    the same integer resolve per channel, no channel-minor tensor.
    Returns (new history (3, H, W) int32, resolved packed frame: u32 bits
    in int32, alpha 255)."""
    w = _blend_weight(alpha)
    out, res = _resolve_planes(history3, taa_init_history_packed(packed), w)
    return out, res[0] | (res[1] << 8) | (res[2] << 16) | _ALPHA_BITS
