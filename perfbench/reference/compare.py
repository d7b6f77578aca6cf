"""The comparison that decides ``correct``: the frames the timed loop
presented against the plain reference's, pixel by pixel.

Numbers of the worst checked frame (each number's largest over the
frames, so that a fault in one frame of the window reads as it would
alone):

* ``cover_px``: pixels covered (depth < 1) on one side only;
* ``color_px``: pixels with a channel more than ``color_tol_lsb`` apart
  (RASTER_SPEC §5: the resolve's divide, 1 LSB; shading's
  transcendentals, 2);
* ``depth_px``: pixels covered on both sides whose depths lie more than
  ``depth_tol_ulp`` float32 steps apart.

A cell compares the numbers its limits file (``perfbench/limits/
<cell>.json``) names, each against its limit.
"""

from __future__ import annotations

import torch

NUMBERS = ("cover_px", "color_px", "depth_px")


def _ordered(depth: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in the same order (0 and -0 equal)."""
    bits = (depth.to(torch.float32) + 0.0).view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def frame_numbers(color, depth, ref_color, ref_depth, tolerances: dict):
    """The three numbers of one frame (host or device tensors)."""
    cov = depth < 1.0
    ref_cov = ref_depth < 1.0
    diff = (color.to(torch.int16) - ref_color.to(torch.int16)).abs()
    color_bad = (diff > int(tolerances["color_tol_lsb"])).any(dim=-1)
    ulp = (_ordered(depth) - _ordered(ref_depth)).abs()
    depth_bad = cov & ref_cov & (ulp > int(tolerances["depth_tol_ulp"]))
    return {"cover_px": int((cov != ref_cov).sum()),
            "color_px": int(color_bad.sum()),
            "depth_px": int(depth_bad.sum())}


def worst(per_frame: list) -> dict:
    return {k: max(f[k] for f in per_frame) for k in NUMBERS}


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limit for k, limit in limits.items())
