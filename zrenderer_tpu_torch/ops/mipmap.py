"""Mipmap generation (counterpart of ``zrenderer_tpu/ops/mipmap.py``).

Each level is the 2x2 box filter ``0.25 * ((s00 + s01) + (s10 + s11))`` of
the level above, in the reference's association, so the chain is
bit-identical to the JAX one; non-square power-of-two textures are
supported.  The chain is built once per texture at load.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def downsample_2x2(level):
    """One 2x2 box-filter step: (h, w, c) -> (h/2, w/2, c)."""
    h, w = level.shape[0], level.shape[1]
    s = level.reshape(h // 2, 2, w // 2, 2, -1)
    return (0.25 * ((s[:, 0, :, 0] + s[:, 0, :, 1])
                    + (s[:, 1, :, 0] + s[:, 1, :, 1]))).to(level.dtype)


def generate_mip_chain(texture, num_levels: int | None = None):
    """Full mip pyramid of a base (h, w, c) f32 tensor: [base, mip1, ...];
    the level count defaults to log2(min(h, w)) + 1."""
    h, w = texture.shape[0], texture.shape[1]
    if not (_is_pow2(h) and _is_pow2(w)):
        raise ValueError(f"mip generation needs power-of-2 dims, got {h}x{w}")
    max_levels = int(np.log2(min(h, w))) + 1
    num_levels = (max_levels if num_levels is None
                  else min(num_levels, max_levels))
    chain = [texture]
    for _ in range(num_levels - 1):
        chain.append(downsample_2x2(chain[-1]))
    return chain


def pack_mip_atlas(chain):
    """Pack a mip chain into one (h, 2w, c) atlas: mip L at x offset
    sum(w / 2^k, k < L), y offset 0.  Returns (atlas, offsets_x (L,) i32,
    sizes (L, 2) i32 [h, w])."""
    h, w, c = chain[0].shape[0], chain[0].shape[1], chain[0].shape[2]
    atlas = torch.zeros((h, 2 * w, c), dtype=chain[0].dtype,
                        device=chain[0].device)
    offsets, sizes = [], []
    x = 0
    for level in chain:
        lh, lw = level.shape[0], level.shape[1]
        atlas[:lh, x:x + lw] = level
        offsets.append(x)
        sizes.append((lh, lw))
        x += lw
    return (atlas, torch.tensor(offsets, dtype=torch.int32),
            torch.tensor(sizes, dtype=torch.int32))
