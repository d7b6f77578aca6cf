"""Radiance HDR (.hdr / RGBE) decoder — from scratch.

Decodes the Radiance picture format: ``#?RADIANCE`` header, ``-Y H +X W``
resolution line, flat RGBE or new-style per-component RLE scanlines.
Returns (h, w, 4) float32 linear radiance, alpha = 1 — the stb_image
``stbi_loadf`` analog (the reference vendors stb_image with HDR support;
SURVEY.md §2.2, VERDICT r2 missing item 1).

RGBE -> float uses stb's convention: f = ldexp(1, e - (128 + 8));
rgb = mantissa * f; e == 0 -> 0.

The port's copy of ``zrenderer_tpu/utils/hdr.py``, so the port decodes
Radiance HDR images without the JAX package; ``tests/test_torch_assets.py``
holds the two equal.
"""

from __future__ import annotations

import numpy as np


def decode_hdr(data: bytes) -> np.ndarray:
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError("not a Radiance HDR file")
    # Header: lines until the blank line; then the resolution line.
    pos = 0
    fmt_ok = False
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"FORMAT="):
            fmt_ok = line[7:].strip() in (b"32-bit_rle_rgbe", b"32-bit_rle_xyze")
        if line == b"":
            break
    if not fmt_ok:
        raise ValueError("HDR: missing/unsupported FORMAT")
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"HDR: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])

    rgbe = np.empty((h, w, 4), np.uint8)
    buf = memoryview(data)
    for y in range(h):
        if w >= 8 and w < 32768 and buf[pos] == 2 and buf[pos + 1] == 2 \
                and (buf[pos + 2] << 8 | buf[pos + 3]) == w:
            # New-style RLE: 4 components coded separately.
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = buf[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = np.frombuffer(
                            buf, np.uint8, count, pos
                        )
                        pos += count
                        x += count
        else:
            # Flat scanline (old-style 1,1,1 run encoding unsupported —
            # not emitted by modern writers).
            row = np.frombuffer(buf, np.uint8, w * 4, pos)
            pos += w * 4
            rgbe[y] = row.reshape(w, 4)

    mant = rgbe[..., :3].astype(np.float32)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(
        e > 0, np.exp2((e - 136).astype(np.float32)), np.float32(0.0)
    )
    out = np.empty((h, w, 4), np.float32)
    out[..., :3] = mant * scale[..., None]
    out[..., 3] = 1.0
    return out
