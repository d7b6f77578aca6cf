"""ICO container decode — Windows icon files, one of the WIC-decodable
containers the reference's texture loader accepts (zd3d12.zig:1415-1548).

Picks the largest image in the directory.  Entries are either embedded
PNGs (Vista+) — delegated to utils/png.py — or BMP DIBs (BITMAPINFOHEADER
with doubled height covering the XOR color plane + the 1-bit AND
transparency mask).  32-bit entries use their alpha channel; 24/8/4/1-bit
entries take transparency from the AND mask.  Returns (h, w, 4) u8 RGBA.

The port's copy of ``zrenderer_tpu/utils/ico.py``, so the port decodes
icons without the JAX package; ``tests/test_torch_assets.py`` holds the
two equal.  One rule differs: the DIB height is halved only when it is
twice the directory's height (``_decode_dib_entry``).
"""

from __future__ import annotations

import struct

import numpy as np


def _decode_dib_entry(data: bytes, w_hint: int, h_hint: int) -> np.ndarray:
    hdr_size = struct.unpack_from("<I", data, 0)[0]
    if hdr_size < 40:
        raise ValueError(f"unsupported ICO DIB header size {hdr_size}")
    width, height2 = struct.unpack_from("<ii", data, 4)
    bpp = struct.unpack_from("<H", data, 14)[0]
    compression = struct.unpack_from("<I", data, 16)[0]
    ncolors = struct.unpack_from("<I", data, 32)[0]
    if compression != 0:
        raise ValueError(f"unsupported ICO DIB compression {compression}")
    # The DIB height covers the XOR and AND planes when it is doubled; a
    # DIB whose height equals the directory's is not doubled.  (The
    # reference also halves a height equal to twice the directory's
    # *width*, which misreads an undoubled h = 2w entry.)  A height that
    # matches neither is taken as doubled, as the reference does.
    if height2 in (h_hint, 2 * h_hint):
        height = h_hint
    else:
        height = height2 // 2
    pos = hdr_size
    palette = None
    if bpp <= 8:
        n = ncolors or (1 << bpp)
        palette = np.frombuffer(data, np.uint8, n * 4, pos).reshape(n, 4)
        pos += n * 4

    stride = (width * bpp + 31) // 32 * 4
    xor_bytes = stride * height
    xor = np.frombuffer(data, np.uint8, xor_bytes, pos)
    pos += xor_bytes

    if bpp == 32:
        px = xor.reshape(height, stride)[:, : width * 4]
        px = px.reshape(height, width, 4)[::-1]
        rgba = px[..., [2, 1, 0, 3]].copy()
        return np.ascontiguousarray(rgba)

    if bpp == 24:
        px = xor.reshape(height, stride)[:, : width * 3]
        px = px.reshape(height, width, 3)[::-1]
        rgb = px[..., ::-1]
    elif bpp in (1, 4, 8):
        bits = np.unpackbits(
            xor.reshape(height, stride), axis=1, bitorder="big"
        )
        if bpp == 8:
            idx = xor.reshape(height, stride)[:, :width]
        elif bpp == 4:
            nib = xor.reshape(height, stride)
            idx = np.empty((height, width), np.uint8)
            pairs = nib[:, : (width + 1) // 2]
            idx[:, 0::2] = pairs[:, : (width + 1) // 2] >> 4
            idx[:, 1::2] = (pairs[:, : width // 2] & 0x0F)
        else:
            idx = bits[:, :width]
        bgr = palette[idx.astype(np.int64)][..., :3]
        rgb = bgr[::-1, :, ::-1]
    else:
        raise ValueError(f"unsupported ICO bpp {bpp}")

    # 1-bit AND mask (transparency): set, pixel is transparent.
    and_stride = (width + 31) // 32 * 4
    try:
        mask_bytes = np.frombuffer(data, np.uint8, and_stride * height, pos)
        mask_bits = np.unpackbits(
            mask_bytes.reshape(height, and_stride), axis=1, bitorder="big"
        )[:, :width][::-1]
        alpha = np.where(mask_bits > 0, 0, 255).astype(np.uint8)
    except ValueError:  # mask absent/truncated: fully opaque
        alpha = np.full((height, width), 255, np.uint8)
    return np.concatenate(
        [np.ascontiguousarray(rgb), alpha[..., None]], axis=2
    )


def decode_ico(data: bytes) -> np.ndarray:
    if len(data) < 6 or struct.unpack_from("<HH", data, 0) != (0, 1):
        raise ValueError("not an ICO file")
    count = struct.unpack_from("<H", data, 4)[0]
    if count == 0:
        raise ValueError("empty ICO directory")
    best = None
    for i in range(count):
        off = 6 + 16 * i
        w = data[off] or 256
        h = data[off + 1] or 256
        size, img_off = struct.unpack_from("<II", data, off + 8)
        if best is None or w * h > best[0] * best[1]:
            best = (w, h, size, img_off)
    w, h, size, img_off = best
    entry = data[img_off : img_off + size]
    if entry[:8] == b"\x89PNG\r\n\x1a\n":
        from zrenderer_tpu_torch.utils.png import decode_png

        return decode_png(entry)
    return _decode_dib_entry(entry, w, h)
