"""GIF decoder — from scratch (WIC/stb_image GIF-path analog).

Decodes GIF87a/GIF89a: LZW compression, global/local color tables,
interlacing, and the 89a graphic-control transparency index.  Returns the
FIRST frame composed onto the logical screen as (h, w, 4) uint8 RGBA —
the texture-load semantics of WIC's frame-0 CopyPixels
(zd3d12.zig:1466-1489) and stb_image's default gif load.

The port's copy of ``zrenderer_tpu/utils/gif.py``, so the port decodes GIFs
without the JAX package; ``tests/test_torch_assets.py`` holds the two equal.
"""

from __future__ import annotations

import struct

import numpy as np


def decode_gif(data: bytes) -> np.ndarray:
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF")
    sw, sh = struct.unpack_from("<HH", data, 6)
    packed = data[10]
    bg_index = data[11]
    pos = 13
    global_table = None
    if packed & 0x80:
        n = 2 << (packed & 7)
        global_table = np.frombuffer(data, np.uint8, n * 3, pos).reshape(n, 3)
        pos += n * 3

    transparent = None
    while pos < len(data):
        b = data[pos]
        pos += 1
        if b == 0x3B:  # trailer
            break
        if b == 0x21:  # extension
            label = data[pos]
            pos += 1
            if label == 0xF9:  # graphic control
                size = data[pos]
                flags = data[pos + 1]
                if flags & 1:
                    transparent = data[pos + 4]
                pos += size + 1
            while data[pos] != 0:  # skip (remaining) sub-blocks
                pos += data[pos] + 1
            pos += 1
        elif b == 0x2C:  # image descriptor — decode frame 0 and return
            left, top, w, h = struct.unpack_from("<HHHH", data, pos)
            flags = data[pos + 8]
            pos += 9
            table = global_table
            if flags & 0x80:
                n = 2 << (flags & 7)
                table = np.frombuffer(
                    data, np.uint8, n * 3, pos
                ).reshape(n, 3)
                pos += n * 3
            if table is None:
                raise ValueError("GIF frame with no color table")
            min_code = data[pos]
            pos += 1
            chunks = []
            while data[pos] != 0:
                ln = data[pos]
                chunks.append(data[pos + 1 : pos + 1 + ln])
                pos += ln + 1
            pos += 1
            indices = _lzw_decode(b"".join(chunks), min_code, w * h)
            idx = np.frombuffer(
                bytes(indices[: w * h]), np.uint8
            ).reshape(h, w)
            if flags & 0x40:  # interlaced: 4-pass row order
                rows = np.concatenate([
                    np.arange(0, h, 8), np.arange(4, h, 8),
                    np.arange(2, h, 4), np.arange(1, h, 2),
                ])
                de = np.empty_like(idx)
                de[rows] = idx
                idx = de
            rgba = np.empty((h, w, 4), np.uint8)
            rgba[..., :3] = table[np.minimum(idx, len(table) - 1)]
            rgba[..., 3] = 255
            if transparent is not None:
                rgba[idx == transparent] = 0
            # Compose onto the logical screen (frame can be a sub-rect).
            if (left, top, w, h) == (0, 0, sw, sh):
                return rgba
            screen = np.zeros((sh, sw, 4), np.uint8)
            if global_table is not None and transparent != bg_index:
                screen[..., :3] = global_table[
                    min(bg_index, len(global_table) - 1)
                ]
                screen[..., 3] = 255
            screen[top : top + h, left : left + w] = rgba
            return screen
        else:
            raise ValueError(f"bad GIF block 0x{b:02x}")
    raise ValueError("GIF contains no image")


def _lzw_decode(data: bytes, min_code: int, expected: int) -> bytearray:
    """GIF-variant LZW: variable code width starting at min_code+1,
    clear/EOI codes, dictionary capped at 4096 entries."""
    clear = 1 << min_code
    eoi = clear + 1
    out = bytearray()

    # Bit reader, LSB-first.
    acc = 0
    nbits = 0
    bytepos = 0

    def read_code(width):
        nonlocal acc, nbits, bytepos
        while nbits < width:
            if bytepos >= len(data):
                return eoi
            acc |= data[bytepos] << nbits
            nbits += 8
            bytepos += 1
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        return code

    def reset():
        d = [bytes([i]) for i in range(clear)] + [b"", b""]
        return d, min_code + 1

    table, width = reset()
    prev = None
    while len(out) < expected:
        code = read_code(width)
        if code == clear:
            table, width = reset()
            prev = None
            continue
        if code == eoi:
            break
        if code < len(table):
            entry = table[code]
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
        else:
            raise ValueError("corrupt GIF LZW stream")
        out += entry
        if prev is not None and len(table) < 4096:
            table.append(prev + entry[:1])
            if len(table) == (1 << width) and width < 12:
                width += 1
        prev = entry
    return out
