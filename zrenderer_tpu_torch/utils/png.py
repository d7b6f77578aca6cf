"""Minimal PNG encode/decode (pure Python + zlib).

The presentation analog of the reference's swapchain Present + WIC image
loading (zd3d12.zig:649-675, :1415-1548): frames are written to disk or
streamed instead of flipped to a window, and textures load from PNG files.

The port's copy of ``zrenderer_tpu/utils/png.py``, so the port writes
frames without the JAX package; ``tests/test_torch_host.py`` holds the
two equal.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path, rgba: np.ndarray) -> None:
    """Write an (H, W, 3|4) u8 array as a PNG file."""
    data = encode_png(rgba)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(rgba: np.ndarray) -> bytes:
    rgba = np.ascontiguousarray(rgba)
    assert rgba.dtype == np.uint8 and rgba.ndim == 3 and rgba.shape[2] in (3, 4)
    h, w, c = rgba.shape
    color_type = 6 if c == 4 else 2
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 per scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgba.reshape(h, w * c)], axis=1
    ).tobytes()
    idat = zlib.compress(raw, 6)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def read_png(path) -> np.ndarray:
    """Read a PNG: 1/2/4/8/16-bit, gray/RGB/palette/alpha, interlaced or
    not (filters 0-4) — the WIC-grade breadth for the runtime texture path."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data)


# Adam7 interlace pass grid: (x0, y0, dx, dy)
_ADAM7 = [
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
]


def _defilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filters; raw: (h, 1 + stride) bytes."""
    img = np.zeros((h, stride), np.uint8)
    for i in range(h):
        line = raw[i, 1:].astype(np.int32)
        ft = raw[i, 0]
        prev = img[i - 1].astype(np.int32) if i > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            out = line
        elif ft == 2:  # up
            out = (line + prev) & 0xFF
        else:
            out = np.zeros(stride, np.int32)
            for j in range(stride):
                a = out[j - bpp] if j >= bpp else 0
                b = prev[j]
                cc = prev[j - bpp] if j >= bpp else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:  # 4: Paeth
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                out[j] = (line[j] + pred) & 0xFF
        img[i] = out.astype(np.uint8)
    return img


def _unpack_pixels(rows: np.ndarray, w: int, channels: int,
                   bitdepth: int) -> np.ndarray:
    """(h, stride_bytes) filtered bytes -> (h, w, channels) uint8 samples
    (16-bit scales down, sub-byte depths expand to 0..255)."""
    h = rows.shape[0]
    if bitdepth == 8:
        return rows[:, : w * channels].reshape(h, w, channels)
    if bitdepth == 16:
        v = rows.reshape(h, -1)[:, : w * channels * 2]
        v = v.reshape(h, w * channels, 2)
        return (v[..., 0]).reshape(h, w, channels)  # high byte = /257 approx
    # 1/2/4-bit: gray or palette indices, packed MSB-first.
    bits = np.unpackbits(rows, axis=1)
    per = bitdepth
    vals = np.zeros((h, w), np.uint8)
    for k in range(per):
        vals = (vals << 1) | bits[:, k : k + w * per : per][:, :w]
    return vals[..., None]


def decode_png(data: bytes) -> np.ndarray:
    """Decode in-memory PNG bytes (the utils.image dispatch entry)."""
    assert data[:8] == _SIG, "not a PNG"
    pos = 8
    idat = b""
    palette = None
    trns = None
    w = h = bitdepth = color_type = interlace = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    if bitdepth not in (1, 2, 4, 8, 16):
        raise ValueError(f"bad PNG bit depth {bitdepth}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    bits_pp = channels * bitdepth
    bpp = max(1, bits_pp // 8)

    def stride_of(width):
        return (width * bits_pp + 7) // 8

    out = np.zeros((h, w, channels), np.uint8)
    pos2 = 0
    if interlace == 0:
        stride = stride_of(w)
        rows = raw[: h * (stride + 1)].reshape(h, stride + 1)
        out = _unpack_pixels(_defilter(rows, h, stride, bpp), w, channels,
                             bitdepth)
    elif interlace == 1:  # Adam7
        for x0, y0, dx, dy in _ADAM7:
            pw = (w - x0 + dx - 1) // dx
            ph = (h - y0 + dy - 1) // dy
            if pw == 0 or ph == 0:
                continue
            stride = stride_of(pw)
            n = ph * (stride + 1)
            rows = raw[pos2 : pos2 + n].reshape(ph, stride + 1)
            pos2 += n
            px = _unpack_pixels(_defilter(rows, ph, stride, bpp), pw,
                                channels, bitdepth)
            out[y0::dy, x0::dx] = px
    else:
        raise ValueError(f"bad PNG interlace method {interlace}")

    if color_type == 3:  # palette
        assert palette is not None, "palette PNG without PLTE"
        rgb = palette[out[..., 0]]
        if trns is not None:
            alpha = np.full((h, w, 1), 255, np.uint8)
            small = out[..., 0] < len(trns)
            alpha[..., 0][small] = trns[out[..., 0][small]]
            return np.concatenate([rgb, alpha], axis=2)
        return rgb
    if color_type == 0 and bitdepth < 8:  # sub-byte gray: expand range
        scale = 255 // ((1 << bitdepth) - 1)
        out = out * np.uint8(scale)
    return out
