"""From-scratch baseline TIFF decoder — the last WIC container breadth gap.

The reference's runtime texture loader goes through WIC, which accepts any
installed container including TIFF (zd3d12.zig:1415-1548,
``createAndUploadTex2dFromFile``); the vendored stb_image does NOT decode
TIFF, so this closes a WIC-only breadth item (VERDICT r3 missing #1).

Scope (baseline TIFF 6.0, the subset real texture files use):

* both byte orders (``II``/``MM``), first IFD only
* strip AND tile organization (tags 273/278/279 and 322-325)
* Compression 1 (none), 5 (TIFF-variant LZW with early code-width
  change), 8/32946 (Deflate/zlib), 32773 (PackBits)
* Predictor 1 (none) and 2 (horizontal differencing)
* 8 bits per sample, chunky planar config; grayscale (+alpha), palette
  color, RGB, RGBA (ExtraSamples associated or unassociated alike)
* PhotometricInterpretation 0 (WhiteIsZero), 1 (BlackIsZero), 2 (RGB),
  3 (palette)

Everything decodes to the module contract of utils/image.py:
(h, w, 4) uint8 RGBA.

The port's copy of ``zrenderer_tpu/utils/tiff.py``, so the port decodes
TIFFs without the JAX package; ``tests/test_torch_assets.py`` holds the two
equal.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# Tag ids (TIFF 6.0 spec names).
T_WIDTH = 256
T_LENGTH = 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES = 277
T_ROWS_PER_STRIP = 278
T_STRIP_COUNTS = 279
T_PLANAR = 284
T_PREDICTOR = 317
T_COLORMAP = 320
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_COUNTS = 325

# Field type -> (struct code, byte size).
_TYPES = {
    1: ("B", 1),   # BYTE
    2: ("s", 1),   # ASCII
    3: ("H", 2),   # SHORT
    4: ("I", 4),   # LONG
    5: ("II", 8),  # RATIONAL
    6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
    11: ("f", 4), 12: ("d", 8),
}


def _read_ifd(data: bytes, off: int, bo: str):
    """First-IFD tag dict: id -> tuple of values."""
    (count,) = struct.unpack_from(bo + "H", data, off)
    tags = {}
    for k in range(count):
        base = off + 2 + 12 * k
        tag, ftype, n = struct.unpack_from(bo + "HHI", data, base)
        if ftype not in _TYPES:
            continue
        code, size = _TYPES[ftype]
        total = size * n * len(code.replace("s", "B"))
        if total <= 4:
            voff = base + 8
        else:
            (voff,) = struct.unpack_from(bo + "I", data, base + 8)
        if ftype == 2:
            tags[tag] = (data[voff:voff + n],)
        elif ftype in (5, 10):
            raw = struct.unpack_from(bo + code * n, data, voff)
            tags[tag] = tuple(
                raw[2 * i] / max(raw[2 * i + 1], 1) for i in range(n)
            )
        else:
            tags[tag] = struct.unpack_from(bo + code * n, data, voff)
    return tags


def _lzw_decode(data: bytes, expected: int) -> bytes:
    """TIFF-variant LZW: MSB-first packed codes, Clear=256, EOI=257, and
    the code width increments one code EARLY (at 511/1023/2047)."""
    out = bytearray()
    table: list[bytes] = []

    def reset():
        table.clear()
        table.extend(bytes([i]) for i in range(256))
        table.append(b"")  # 256 clear
        table.append(b"")  # 257 eoi

    reset()
    width = 9
    acc = 0
    nbits = 0
    prev: bytes | None = None
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (acc >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == 256:
                reset()
                width = 9
                prev = None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            # Early change: width bumps when the NEXT code would not fit.
            if len(table) + 1 >= (1 << width) and width < 12:
                width += 1
            if len(out) >= expected:
                return bytes(out)
    return bytes(out)


def _packbits_decode(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
        # 128 = no-op
    return bytes(out)


def _decompress(raw: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return _lzw_decode(raw, expected)
    if compression in (8, 32946):
        return zlib.decompress(raw)
    if compression == 32773:
        return _packbits_decode(raw, expected)
    raise ValueError(f"unsupported TIFF compression {compression}")


def _undo_predictor(block: np.ndarray, predictor: int) -> np.ndarray:
    """block: (rows, cols, spp) u8.  Predictor 2 = horizontal differencing
    per sample: cumulative sum along the row, mod 256."""
    if predictor == 2:
        return np.cumsum(block.astype(np.uint32), axis=1).astype(np.uint8)
    return block


def decode_tiff(data: bytes) -> np.ndarray:
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("not a TIFF file")
    (magic,) = struct.unpack_from(bo + "H", data, 2)
    if magic != 42:
        raise ValueError(f"bad TIFF magic {magic}")
    (ifd_off,) = struct.unpack_from(bo + "I", data, 4)
    tags = _read_ifd(data, ifd_off, bo)

    width = tags[T_WIDTH][0]
    height = tags[T_LENGTH][0]
    spp = tags.get(T_SAMPLES, (1,))[0]
    bits = tags.get(T_BITS, (8,) * spp)
    if any(b != 8 for b in bits):
        raise ValueError(f"unsupported TIFF bit depths {bits}")
    compression = tags.get(T_COMPRESSION, (1,))[0]
    photometric = tags.get(T_PHOTOMETRIC, (1,))[0]
    planar = tags.get(T_PLANAR, (1,))[0]
    predictor = tags.get(T_PREDICTOR, (1,))[0]
    if planar != 1:
        raise ValueError("unsupported TIFF planar configuration 2")

    img = np.zeros((height, width, spp), np.uint8)
    if T_TILE_OFFSETS in tags:
        tw = tags[T_TILE_WIDTH][0]
        tl = tags[T_TILE_LENGTH][0]
        offsets = tags[T_TILE_OFFSETS]
        counts = tags[T_TILE_COUNTS]
        across = (width + tw - 1) // tw
        down = (height + tl - 1) // tl
        if len(offsets) < across * down:
            raise ValueError("tiled TIFF: short tile table")
        for ty in range(down):
            for tx in range(across):
                k = ty * across + tx
                raw = data[offsets[k]:offsets[k] + counts[k]]
                expected = tw * tl * spp
                block = np.frombuffer(
                    _decompress(raw, compression, expected)[:expected],
                    np.uint8,
                ).reshape(tl, tw, spp)
                block = _undo_predictor(block, predictor)
                y0, x0 = ty * tl, tx * tw
                h = min(tl, height - y0)
                w = min(tw, width - x0)
                img[y0:y0 + h, x0:x0 + w] = block[:h, :w]
    else:
        offsets = tags[T_STRIP_OFFSETS]
        counts = tags.get(
            T_STRIP_COUNTS, (len(data) - offsets[0],) * len(offsets)
        )
        rps = tags.get(T_ROWS_PER_STRIP, (height,))[0]
        row = 0
        for off, cnt in zip(offsets, counts):
            rows = min(rps, height - row)
            if rows <= 0:
                break
            expected = rows * width * spp
            strip = np.frombuffer(
                _decompress(data[off:off + cnt], compression, expected)
                [:expected],
                np.uint8,
            ).reshape(rows, width, spp)
            img[row:row + rows] = _undo_predictor(strip, predictor)
            row += rows

    # Photometric -> RGBA.
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    if photometric == 3:  # palette
        cmap = np.asarray(tags[T_COLORMAP], np.uint32)
        n = cmap.shape[0] // 3
        # 16-bit colormap entries; the spec scale is v*257 but common
        # writers (incl. PIL) emit v*256 — the high byte recovers the
        # original value under either scale.
        lut = (cmap.reshape(3, n).T >> 8).astype(np.uint8)
        out[..., :3] = lut[img[..., 0]]
        if spp >= 2:
            out[..., 3] = img[..., 1]
    elif photometric in (0, 1):  # grayscale
        g = img[..., 0]
        if photometric == 0:
            g = 255 - g
        out[..., 0] = out[..., 1] = out[..., 2] = g
        if spp >= 2:
            out[..., 3] = img[..., 1]
    elif photometric == 2:  # RGB(A)
        out[..., :3] = img[..., :3]
        if spp >= 4:
            out[..., 3] = img[..., 3]
    else:
        raise ValueError(f"unsupported TIFF photometric {photometric}")
    return out
