"""Image decoding with format dispatch — the WIC-image-load analog.

The reference loads textures through WIC, which accepts BMP/PNG/JPEG/TGA/…
(zd3d12.zig:1415-1548 createAndUploadTex2dFromFile).  This module is the
host-side equivalent: ``read_image`` sniffs the container and decodes to an
(h, w, 4) uint8 RGBA array.  Decoders are from scratch (no third-party
imaging dependency):

* PNG   — utils/png.py (filters 0-4, 8-bit, via the native zlib path)
* JPEG  — utils/jpeg.py (baseline + PROGRESSIVE DCT, 4:4:4/4:2:2/4:2:0,
          restart markers; vectorized batch IDCT)
* GIF   — utils/gif.py (87a/89a, LZW, interlace, transparency; frame 0)
* HDR   — utils/hdr.py (Radiance RGBE, RLE scanlines -> float32 RGBA)
* TIFF  — utils/tiff.py (strips + tiles; none/LZW/Deflate/PackBits;
          predictor 2; gray/palette/RGB/RGBA — the WIC-only container)
* DDS   — utils/dds.py (BC1/BC2/BC3 block decompression, mask-driven
          uncompressed RGB(A), DX10 header — the native D3D container)
* ICO   — utils/ico.py (PNG and BMP-DIB entries, AND-mask transparency)
* BMP   — uncompressed BI_RGB 24/32-bit, bottom-up and top-down
* TGA   — type 2/10 (uncompressed / RLE true-color), 24/32-bit
* PNM   — P5 (grayscale) / P6 (RGB), maxval 255

All decoders return (h, w, 4) uint8 RGBA except HDR, which returns
(h, w, 4) float32 linear radiance (the stbi_loadf analog).

The port's copy of ``zrenderer_tpu/utils/image.py``, so the port decodes
images without the JAX package; ``tests/test_torch_assets.py`` holds the two
equal.
"""

from __future__ import annotations

import struct

import numpy as np


def read_image(path) -> np.ndarray:
    """Decode any supported image file to (h, w, 4) uint8 RGBA."""
    path = str(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        from zrenderer_tpu_torch.utils.png import decode_png

        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        from zrenderer_tpu_torch.utils.jpeg import decode_jpeg

        return decode_jpeg(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        from zrenderer_tpu_torch.utils.gif import decode_gif

        return decode_gif(data)
    if data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE"):
        from zrenderer_tpu_torch.utils.hdr import decode_hdr

        return decode_hdr(data)
    if data[:2] in (b"II", b"MM") and data[2:4] in (b"*\x00", b"\x00*"):
        from zrenderer_tpu_torch.utils.tiff import decode_tiff

        return decode_tiff(data)
    if data[:4] == b"DDS ":
        from zrenderer_tpu_torch.utils.dds import decode_dds

        return decode_dds(data)
    if data[:4] == b"\x00\x00\x01\x00" and len(data) >= 6:
        from zrenderer_tpu_torch.utils.ico import decode_ico

        return decode_ico(data)
    if data[:2] == b"BM":
        return _decode_bmp(data)
    if data[:2] in (b"P5", b"P6"):
        return _decode_pnm(data)
    if path.lower().endswith(".tga"):
        return _decode_tga(data)
    raise ValueError(f"unsupported image format: {path}")


def _rgba(rgb_or_rgba: np.ndarray) -> np.ndarray:
    if rgb_or_rgba.shape[2] == 4:
        return rgb_or_rgba
    h, w = rgb_or_rgba.shape[:2]
    return np.concatenate(
        [rgb_or_rgba, np.full((h, w, 1), 255, np.uint8)], axis=2
    )


def _decode_bmp(data: bytes) -> np.ndarray:
    """BITMAPFILEHEADER + BITMAPINFOHEADER, BI_RGB 24/32bpp."""
    if len(data) < 54:
        raise ValueError("truncated BMP")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise ValueError(f"unsupported BMP header size {header_size}")
    width, height = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if planes != 1 or compression != 0 or bpp not in (24, 32):
        raise ValueError(
            f"unsupported BMP (bpp={bpp}, compression={compression})"
        )
    top_down = height < 0
    height = abs(height)
    bytes_pp = bpp // 8
    stride = (width * bytes_pp + 3) & ~3
    need = pixel_offset + stride * height
    if len(data) < need:
        raise ValueError("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * height, pixel_offset)
    rows = rows.reshape(height, stride)[:, : width * bytes_pp]
    px = rows.reshape(height, width, bytes_pp)
    if not top_down:
        px = px[::-1]
    # BMP stores BGR(A).
    rgb = px[..., 2::-1]
    if bytes_pp == 4:
        return np.concatenate([rgb, px[..., 3:4]], axis=2).copy()
    return _rgba(np.ascontiguousarray(rgb))


def _decode_pnm(data: bytes) -> np.ndarray:
    """P5/P6 binary PNM, maxval <= 255."""
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":  # comment to end of line
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    width, height, maxval = fields
    if maxval > 255:
        raise ValueError("16-bit PNM unsupported")
    channels = 3 if data[:2] == b"P6" else 1
    px = np.frombuffer(data, np.uint8, width * height * channels, pos)
    px = px.reshape(height, width, channels)
    if channels == 1:
        px = np.repeat(px, 3, axis=2)
    return _rgba(np.ascontiguousarray(px))


def _decode_tga(data: bytes) -> np.ndarray:
    """TGA type 2 (uncompressed) / 10 (RLE), 24/32-bit true color."""
    if len(data) < 18:
        raise ValueError("truncated TGA")
    id_len = data[0]
    cmap_type = data[1]
    image_type = data[2]
    width, height = struct.unpack_from("<HH", data, 12)
    bpp = data[16]
    descriptor = data[17]
    if cmap_type != 0 or image_type not in (2, 10) or bpp not in (24, 32):
        raise ValueError(
            f"unsupported TGA (type={image_type}, bpp={bpp})"
        )
    bytes_pp = bpp // 8
    pos = 18 + id_len
    count = width * height
    if image_type == 2:
        px = np.frombuffer(data, np.uint8, count * bytes_pp, pos)
        px = px.reshape(count, bytes_pp)
    else:  # RLE
        out = np.empty((count, bytes_pp), np.uint8)
        filled = 0
        while filled < count:
            header = data[pos]
            pos += 1
            run = (header & 0x7F) + 1
            if header & 0x80:  # RLE packet: one pixel repeated
                pixel = np.frombuffer(data, np.uint8, bytes_pp, pos)
                pos += bytes_pp
                out[filled : filled + run] = pixel
            else:  # raw packet
                raw = np.frombuffer(data, np.uint8, run * bytes_pp, pos)
                pos += run * bytes_pp
                out[filled : filled + run] = raw.reshape(run, bytes_pp)
            filled += run
        px = out
    px = px.reshape(height, width, bytes_pp)
    if not (descriptor & 0x20):  # bottom-up origin unless bit 5 set
        px = px[::-1]
    rgb = px[..., 2::-1]  # BGR(A) -> RGB
    if bytes_pp == 4:
        return np.concatenate([rgb, px[..., 3:4]], axis=2).copy()
    return _rgba(np.ascontiguousarray(rgb))
