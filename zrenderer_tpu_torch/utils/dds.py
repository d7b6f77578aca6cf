"""DDS container decode — the DirectDraw-surface format WIC/D3DX apps
feed the reference's texture loader (zd3d12.zig:1415-1548 accepts any
WIC-decodable container; DDS is the native D3D texture interchange).

Top-level mip only (the engine regenerates mip chains on device —
ops/mipmap.py — exactly as the reference's MipmapGenerator does for
WIC-loaded images).  Supported payloads:

* uncompressed RGB/RGBA via the pixel-format channel masks (BGRA8,
  RGBA8, XRGB8, 24-bit RGB — mask-driven, any channel order);
* BC1/DXT1 (4-color + 1-bit-alpha 3-color mode), BC2/DXT3 (explicit
  4-bit alpha), BC3/DXT5 (interpolated alpha) — block decompression
  vectorized over all blocks at once (NumPy, no per-block Python loop);
* the DX10 extended header for the equivalent DXGI formats.

Returns (h, w, 4) uint8 RGBA like every decoder in utils/image.py.

The port's copy of ``zrenderer_tpu/utils/dds.py``, so the port decodes DDS
textures without the JAX package; ``tests/test_torch_assets.py`` holds the
two equal.
"""

from __future__ import annotations

import struct

import numpy as np

_DDPF_ALPHAPIXELS = 0x1
_DDPF_FOURCC = 0x4
_DDPF_RGB = 0x40

# DXGI formats the DX10 header may carry for the supported payloads.
_DXGI_BC1 = {70, 71, 72}
_DXGI_BC2 = {73, 74, 75}
_DXGI_BC3 = {76, 77, 78}
_DXGI_RGBA8 = {27, 28, 29}  # R8G8B8A8 typeless/unorm/srgb
_DXGI_BGRA8 = {90, 91, 87, 88}


def _expand_565(c):
    """(N,) u16 RGB565 -> (N, 3) u8 with the standard bit-replication."""
    r = ((c >> 11) & 0x1F).astype(np.uint16)
    g = ((c >> 5) & 0x3F).astype(np.uint16)
    b = (c & 0x1F).astype(np.uint16)
    return np.stack(
        [(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)],
        axis=-1,
    ).astype(np.uint8)


def _bc_color_block(c0, c1, idx_bits, force4: bool):
    """Decode the shared BC color half: c0/c1 (N,) u16, idx_bits (N,) u32.
    Returns ((N, 16, 3) u8 colors, (N, 16) bool opaque)."""
    n = c0.shape[0]
    p0 = _expand_565(c0).astype(np.int32)
    p1 = _expand_565(c1).astype(np.int32)
    four = force4 | (c0 > c1)  # (N,)
    # Palettes for both modes, select per block.
    pal = np.empty((n, 4, 3), np.int32)
    pal[:, 0] = p0
    pal[:, 1] = p1
    pal4_2 = (2 * p0 + p1 + 1) // 3  # DX spec: (2c0+c1)/3, round toward +
    pal4_3 = (p0 + 2 * p1 + 1) // 3
    pal3_2 = (p0 + p1) // 2
    pal[:, 2] = np.where(four[:, None], pal4_2, pal3_2)
    pal[:, 3] = np.where(four[:, None], pal4_3, 0)
    texel = (idx_bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    colors = np.take_along_axis(
        pal, texel[..., None].astype(np.int64), axis=1
    )  # (N, 16, 3)
    opaque = four[:, None] | (texel != 3)
    return colors.astype(np.uint8), opaque


def _bc_tile(colors, alpha, width, height):
    """Assemble (N, 16, 4) block texels into the (h, w, 4) image."""
    nbx = (width + 3) // 4
    nby = (height + 3) // 4
    rgba = np.concatenate([colors, alpha[..., None]], axis=-1)
    img = rgba.reshape(nby, nbx, 4, 4, 4).transpose(0, 2, 1, 3, 4)
    img = img.reshape(nby * 4, nbx * 4, 4)
    return np.ascontiguousarray(img[:height, :width])


def _decode_bc1(data, width, height):
    nb = ((width + 3) // 4) * ((height + 3) // 4)
    blk = np.frombuffer(data, np.uint8, nb * 8).reshape(nb, 8)
    c0 = blk[:, 0].astype(np.uint16) | (blk[:, 1].astype(np.uint16) << 8)
    c1 = blk[:, 2].astype(np.uint16) | (blk[:, 3].astype(np.uint16) << 8)
    idx = (blk[:, 4].astype(np.uint32) | (blk[:, 5].astype(np.uint32) << 8)
           | (blk[:, 6].astype(np.uint32) << 16)
           | (blk[:, 7].astype(np.uint32) << 24))
    colors, opaque = _bc_color_block(c0, c1, idx, force4=np.zeros(nb, bool))
    alpha = np.where(opaque, 255, 0).astype(np.uint8)
    return _bc_tile(colors, alpha, width, height)


def _decode_bc2(data, width, height):
    nb = ((width + 3) // 4) * ((height + 3) // 4)
    blk = np.frombuffer(data, np.uint8, nb * 16).reshape(nb, 16)
    a16 = blk[:, :8]  # 16 x 4-bit explicit alpha, little-endian nibbles
    lo = (a16 & 0x0F).astype(np.uint8)
    hi = (a16 >> 4).astype(np.uint8)
    a4 = np.empty((nb, 16), np.uint8)
    a4[:, 0::2] = lo
    a4[:, 1::2] = hi
    alpha = (a4 << 4) | a4  # 4 -> 8 bit replication
    c0 = blk[:, 8].astype(np.uint16) | (blk[:, 9].astype(np.uint16) << 8)
    c1 = blk[:, 10].astype(np.uint16) | (blk[:, 11].astype(np.uint16) << 8)
    idx = (blk[:, 12].astype(np.uint32)
           | (blk[:, 13].astype(np.uint32) << 8)
           | (blk[:, 14].astype(np.uint32) << 16)
           | (blk[:, 15].astype(np.uint32) << 24))
    colors, _ = _bc_color_block(c0, c1, idx, force4=np.ones(nb, bool))
    return _bc_tile(colors, alpha, width, height)


def _decode_bc3(data, width, height):
    nb = ((width + 3) // 4) * ((height + 3) // 4)
    blk = np.frombuffer(data, np.uint8, nb * 16).reshape(nb, 16)
    a0 = blk[:, 0].astype(np.int32)
    a1 = blk[:, 1].astype(np.int32)
    bits = np.zeros(nb, np.uint64)
    for i in range(6):
        bits |= blk[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    sel = ((bits[:, None] >> (3 * np.arange(16, dtype=np.uint64)))
           & np.uint64(7)).astype(np.int32)  # (N, 16)
    pal = np.empty((nb, 8), np.int32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    seven = a0 > a1
    for k in range(2, 8):
        interp7 = ((8 - k) * a0 + (k - 1) * a1 + 3) // 7
        if k < 6:
            interp5 = ((6 - k) * a0 + (k - 1) * a1 + 2) // 5
        elif k == 6:
            interp5 = np.zeros(nb, np.int32)
        else:
            interp5 = np.full(nb, 255, np.int32)
        pal[:, k] = np.where(seven, interp7, interp5)
    alpha = np.take_along_axis(pal, sel.astype(np.int64), axis=1)
    alpha = alpha.astype(np.uint8)
    c0 = blk[:, 8].astype(np.uint16) | (blk[:, 9].astype(np.uint16) << 8)
    c1 = blk[:, 10].astype(np.uint16) | (blk[:, 11].astype(np.uint16) << 8)
    idx = (blk[:, 12].astype(np.uint32)
           | (blk[:, 13].astype(np.uint32) << 8)
           | (blk[:, 14].astype(np.uint32) << 16)
           | (blk[:, 15].astype(np.uint32) << 24))
    colors, _ = _bc_color_block(c0, c1, idx, force4=np.ones(nb, bool))
    return _bc_tile(colors, alpha, width, height)


def _mask_channel(px_u32, mask):
    """Extract a channel through its bit mask, rescaled to 0..255."""
    if mask == 0:
        return None
    shift = (mask & -mask).bit_length() - 1
    width = int(mask >> shift).bit_length()
    v = ((px_u32 >> shift) & (mask >> shift)).astype(np.uint32)
    if width >= 8:
        v = v >> (width - 8)
    else:
        v = (v * 255) // ((1 << width) - 1)
    return v.astype(np.uint8)


def decode_dds(data: bytes) -> np.ndarray:
    if data[:4] != b"DDS " or len(data) < 128:
        raise ValueError("not a DDS file")
    height = struct.unpack_from("<I", data, 12)[0]
    width = struct.unpack_from("<I", data, 16)[0]
    pf_flags = struct.unpack_from("<I", data, 80)[0]
    fourcc = data[84:88]
    bitcount = struct.unpack_from("<I", data, 88)[0]
    masks = struct.unpack_from("<4I", data, 92)
    payload = data[128:]

    if pf_flags & _DDPF_FOURCC:
        if fourcc == b"DX10":
            dxgi = struct.unpack_from("<I", data, 128)[0]
            payload = data[148:]
            if dxgi in _DXGI_BC1:
                return _decode_bc1(payload, width, height)
            if dxgi in _DXGI_BC2:
                return _decode_bc2(payload, width, height)
            if dxgi in _DXGI_BC3:
                return _decode_bc3(payload, width, height)
            if dxgi in _DXGI_RGBA8 | _DXGI_BGRA8:
                px = np.frombuffer(payload, np.uint8, width * height * 4)
                px = px.reshape(height, width, 4)
                if dxgi in _DXGI_BGRA8:
                    px = px[..., [2, 1, 0, 3]]
                return np.ascontiguousarray(px)
            raise ValueError(f"unsupported DDS DXGI format {dxgi}")
        if fourcc == b"DXT1":
            return _decode_bc1(payload, width, height)
        if fourcc in (b"DXT2", b"DXT3"):
            return _decode_bc2(payload, width, height)
        if fourcc in (b"DXT4", b"DXT5"):
            return _decode_bc3(payload, width, height)
        raise ValueError(f"unsupported DDS fourCC {fourcc!r}")

    if pf_flags & _DDPF_RGB:
        bypp = bitcount // 8
        if bypp not in (2, 3, 4):
            raise ValueError(f"unsupported DDS bit count {bitcount}")
        raw = np.frombuffer(payload, np.uint8, width * height * bypp)
        raw = raw.reshape(height, width, bypp).astype(np.uint32)
        px = np.zeros((height, width), np.uint32)
        for i in range(bypp):
            px |= raw[..., i] << (8 * i)
        r = _mask_channel(px, masks[0])
        gch = _mask_channel(px, masks[1])
        b = _mask_channel(px, masks[2])
        a = (_mask_channel(px, masks[3])
             if pf_flags & _DDPF_ALPHAPIXELS else None)
        if a is None:
            a = np.full((height, width), 255, np.uint8)
        zero = np.zeros((height, width), np.uint8)
        return np.stack([c if c is not None else zero
                         for c in (r, gch, b, a)], axis=-1)

    raise ValueError("unsupported DDS pixel format")
