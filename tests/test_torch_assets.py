"""The port's asset path against the reference's: every image decoder
behind ``read_image``, the native mesh library and its Python fallbacks,
the glTF converter and its CLI, runtime glTF loading, the showcase
builder, textures from any image format with their derived gather
atlases, and the quad, oct and pvar samplers.

Inputs are made from seeded numpy (PIL only encodes the JPEG, GIF, TIFF
and PNG fixtures).  Decoded images, zmath-driven cameras, converter
files and sampler taps are held equal to the reference's: exactly, byte
for byte or bit for bit.
"""

import base64
import functools
import hashlib
import io
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from zrenderer_tpu.engine import textures as ref_textures
from zrenderer_tpu.ops import sampling as ref_sampling
from zrenderer_tpu.scene import gltf_runtime as ref_runtime
from zrenderer_tpu.scene.mesh import MeshData as RefMeshData
from zrenderer_tpu.tools import gltf_converter as ref_converter
from zrenderer_tpu.tools import make_showcase as ref_showcase
from zrenderer_tpu.utils import image as ref_image
from zrenderer_tpu.utils import native as ref_native
from zrenderer_tpu_torch.app.main import bind_scene_textures, load_scene_path
from zrenderer_tpu_torch.app.main import main as app_main
from zrenderer_tpu_torch.engine import textures
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.ops import sampling
from zrenderer_tpu_torch.scene import gltf_runtime
from zrenderer_tpu_torch.scene import procedural
from zrenderer_tpu_torch.scene.mesh import MeshData
from zrenderer_tpu_torch.scene.scene import Scene
from zrenderer_tpu_torch.tools import gltf_converter, make_showcase
from zrenderer_tpu_torch.utils import image, native
from zrenderer_tpu_torch.utils.png import encode_png, read_png

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHOWCASE = os.path.join(ROOT, "content", "scenes", "showcase")
SHOWCASE_SRC = os.path.join(ROOT, "content", "scenes", "showcase_src")
SHOWCASE_GLTF = os.path.join(SHOWCASE_SRC, "showcase.gltf")
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")


def _same(a, b):
    """Equal values of equal types; arrays by dtype, shape and bytes."""
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def _bits(x):
    """A torch or JAX array's bytes as int32 (u32 atlases in either
    package are compared as their bits)."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype in (np.uint32, np.float32) else a


# ---------------------------------------------------------------------------
# Image fixtures: one file per container and variant
# ---------------------------------------------------------------------------


def _pil_bytes(arr, fmt, **kw):
    from PIL import Image

    img = Image.fromarray(arr)
    out = io.BytesIO()
    img.save(out, format=fmt, **kw)
    return out.getvalue()


def _dds_header(width, height, *, fourcc=None, bitcount=0, masks=None):
    flags = (0x4 if fourcc else 0) | ((0x40 | (0x1 if masks[3] else 0))
                                      if masks else 0)
    h = bytearray(128)
    h[0:4] = b"DDS "
    struct.pack_into("<7I", h, 4, 124, 0x1007, height, width, 0, 0, 0)
    struct.pack_into("<2I", h, 76, 32, flags)
    if fourcc:
        h[84:88] = fourcc
    struct.pack_into("<I", h, 88, bitcount)
    if masks:
        struct.pack_into("<4I", h, 92, *masks)
    return bytes(h)


def _dds_files(rng):
    img = rng.integers(0, 256, (8, 12, 4), dtype=np.uint8)
    rgb = img[..., :3]
    blocks = rng.integers(0, 256, (2 * 3, 16), dtype=np.uint8)
    bc1 = blocks[:, :8].copy()
    bc1[0, :4] = [0x1F, 0x00, 0x00, 0xF8]  # c0 <= c1: the 3-colour mode
    return {
        "dds_bgra32": _dds_header(
            12, 8, bitcount=32,
            masks=(0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000))
        + img[..., [2, 1, 0, 3]].tobytes(),
        "dds_bgr24": _dds_header(12, 8, bitcount=24,
                                 masks=(0xFF0000, 0xFF00, 0xFF, 0))
        + rgb[..., ::-1].tobytes(),
        "dds_rgb565": _dds_header(12, 8, bitcount=16,
                                  masks=(0xF800, 0x07E0, 0x001F, 0))
        + rng.integers(0, 2**16, 96, dtype=np.uint16).tobytes(),
        "dds_bc1": _dds_header(12, 8, fourcc=b"DXT1") + bc1.tobytes(),
        "dds_bc2": _dds_header(12, 8, fourcc=b"DXT3") + blocks.tobytes(),
        "dds_bc3": _dds_header(12, 8, fourcc=b"DXT5") + blocks.tobytes(),
        "dds_dx10": _dds_header(12, 8, fourcc=b"DX10")
        + struct.pack("<5I", 28, 3, 0, 1, 0) + img.tobytes(),
    }


def _ico(entries):
    """An ICO file of (directory w, directory h, entry bytes)."""
    d = struct.pack("<HHH", 0, 1, len(entries))
    off = 6 + 16 * len(entries)
    body = b""
    for w, h, data in entries:
        d += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, 32,
                         len(data), off + len(body))
        body += data
    return d + body


def _dib(width, height2, bpp, pixels, palette=None, mask=None):
    """A BITMAPINFOHEADER DIB: rows bottom-up, 4-byte aligned."""
    hdr = bytearray(40)
    ncolors = 0 if palette is None else len(palette)
    struct.pack_into("<IiiHHI", hdr, 0, 40, width, height2, 1, bpp, 0)
    struct.pack_into("<I", hdr, 32, ncolors)
    out = bytes(hdr)
    if palette is not None:
        out += palette.tobytes()
    stride = (width * bpp + 31) // 32 * 4
    rows = np.zeros((pixels.shape[0], stride), np.uint8)
    flat = pixels.reshape(pixels.shape[0], -1)
    rows[:, :flat.shape[1]] = flat
    out += rows[::-1].tobytes()
    if mask is not None:
        and_stride = (width + 31) // 32 * 4
        bits = np.packbits(mask, axis=1, bitorder="big")
        m = np.zeros((mask.shape[0], and_stride), np.uint8)
        m[:, :bits.shape[1]] = bits
        out += m[::-1].tobytes()
    return out


def _ico_files(rng):
    w, h = 8, 8
    bgra = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    mask = rng.integers(0, 2, (h, w), dtype=np.uint8)
    pal = rng.integers(0, 256, (16, 4), dtype=np.uint8)
    idx8 = rng.integers(0, 16, (h, w), dtype=np.uint8)
    idx4 = np.zeros((h, w // 2), np.uint8)
    idx4[:] = (idx8[:, 0::2] << 4) | idx8[:, 1::2]
    bits1 = np.packbits(rng.integers(0, 2, (h, w), dtype=np.uint8), axis=1)
    png = encode_png(rng.integers(0, 256, (16, 16, 4), dtype=np.uint8))
    return {
        "ico_png": _ico([(8, 8, _dib(w, 2 * h, 32, bgra)), (16, 16, png)]),
        "ico_dib32": _ico([(w, h, _dib(w, 2 * h, 32, bgra))]),
        "ico_dib24": _ico([(w, h, _dib(w, 2 * h, 24, bgra[..., :3],
                                       mask=mask))]),
        "ico_dib8": _ico([(w, h, _dib(w, 2 * h, 8, idx8, pal, mask))]),
        "ico_dib4": _ico([(w, h, _dib(w, 2 * h, 4, idx4, pal, mask))]),
        "ico_dib1": _ico([(w, h, _dib(w, 2 * h, 1, bits1, pal[:2], mask))]),
        "ico_no_mask": _ico([(w, h, _dib(w, 2 * h, 24, bgra[..., :3]))]),
        "ico_undoubled": _ico([(w, h, _dib(w, h, 24, bgra[..., :3],
                                           mask=mask))]),
    }


def _rgbe(rng, h, w):
    img = (rng.random((h, w, 3)).astype(np.float32) + 0.01) * np.exp2(
        rng.integers(-4, 12, (h, w, 1)).astype(np.float32))
    m = img.max(axis=-1)
    _, exp = np.frexp(m)
    mant = np.clip(img * np.exp2(8.0 - exp)[..., None], 0, 255)
    ebyte = np.where(m > 0, exp + 128, 0)[..., None]
    return np.concatenate([mant.astype(np.uint8), ebyte.astype(np.uint8)],
                          axis=-1)


def _hdr_files(rng):
    h, w = 8, 16
    rgbe = _rgbe(rng, h, w)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + \
        f"-Y {h} +X {w}\n".encode()
    runs = rgbe.copy()
    runs[:, 4:12] = runs[:, 4:5]
    lines = [head.replace(b"RADIANCE", b"RGBE")]
    for y in range(h):
        lines.append(bytes([2, 2, 0, w]))
        for c in range(4):
            row = runs[y, :, c]
            lines.append(bytes([4]) + row[0:4].tobytes())
            lines.append(bytes([128 + 8, int(row[4])]))
            lines.append(bytes([4]) + row[12:16].tobytes())
    return {"hdr_flat": head + rgbe.tobytes(), "hdr_rle": b"".join(lines)}


def _tiff_tiled(rng, bo):
    """A tiled, Deflate-compressed RGB TIFF in byte order ``bo``."""
    fmt = "<" if bo == b"II" else ">"
    h, w, tl, tw = 20, 40, 16, 32
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    tiles = []
    for ty in range(2):
        for tx in range(2):
            block = np.zeros((tl, tw, 3), np.uint8)
            part = rgb[ty * tl:(ty + 1) * tl, tx * tw:(tx + 1) * tw]
            block[:part.shape[0], :part.shape[1]] = part
            tiles.append(zlib.compress(block.tobytes()))
    tags = [(256, 3, 1, w), (257, 3, 1, h), (259, 3, 1, 8), (262, 3, 1, 2),
            (277, 3, 1, 3), (322, 3, 1, tw), (323, 3, 1, tl)]
    nt = len(tags) + 3
    bits_off = 8 + 2 + nt * 12 + 4
    toff, tcnt = bits_off + 6, bits_off + 6 + 16
    offsets, pos = [], tcnt + 16
    for t in tiles:
        offsets.append(pos)
        pos += len(t)
    tags = sorted(tags + [(258, 3, 3, bits_off), (324, 4, 4, toff),
                          (325, 4, 4, tcnt)])
    out = bytearray(bo + struct.pack(fmt + "HI", 42, 8))
    out += struct.pack(fmt + "H", nt)
    for tag, ftype, n, val in tags:
        out += struct.pack(fmt + "HHI", tag, ftype, n)
        out += (struct.pack(fmt + "HH", val, 0) if ftype == 3 and n == 1
                else struct.pack(fmt + "I", val))
    out += struct.pack(fmt + "I", 0) + struct.pack(fmt + "3H", 8, 8, 8)
    out += struct.pack(fmt + "4I", *offsets)
    out += struct.pack(fmt + "4I", *(len(t) for t in tiles))
    return bytes(out) + b"".join(tiles)


def _pil_files(rng):
    yy, xx = np.mgrid[0:24, 0:40]
    smooth = np.stack([(xx * 3) % 256, (yy * 2 + 40) % 256,
                       ((xx + yy) * 2) % 256], axis=-1).astype(np.uint8)
    noisy = np.clip(smooth.astype(int) + rng.integers(-60, 60, smooth.shape),
                    0, 255).astype(np.uint8)
    rgb = rng.integers(0, 256, (13, 11, 3), np.uint8)
    rgba = rng.integers(0, 256, (9, 14, 4), np.uint8)
    gray = rng.integers(0, 256, (10, 7), np.uint8)
    few = rng.integers(0, 256, (8, 3), np.uint8)[
        rng.integers(0, 8, (15, 17))]
    pal = rng.integers(0, 256, (16, 3), np.uint8)
    idx = rng.integers(0, 16, (9, 10), np.uint8)

    def pal_tiff():
        from PIL import Image

        pim = Image.fromarray(idx, mode="P")
        pim.putpalette(pal.flatten().tolist())
        out = io.BytesIO()
        pim.save(out, format="TIFF")
        return out.getvalue()

    def png_palette():
        from PIL import Image

        out = io.BytesIO()
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(
            out, format="PNG", transparency=3)
        return out.getvalue()

    def gif_transparent():
        from PIL import Image

        out = io.BytesIO()
        Image.fromarray(few).convert("P", palette=Image.ADAPTIVE).save(
            out, format="GIF", transparency=0)
        return out.getvalue()

    files = {
        "png_interlaced": _pil_bytes(rgb, "PNG", interlace=True),
        "png_palette": png_palette(),
        "png_gray4": _pil_bytes(
            (rng.integers(0, 16, (12, 11)) * 17).astype(np.uint8), "PNG",
            bits=4),
        "png_gray16": _pil_bytes(
            rng.integers(0, 65536, (6, 5), np.uint16), "PNG"),
        "gif": _pil_bytes(few, "GIF"),
        "gif_interlaced": _pil_bytes(few, "GIF", interlace=True),
        "gif_transparent": gif_transparent(),
        "tiff_raw": _pil_bytes(rgb, "TIFF"),
        "tiff_lzw": _pil_bytes(rgb, "TIFF", compression="tiff_lzw"),
        "tiff_deflate": _pil_bytes(rgb, "TIFF",
                                   compression="tiff_adobe_deflate"),
        "tiff_packbits": _pil_bytes(rgb, "TIFF", compression="packbits"),
        "tiff_rgba_predictor": _pil_bytes(rgba, "TIFF",
                                          compression="tiff_lzw",
                                          tiffinfo={317: 2}),
        "tiff_gray": _pil_bytes(gray, "TIFF", compression="tiff_deflate"),
        "tiff_palette": pal_tiff(),
        "tiff_tiled_le": _tiff_tiled(rng, b"II"),
        "tiff_tiled_be": _tiff_tiled(rng, b"MM"),
        "jpeg_gray": _pil_bytes(smooth[..., 0], "JPEG", quality=95),
        "jpeg_restart": _pil_bytes(smooth, "JPEG", quality=90, subsampling=0,
                                   restart_marker_blocks=2),
        "jpeg_progressive_gray": _pil_bytes(smooth[..., 0], "JPEG",
                                            quality=92, progressive=True),
        "jpeg_progressive_restart": _pil_bytes(
            noisy, "JPEG", quality=90, subsampling=2, progressive=True,
            restart_marker_blocks=2),
    }
    for sub in (0, 1, 2):  # 4:4:4, 4:2:2, 4:2:0
        files[f"jpeg_baseline_{sub}"] = _pil_bytes(
            smooth, "JPEG", quality=92, subsampling=sub)
        files[f"jpeg_progressive_noisy_{sub}"] = _pil_bytes(
            noisy, "JPEG", quality=88, subsampling=sub, progressive=True)
    return files


def _raw_files(rng):
    rgb = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    h, w = rgb.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)
    bmp24 = (b"BM" + struct.pack("<IHHI", 54 + rows.size, 0, 0, 54)
             + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 0,
                           0, 0, 0) + rows.tobytes())
    bgra = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    bmp32 = (b"BM" + struct.pack("<IHHI", 54 + bgra.size, 0, 0, 54)
             + struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 32, 0, bgra.size, 0,
                           0, 0, 0) + bgra.tobytes())

    def tga(kind, depth, body, desc=0):
        head = bytearray(18)
        head[2] = kind
        head[12:16] = struct.pack("<HH", w, h)
        head[16], head[17] = depth, desc
        return bytes(head) + body

    bgr = rgb[::-1, :, ::-1]
    rle = b"".join(bytes([w - 1]) + bgr[y].tobytes() for y in range(h))
    runs = b"".join(bytes([0x80 | (w - 1), 30, 200, 10]) for _ in range(h))
    return {
        "png": encode_png(np.concatenate(
            [rgb, np.full((h, w, 1), 255, np.uint8)], axis=2)),
        "bmp24": bmp24,
        "bmp32_top_down": bmp32,
        "ppm": f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes(),
        "pgm": f"P5\n# comment\n{w} {h}\n255\n".encode()
        + rgb[..., 0].tobytes(),
        "tga_raw24": tga(2, 24, bgr.tobytes()),
        "tga_raw32_top": tga(2, 32, bgra.tobytes(), desc=0x20),
        "tga_rle_raw": tga(10, 24, rle),
        "tga_rle_runs": tga(10, 24, runs),
    }


@functools.cache
def image_files():
    """name -> file bytes, from one seeded generator per family."""
    files = {}
    for seed, family in enumerate((_raw_files, _dds_files, _ico_files,
                                   _hdr_files, _pil_files)):
        files.update(family(np.random.default_rng(seed)))
    return files


IMAGE_NAMES = sorted(image_files())


def _write(tmp_path, name, data):
    # TGA has no magic: read_image dispatches it by its suffix.
    path = tmp_path / (name + (".tga" if name.startswith("tga") else ".img"))
    path.write_bytes(data)
    return path


@pytest.mark.parametrize("name", IMAGE_NAMES)
def test_read_image_matches_reference(tmp_path, name):
    """Every container and variant decodes to the reference's array:
    dtype, shape and bytes (HDR as f32 radiance; a PNG keeps its own
    channel count, as the reference's does)."""
    path = _write(tmp_path, name, image_files()[name])
    ours = image.read_image(path)
    assert _same(ours, ref_image.read_image(path))
    assert ours.ndim == 3 and ours.size > 0
    assert ours.dtype == (np.float32 if name.startswith("hdr") else np.uint8)


BAD_FILES = {
    "unknown": b"\x00\x01\x02\x03 not an image",
    "dds_short": b"DDS \x7c\x00\x00\x00",
    "dds_fourcc": _dds_header(4, 4, fourcc=b"ATI2") + bytes(16),
    "ico_empty": struct.pack("<HHH", 0, 1, 0),
    "ico_compressed": _ico([(4, 4, bytes(bytearray(
        struct.pack("<IiiHHI", 40, 4, 8, 1, 24, 1)) + bytes(24)))]),
}


@pytest.mark.parametrize("name", sorted(BAD_FILES))
def test_read_image_rejects_as_reference(tmp_path, name):
    """A file neither decodes raises what the reference raises."""
    path = _write(tmp_path, name, BAD_FILES[name])
    with pytest.raises(Exception) as ref_err:
        ref_image.read_image(path)
    with pytest.raises(type(ref_err.value)) as err:
        image.read_image(path)
    assert str(err.value) == str(ref_err.value)


def test_ico_undoubled_height_counter_case(tmp_path):
    """The one rule where the port's ICO decoder departs from the
    reference: an 8x16 entry whose DIB height (16) is not doubled.  The
    reference halves it because it equals twice the directory's width
    and returns the bottom 8 rows; the port reads all 16."""
    rng = np.random.default_rng(9)
    w, h = 8, 16
    bgr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = rng.integers(0, 2, (h, w), dtype=np.uint8)
    data = _ico([(w, h, _dib(w, h, 24, bgr, mask=mask))])
    ours = image.read_image(_write(tmp_path, "ico_counter", data))
    ref = ref_image.read_image(_write(tmp_path, "ico_counter", data))
    np.testing.assert_array_equal(ours[..., :3], bgr[..., ::-1])
    np.testing.assert_array_equal(ours[..., 3], np.where(mask, 0, 255))
    assert ours.shape == (16, 8, 4) and ref.shape == (8, 8, 4)
    # Doubled and equal heights decode as the reference's (see the
    # ico_* cases of test_read_image_matches_reference).


# ---------------------------------------------------------------------------
# The native library and its fallbacks
# ---------------------------------------------------------------------------


def test_native_builds_into_build_dir():
    """The port builds libzrt from native/zrt_native.cpp into its own
    hashed folder under build/, and never into native/."""
    assert native.available()
    path = native.build_library()
    assert path == native._lib_path() and path.exists()
    assert path.is_relative_to(native.BUILD_ROOT)
    assert native.SOURCE == native.BUILD_ROOT.parents[2] / "native" \
        / "zrt_native.cpp"
    assert native.load().zrt_version() >= 10


def _sphere(n_lat=10, n_lon=14):
    """A closed UV sphere, each vertex written once per use (so the remap
    has duplicates to weld)."""
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    ring = np.stack([np.sin(lat)[:, None] * np.cos(lon), np.cos(lat)[:, None]
                     + 0 * lon, np.sin(lat)[:, None] * np.sin(lon)], -1)
    v = np.concatenate([[[0, 1, 0]], ring.reshape(-1, 3), [[0, -1, 0]]])
    r = lambda i, j: 1 + i * n_lon + j % n_lon  # noqa: E731
    idx = [[0, r(0, j + 1), r(0, j)] for j in range(n_lon)]
    for i in range(n_lat - 2):
        for j in range(n_lon):
            idx += [[r(i, j), r(i, j + 1), r(i + 1, j)],
                    [r(i, j + 1), r(i + 1, j + 1), r(i + 1, j)]]
    last = len(v) - 1
    idx += [[last, r(n_lat - 2, j), r(n_lat - 2, j + 1)]
            for j in range(n_lon)]
    idx = np.asarray(idx, np.uint32).reshape(-1)
    return v.astype(np.float32), idx


@functools.cache
def _mesh_inputs():
    v, idx = _sphere()
    rng = np.random.default_rng(4)
    soup = np.concatenate([v[idx], rng.random((len(idx), 5), np.float32)
                           .round(1)], axis=1).astype(np.float32)
    soup[:, 3:] = 0.5  # shared attributes: the positions decide welding
    perm = rng.permutation(len(v))
    inv = np.argsort(perm).astype(np.uint32)
    return {"v": v, "idx": idx, "soup": soup, "v_scrambled": v[perm],
            "idx_scrambled": inv[idx],
            "blob": procedural.make_test_scene()[1].serialize()}


NATIVE_CASES = {
    "meshes_load": lambda m: [(m["blob"],)],
    "generate_vertex_remap": lambda m: [(m["soup"],)],
    "apply_remap": lambda m: [
        (m["soup"], *ref_native.generate_vertex_remap(m["soup"]),
         np.arange(len(m["soup"]), dtype=np.uint32))],
    "optimize_vertex_cache": lambda m: [(m["idx_scrambled"], len(m["v"])),
                                        (m["idx"], len(m["v"]), 8)],
    "analyze_vertex_cache": lambda m: [(m["idx_scrambled"], len(m["v"]),
                                        16)],
    "optimize_vertex_fetch": lambda m: [(m["v_scrambled"],
                                         m["idx_scrambled"])],
    "analyze_vertex_fetch": lambda m: [(m["idx_scrambled"], len(m["v"]),
                                        64)],
    "spatial_sort_triangles": lambda m: [(m["idx"], m["v"])],
    "simplify": lambda m: [(m["idx"], m["v"], len(m["idx"]) // 4, 0.3)],
    "encode_png": lambda m: [(np.random.default_rng(5).integers(
        0, 256, (9, 13, 4), dtype=np.uint8),)],
    "build_meshlets": lambda m: [(m["idx"], m["v"]),
                                 (m["idx"], m["v"], 16, 20)],
    "compute_meshlet_bounds": lambda m: [
        (*ref_native.build_meshlets(m["idx"], m["v"], 16, 20), m["v"])],
}


@pytest.mark.parametrize("library", ["native", "python"])
@pytest.mark.parametrize("name", sorted(NATIVE_CASES))
def test_native_matches_reference(monkeypatch, name, library):
    """Each function equals the reference's on the same meshes: through
    the two builds of the library, and through the two Python fallbacks
    (both libraries made unavailable)."""
    if library == "python":
        for mod in (native, ref_native):
            monkeypatch.setattr(mod, "load",
                                lambda build_if_missing=True: None)
    else:
        assert native.available() and ref_native.available()
    for args in NATIVE_CASES[name](_mesh_inputs()):
        copies = [np.copy(a) if isinstance(a, np.ndarray) else a
                  for a in args]
        got = getattr(native, name)(*copies)
        want = getattr(ref_native, name)(*args)
        assert _same(got, want), (name, library)


# ---------------------------------------------------------------------------
# The converter, runtime loading and the showcase builder
# ---------------------------------------------------------------------------


def _write_glb(gltf_path, glb_path):
    """The glTF with its buffer embedded as a GLB's BIN chunk."""
    with open(gltf_path) as f:
        doc = json.load(f)
    with open(os.path.join(os.path.dirname(gltf_path),
                           doc["buffers"][0].pop("uri")), "rb") as f:
        blob = f.read()
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    blob += b"\0" * (-len(blob) % 4)
    body = (struct.pack("<2I", len(js), 0x4E4F534A) + js
            + struct.pack("<2I", len(blob), 0x004E4942) + blob)
    with open(glb_path, "wb") as f:
        f.write(struct.pack("<3I", 0x46546C67, 2, 12 + len(body)) + body)


def _write_sphere_gltf(path):
    v, idx = _sphere()
    buf = v.tobytes() + idx.tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "meshes": [{"name": "S", "primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(v),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": v.nbytes},
            {"buffer": 0, "byteOffset": v.nbytes, "byteLength": idx.nbytes}],
        "buffers": [{"byteLength": len(buf),
                     "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def _input_dir(tmp_path, kind):
    """The showcase's source folder as .gltf or .glb, plus a sphere."""
    src = tmp_path / "in"
    shutil.copytree(SHOWCASE_SRC, src)
    if kind == "glb":
        _write_glb(src / "showcase.gltf", src / "showcase.glb")
        os.remove(src / "showcase.gltf")
        os.remove(src / "buffer.bin")
    _write_sphere_gltf(src / "sphere.gltf")
    return src


def _files(folder):
    return {name: (folder / name).read_bytes()
            for name in sorted(os.listdir(folder))}


CONVERTER_RUNS = {
    "scene_gltf": ("gltf", ["-s", "{in}/showcase.gltf"]),
    "scene_gltf_optimize": ("gltf", ["-s", "{in}/showcase.gltf", "-O"]),
    "scene_glb": ("glb", ["-s", "{in}/showcase.glb"]),
    "scene_glb_optimize": ("glb", ["-s", "{in}/showcase.glb", "-O"]),
    "folder_gltf_lods": ("gltf", ["-i", "{in}", "--lods", "3"]),
    "folder_glb_optimize_lods": ("glb", ["-i", "{in}", "-O", "--lods",
                                         "2"]),
}


@pytest.mark.parametrize("run", sorted(CONVERTER_RUNS))
def test_converter_cli_matches_reference(tmp_path, run):
    """The port's CLI writes the reference CLI's files byte for byte:
    .gltf and .glb input, scene and mesh-folder modes, with and without
    --optimize, with LOD chains (the sphere simplifies; the cubes are all
    borders and do not)."""
    kind, argv = CONVERTER_RUNS[run]
    src = _input_dir(tmp_path, kind)
    argv = [a.replace("{in}", str(src)) for a in argv]
    assert gltf_converter.main(argv + ["-o", str(tmp_path / "a")]) == 0
    assert ref_converter.main(argv + ["-o", str(tmp_path / "b")]) == 0
    ours, ref = _files(tmp_path / "a"), _files(tmp_path / "b")
    assert ours == ref
    assert "meshes.bin" in ours
    if argv[0] == "-s":
        assert {"scene.bin", "checker.png", "gradient.png"} <= set(ours)


@pytest.mark.parametrize("optimize", [False, True])
def test_load_gltf_matches_reference(optimize):
    """Runtime loading equals the reference's: the Scene (its camera from
    composed quaternions) and the MeshData serialize to the same bytes.
    The optimized load is the committed showcase bins (made with -O); the
    default load's scene.bin is too, its meshes.bin keeps the glTF's
    vertex order and so differs."""
    scene, md = gltf_runtime.load_gltf(SHOWCASE_GLTF, optimize=optimize)
    ref_scene, ref_md = ref_runtime.load_gltf(SHOWCASE_GLTF,
                                              optimize=optimize)
    assert scene.serialize() == ref_scene.serialize()
    assert md.serialize() == ref_md.serialize()
    with open(os.path.join(SHOWCASE, "scene.bin"), "rb") as f:
        assert scene.serialize() == f.read()
    with open(os.path.join(SHOWCASE, "meshes.bin"), "rb") as f:
        assert (md.serialize() == f.read()) == optimize


def test_save_writes_serialized_bytes(tmp_path):
    scene, md = gltf_runtime.load_gltf(SHOWCASE_GLTF, optimize=True)
    scene.save(tmp_path / "scene.bin")
    md.save(tmp_path / "meshes.bin")
    assert _files(tmp_path) == {
        "meshes.bin": md.serialize(), "scene.bin": scene.serialize()}
    assert Scene.load(tmp_path / "scene.bin").serialize() == \
        scene.serialize()


@pytest.mark.parametrize("optimize", [False, True])
def test_append_gltf_primitives_matches_reference(optimize):
    """Appending the showcase's meshes into an existing MeshData gives the
    reference's mesh indices and bytes."""
    md = MeshData.load(os.path.join(SHOWCASE, "meshes.bin"))
    ref_md = RefMeshData.load(os.path.join(SHOWCASE, "meshes.bin"))
    for mesh in (2, 0):
        got = gltf_runtime.append_gltf_primitives(md, SHOWCASE_GLTF, mesh,
                                                  optimize=optimize)
        want = ref_runtime.append_gltf_primitives(ref_md, SHOWCASE_GLTF,
                                                  mesh, optimize=optimize)
        assert got == want
    assert md.serialize() == ref_md.serialize()


def test_make_showcase_matches_reference(tmp_path):
    """The showcase builder's source folder and its converted folder equal
    the reference builder's, and the committed content."""
    for mod, side in ((make_showcase, "a"), (ref_showcase, "b")):
        gltf_path = mod.build(str(tmp_path / side / "src"))
        assert gltf_converter.main(
            ["-s", gltf_path, "-O", "-o", str(tmp_path / side / "out")]) == 0
    for part, committed in (("src", SHOWCASE_SRC), ("out", SHOWCASE)):
        ours = _files(tmp_path / "a" / part)
        assert ours == _files(tmp_path / "b" / part)
        assert ours == {name: open(os.path.join(committed, name),
                                   "rb").read()
                        for name in os.listdir(committed)}


def test_load_scene_path_resolves_textures_by_folder():
    """--scene: a bin folder resolves texture uris against itself, a glTF
    file against its own folder."""
    _, md, tex_dir = load_scene_path(SHOWCASE_GLTF)
    assert tex_dir == SHOWCASE_SRC
    assert md.texture_uris == ["checker.png", "gradient.png"]
    scene, _, tex_dir = load_scene_path(SHOWCASE)
    assert tex_dir == SHOWCASE and scene.nodes


# ---------------------------------------------------------------------------
# Textures and samplers
# ---------------------------------------------------------------------------


TEXTURE_IMAGES = {
    # Power-of-two images in several containers, HDR radiance above 1.0.
    "png": lambda r: encode_png(r.integers(0, 256, (16, 16, 4), np.uint8)),
    "dds": lambda r: _dds_header(32, 8, fourcc=b"DXT5") + r.integers(
        0, 256, 16 * 16, np.uint8).tobytes(),
    "hdr": lambda r: b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 8 +X 16\n"
    + _rgbe(r, 8, 16).tobytes(),
    "jpeg": lambda r: _pil_bytes(r.integers(0, 256, (16, 16, 3), np.uint8),
                                 "JPEG", quality=85),
}


@pytest.mark.parametrize("fmt", sorted(TEXTURE_IMAGES))
def test_texture_from_image_file_matches_reference(tmp_path, fmt):
    """The mip atlas (f32 and RGBA8) equals the reference's for each
    container; HDR values above 1.0 are filtered as they are and clamped
    only by the packing, as the reference does."""
    path = tmp_path / f"t.{fmt}"
    path.write_bytes(TEXTURE_IMAGES[fmt](np.random.default_rng(7)))
    tex = textures.Texture.from_image_file(path)
    ref = ref_textures.Texture.from_image_file(path)
    assert tex.base_shape == tuple(ref.base_shape)
    assert tex.num_levels == ref.num_levels
    np.testing.assert_array_equal(_bits(tex.atlas), _bits(ref.atlas))
    np.testing.assert_array_equal(_bits(tex.atlas_u32), _bits(ref.atlas_u32))
    if fmt == "hdr":
        assert tex.atlas.max() > 1.0


@functools.cache
def _sampler_textures():
    """(port TextureArray, reference TextureArray) of two 16x8 images."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (8, 16, 4), np.uint8) for _ in range(2)]
    return (textures.TextureArray.from_images(imgs),
            ref_textures.TextureArray.from_images(imgs))


@pytest.mark.parametrize("kind", ["quad", "oct", "pvar"])
@pytest.mark.parametrize("layers", [1, 2])
def test_derived_atlases_match_reference(kind, layers):
    """Texture's and TextureArray's lazily built atlases equal the
    reference's, layer by layer, and are built once."""
    arr, ref_arr = _sampler_textures()
    if layers == 1:
        arr = textures.Texture.from_array(read_png(os.path.join(
            SHOWCASE, "gradient.png")))
        ref_arr = ref_textures.Texture.from_png(os.path.join(
            SHOWCASE, "gradient.png"))
    got = getattr(arr, f"{kind}_atlas_u32")
    assert getattr(arr, f"{kind}_atlas_u32") is got
    np.testing.assert_array_equal(
        _bits(got), _bits(getattr(ref_arr, f"{kind}_atlas_u32")))
    moved = arr.to("cpu")
    assert getattr(moved, f"_{kind}") is None


def _uv_lod(shape, num_levels, seed):
    rng = np.random.default_rng(seed)
    uv = (rng.random((*shape, 2), np.float32) * 3 - 1).astype(np.float32)
    lod = (rng.random(shape, np.float32) * (num_levels - 1)).astype(
        np.float32)
    layer = rng.integers(0, 2, shape).astype(np.int32)
    return uv, lod, layer


@pytest.mark.parametrize("kind", ["quad", "oct", "pvar"])
def test_trilinear_forms_match_sample_trilinear_and_reference(kind):
    """Each trilinear form equals the port's ``sample_trilinear`` and the
    reference's function of the same name on the same atlas, uv, lod and
    layers, bit for bit."""
    import jax.numpy as jnp

    arr, ref_arr = _sampler_textures()
    h, w = arr.base_shape
    n = arr.num_levels
    uv, lod, layer = _uv_lod((24, 40), n, seed=len(kind))
    fn = f"sample_trilinear_{kind}"
    atlas = getattr(arr, f"{kind}_atlas_u32")
    t = torch.from_numpy
    got = getattr(sampling, fn)(atlas, h, w, n, t(uv), t(lod), t(layer))
    plain = sampling.sample_trilinear(arr.atlas_u32, h, w, n, t(uv), t(lod),
                                      t(layer))
    want = getattr(ref_sampling, fn)(getattr(ref_arr, f"{kind}_atlas_u32"),
                                     h, w, n, jnp.asarray(uv),
                                     jnp.asarray(lod), jnp.asarray(layer))
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fn", ["sample_bilinear_level",
                                "sample_bilinear_level_quad",
                                "sample_nearest_level"])
def test_level_samplers_match_reference(fn):
    """The integer-level samplers equal the reference's."""
    import jax.numpy as jnp

    arr, ref_arr = _sampler_textures()
    h, w = arr.base_shape
    uv, _, layer = _uv_lod((16, 20), arr.num_levels, seed=3)
    level = np.random.default_rng(4).integers(
        0, arr.num_levels, (16, 20)).astype(np.int32)
    atlas, ref_atlas = arr.atlas_u32, ref_arr.atlas_u32
    kw, ref_kw = {}, {}
    if fn.endswith("quad"):
        atlas, ref_atlas = arr.quad_atlas_u32, ref_arr.quad_atlas_u32
    if fn != "sample_nearest_level":
        kw, ref_kw = ({"layer": torch.from_numpy(layer)},
                      {"layer": jnp.asarray(layer)})
    got = getattr(sampling, fn)(atlas, h, w, torch.from_numpy(uv),
                                torch.from_numpy(level), **kw)
    want = getattr(ref_sampling, fn)(ref_atlas, h, w, jnp.asarray(uv),
                                     jnp.asarray(level), **ref_kw)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_textures_from_mesh_data_reads_any_format(tmp_path):
    """A TEXS table of TGA and DDS images binds as the reference's does."""
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (8, 8, 4), np.uint8)
    head = bytearray(18)
    head[2], head[16], head[17] = 2, 32, 0x20
    head[12:16] = struct.pack("<HH", 8, 8)
    (tmp_path / "a.tga").write_bytes(bytes(head)
                                     + img[..., [2, 1, 0, 3]].tobytes())
    (tmp_path / "b.dds").write_bytes(_dds_header(8, 8, fourcc=b"DXT1")
                                     + rng.integers(0, 256, 32,
                                                    np.uint8).tobytes())
    md = MeshData()
    md.texture_uris, md.material_texture = ["a.tga", "b.dds"], [1, 0, -1]
    tex, mat = textures.textures_from_mesh_data(md, str(tmp_path))
    ref_tex, ref_mat = ref_textures.textures_from_mesh_data(md,
                                                            str(tmp_path))
    assert mat == ref_mat == [1, 0, -1]
    for a, b in zip(tex, ref_tex, strict=True):
        np.testing.assert_array_equal(_bits(a.atlas_u32), _bits(b.atlas_u32))


# ---------------------------------------------------------------------------
# Frames off a runtime-loaded glTF
# ---------------------------------------------------------------------------

# The reference's XLA showcase frame (tests/goldens/
# showcase_lit_160x120.sha256) differs from the port's in three channel
# values, each by one: (flat index into the (120, 160, 4) frame, golden
# minus port).
SHOWCASE_GOLDEN_DELTA = ((63808, -1), (69509, 1), (73540, -1))


def _lit_frame(scene, md, tex_dir):
    r = Renderer(RenderConfig(width=160, height=120, pipeline="lit",
                              tri_align=64), device="cpu")
    r.load_scene(scene, md)
    tex, mat = textures.textures_from_mesh_data(md, tex_dir)
    assert tex is not None and len(tex) == 2
    r.set_environment(textures=tex, material_textures=mat)
    return r.render_and_read()[0]


@pytest.mark.parametrize("optimize", [False, True])
def test_lit_showcase_from_gltf_matches_bins_and_golden(optimize):
    """The lit showcase frame from the runtime glTF load equals the frame
    from the bins, and is within one LSB of the reference's golden frame:
    the port's frame plus SHOWCASE_GOLDEN_DELTA hashes to the golden."""
    scene, md = gltf_runtime.load_gltf(SHOWCASE_GLTF, optimize=optimize)
    img = _lit_frame(scene, md, SHOWCASE_SRC)
    bins = _lit_frame(Scene.load(os.path.join(SHOWCASE, "scene.bin")),
                      MeshData.load(os.path.join(SHOWCASE, "meshes.bin")),
                      SHOWCASE)
    np.testing.assert_array_equal(img, bins)
    golden = img.astype(np.int32).reshape(-1)
    for i, d in SHOWCASE_GOLDEN_DELTA:
        assert abs(d) == 1
        golden[i] += d
    with open(os.path.join(GOLDEN_DIR, "showcase_lit_160x120.sha256")) as f:
        expected = f.read().strip()
    digest = hashlib.sha256(golden.astype(np.uint8).tobytes()).hexdigest()
    assert digest == expected


@pytest.mark.parametrize("pipeline", ["lit", "shadowed"])
def test_app_renders_gltf_scene(tmp_path, pipeline):
    """--scene x.gltf binds the textures beside the file and writes the
    frames the converted folder gives."""
    frames = {}
    for name, scene in (("gltf", SHOWCASE_GLTF), ("bins", SHOWCASE)):
        out = tmp_path / name
        assert app_main(["--scene", scene, "--width", "64", "--height", "48",
                         "--frames", "1", "--out", str(out), "--device",
                         "cpu", "--pipeline", pipeline]) == 0
        frames[name] = read_png(out / "frame_0000.png")
    np.testing.assert_array_equal(frames["gltf"], frames["bins"])
    assert frames["gltf"][..., :3].std(axis=(0, 1)).min() > 5


def test_viewer_runs_off_gltf_scene(monkeypatch):
    """The viewer's --scene takes the glTF too and binds its textures from
    the file's folder."""
    from zrenderer_tpu_torch.app import viewer

    bound = []

    def bind(renderer, md, tex_dir):
        bind_scene_textures(renderer, md, tex_dir)
        bound.append((tex_dir, renderer.texture.num_layers))

    monkeypatch.setattr(viewer, "bind_scene_textures", bind)
    assert viewer.main(["--scene", SHOWCASE_GLTF, "--pipeline", "lit",
                        "--width", "64", "--height", "48", "--frames", "1",
                        "--port", "0", "--fps", "1000",
                        "--device", "cpu"]) == 0
    assert bound == [(SHOWCASE_SRC, 3)]
