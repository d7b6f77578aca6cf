"""Flat raster: prepares, the two CUDA kernels' wrappers, their plain torch
versions, the resolve/unpack, and the frame dispatch.

Counterpart of the flat path of ``zrenderer_tpu/ops/raster_pallas.py``:

* K1, the small-scene binned raster (``rasterize_setup_pallas_small``):
  ``prepare_binned_small`` builds sort-free per-tile lists of the head
  rows; the kernel loops its tile's list with the (z, row id) depth
  tie-break, then sends the clipped-fan rows through the
  superblock -> block -> row hierarchy.  CUDA: ``csrc/raster_small.cu``.
* K3, the hierarchy raster (``rasterize_setup_pallas``):
  ``prepare_raster_inputs`` compacts live rows and builds the block and
  superblock union bboxes; the kernel walks the hierarchy in submission
  order with the strict-less depth test.  CUDA: ``csrc/raster_hier.cu``.

Both produce a packed RGBA8 plane (u32 bits carried in an ``int32``
tensor; alpha 255 sets bit 31) and an f32 depth plane over the padded
(H, W) frame, resolved with one divide per pixel (docs/RASTER_SPEC.md §4).

Each kernel has a plain torch version beside it taking the same prepared
inputs.  ``rasterize_setup_small`` and ``rasterize_setup`` take the plain
version only for CPU tensors; for CUDA tensors they launch the kernel or
raise.  Each kernel-launching function counts its launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from zrenderer_tpu_torch.ops.geometry import (
    F_CB0,
    F_CG0,
    F_CR0,
    F_RW0,
    F_ZA0,
    I_BIAS0,
    I_BIAS1,
    I_BIAS2,
    I_DX0,
    I_DX1,
    I_DX2,
    I_DY0,
    I_DY1,
    I_DY2,
    I_IMAX,
    I_IMIN,
    I_JMAX,
    I_JMIN,
    I_VALID,
    I_X0,
    I_X1,
    I_X2,
    I_Y0,
    I_Y1,
    I_Y2,
    NF32,
    NI32,
    RASTER_BLOCK,
    SUBPIXEL,
    SUPER_BLOCK,
    head_count,
)
from zrenderer_tpu_torch.ops import _build
from zrenderer_tpu_torch.ops import geometry as tg

# Screen tile of both kernels: one CUDA block per tile.  Fixed: the
# prepares' per-tile list granularity and the kernels' thread layout
# (csrc/raster_common.cuh) both depend on it.
TILE_H = 32
TILE_W = 128

# Head-row bound of the sort-free small-scene lists (K1), as in the
# reference's SMALL_BIN_MAX_ROWS; also the kernel's shared-memory list size.
SMALL_BIN_MAX_ROWS = 1024

# Largest setup-row count the ported kernels take (the reference's
# VMEM_RESIDENT_MAX_TRIS).  Above it the reference streams records (K4,
# K5); those kernels are not ported yet.
MAX_RESIDENT_ROWS = 32768

BINNINGS = ("auto", "small", "hierarchy")

_INT_MAX = 2**31 - 1
_ALPHA_BITS = -(1 << 24)  # 0xFF000000 as int32
F32 = torch.float32
I32 = torch.int32


def _pad_rows(tri_i32, tri_f32):
    """Pad setup rows to a RASTER_BLOCK multiple with dead rows."""
    pad = (-tri_i32.shape[0]) % RASTER_BLOCK
    if not pad:
        return tri_i32, tri_f32
    dead = torch.zeros((pad, NI32), dtype=I32, device=tri_i32.device)
    dead[:, I_JMIN] = 1
    dead[:, I_BIAS0:I_BIAS2 + 1] = _INT_MAX
    tri_i32 = torch.cat([tri_i32, dead])
    tri_f32 = torch.cat([
        tri_f32, torch.zeros((pad, NF32), dtype=F32, device=tri_f32.device)
    ])
    return tri_i32, tri_f32


def _check_frame(width: int, height: int):
    if width <= 0 or height <= 0 or width % TILE_W or height % TILE_H:
        raise ValueError(
            f"raster target {width}x{height} must be a positive multiple "
            f"of {TILE_W}x{TILE_H}"
        )


# ---------------------------------------------------------------------------
# Prepares
# ---------------------------------------------------------------------------


def prepare_raster_inputs(tri_i32, tri_f32):
    """K3 prepare: pad to RASTER_BLOCK, stable-compact live rows to the
    front, and build the block/superblock union bboxes.
    Returns (supers, blocks, tri_i32, tri_f32)."""
    tri_i32, tri_f32 = _pad_rows(tri_i32, tri_f32)
    tri_i32, tri_f32 = tg.compact_triangles(tri_i32, tri_f32)
    blocks = tg.block_bounds(tri_i32)
    blocks, supers = tg.super_bounds(blocks)
    return supers, blocks, tri_i32, tri_f32


def prepare_binned_small(tri_i32, tri_f32, width: int, height: int):
    """K1 prepare: sort-free per-tile lists of the head rows.

    Returns (counts (num_tiles,) i32, lists (num_tiles*n_head, 1) i32,
    supers, blocks, hier, tri_f32).  Tile t owns list rows
    [t*n_head, t*n_head + counts[t]), ascending row ids (the rest hold
    n_head).  ``hier`` is the padded setup with every head row's bbox
    emptied, so the phase-2 hierarchy only sees the clipped-fan rows.
    """
    tiles_x = width // TILE_W
    tiles_y = height // TILE_H
    num_tiles = tiles_x * tiles_y
    n_head = head_count(tri_i32.shape[0])
    if n_head > SMALL_BIN_MAX_ROWS:
        raise ValueError(
            f"prepare_binned_small: {n_head} head rows > "
            f"{SMALL_BIN_MAX_ROWS} (use the hierarchy raster)"
        )
    tri_i32, tri_f32 = _pad_rows(tri_i32, tri_f32)
    dev = tri_i32.device

    head = tri_i32[:n_head]
    live = ((head[:, I_VALID] > 0)
            & (head[:, I_JMIN] <= head[:, I_JMAX])
            & (head[:, I_IMIN] <= head[:, I_IMAX]))
    tj0 = head[:, I_JMIN] // TILE_W
    tj1 = head[:, I_JMAX] // TILE_W
    ty0 = head[:, I_IMIN] // TILE_H
    ty1 = head[:, I_IMAX] // TILE_H
    rows = torch.arange(tiles_y, dtype=I32, device=dev)[:, None, None]
    cols = torch.arange(tiles_x, dtype=I32, device=dev)[None, :, None]
    hit = ((rows >= ty0) & (rows <= ty1)
           & (cols >= tj0) & (cols <= tj1) & live)  # (ty, tx, n_head)
    hit = hit.reshape(num_tiles, n_head)
    counts = hit.sum(dim=1, dtype=I32)
    ids = torch.arange(n_head, dtype=I32, device=dev)
    lists = torch.sort(torch.where(hit, ids, n_head), dim=1).values

    hier = tri_i32.clone()
    hier[:n_head, I_JMIN] = 1
    hier[:n_head, I_JMAX] = 0
    hier[:n_head, I_VALID] = 0
    blocks = tg.block_bounds(hier)
    blocks, supers = tg.super_bounds(blocks)
    return (counts, lists.reshape(num_tiles * n_head, 1).to(I32), supers,
            blocks, hier, tri_f32)


# ---------------------------------------------------------------------------
# Plain torch versions of the kernels
# ---------------------------------------------------------------------------
# Tile state lives in (tiles_y, tiles_x, TILE_H, TILE_W) planes; the
# arithmetic is the kernels' own, op for op, so CPU results are the bits
# the CUDA kernels must reproduce.

_LATCHES = (("den", F_RW0), ("nr", F_CR0), ("ng", F_CG0), ("nb", F_CB0))


def _tile_planes(tiles_y: int, tiles_x: int, tie: bool, device):
    shape = (tiles_y, tiles_x, TILE_H, TILE_W)
    planes = {"z": torch.ones(shape, dtype=F32, device=device)}
    if tie:
        planes["tid"] = torch.full(shape, _INT_MAX, dtype=I32, device=device)
    for name, _ in _LATCHES:
        planes[name] = torch.zeros(shape, dtype=F32, device=device)
    half = SUBPIXEL // 2
    ty = torch.arange(tiles_y, dtype=I32, device=device)[:, None, None, None]
    tx = torch.arange(tiles_x, dtype=I32, device=device)[None, :, None, None]
    iy = torch.arange(TILE_H, dtype=I32, device=device)[:, None]
    ix = torch.arange(TILE_W, dtype=I32, device=device)[None, :]
    py = (ty * TILE_H + iy) * SUBPIXEL + half  # (ty, 1, TILE_H, 1)
    px = (tx * TILE_W + ix) * SUBPIXEL + half  # (1, tx, 1, TILE_W)
    return planes, py, px


def _eval_rows(planes, sel, py, px, ri, rf, tid, emask, tie: bool):
    """Coverage, depth test and latch of one row per tile of ``sel``.

    ``ri``/``rf``: setup rows broadcastable over the selected tiles
    ((NI32,)/(NF32,) for one row, (ty, tx, N) for one row per tile);
    ``tid``: the row id(s), an int or a per-tile tensor; ``emask``: a
    per-tile write mask or None.  ``tie`` selects K1's (z, id) test over
    K3's strict less."""
    def ic(c):
        return ri[..., c, None, None]

    def fc(c):
        return rf[..., c, None, None]

    pys = py[sel[0]]
    pxs = px[:, sel[1]]
    e0 = ic(I_DX0) * (pys - ic(I_Y1)) - ic(I_DY0) * (pxs - ic(I_X1))
    e1 = ic(I_DX1) * (pys - ic(I_Y2)) - ic(I_DY1) * (pxs - ic(I_X2))
    e2 = ic(I_DX2) * (pys - ic(I_Y0)) - ic(I_DY2) * (pxs - ic(I_X0))
    cov = (e0 >= ic(I_BIAS0)) & (e1 >= ic(I_BIAS1)) & (e2 >= ic(I_BIAS2))
    ef0 = e0.to(F32)
    ef1 = e1.to(F32)
    ef2 = e2.to(F32)

    def interp(c):
        return (ef0 * fc(c) + ef1 * fc(c + 1)) + ef2 * fc(c + 2)

    z = interp(F_ZA0)
    zb = planes["z"][sel]
    if tie:
        tb = planes["tid"][sel]
        ok = cov & (z >= 0.0) & ((z < zb) | ((z == zb) & (tid < tb)))
    else:
        ok = cov & (z >= 0.0) & (z < zb)
    if emask is not None:
        ok = ok & emask
    planes["z"][sel] = torch.where(ok, z, zb)
    if tie:
        planes["tid"][sel] = torch.where(ok, tid, tb)
    for name, c in _LATCHES:
        planes[name][sel] = torch.where(ok, interp(c), planes[name][sel])


def _scan_rows(planes, py, px, ti, tf, tie: bool):
    """Every row with a non-empty bbox, in row order, over the tiles its
    bbox touches (the kernels' superblock/block skips never drop such a
    row: a row with a non-empty bbox is valid, so it is in both unions)."""
    tiles_y, tiles_x = py.shape[0], px.shape[1]
    bbox = ti[:, [I_JMIN, I_JMAX, I_IMIN, I_IMAX]].cpu()
    rows = torch.nonzero((bbox[:, 0] <= bbox[:, 1])
                         & (bbox[:, 2] <= bbox[:, 3])).flatten().tolist()
    for r in rows:
        jmin, jmax, imin, imax = bbox[r].tolist()
        tx0, tx1 = max(jmin // TILE_W, 0), min(jmax // TILE_W, tiles_x - 1)
        ty0, ty1 = max(imin // TILE_H, 0), min(imax // TILE_H, tiles_y - 1)
        if tx0 > tx1 or ty0 > ty1:
            continue
        sel = (slice(ty0, ty1 + 1), slice(tx0, tx1 + 1))
        _eval_rows(planes, sel, py, px, ti[r], tf[r], r, None, tie)


def _resolve_planes(planes):
    """One divide per pixel, RGBA8 packed into int32 bits; returns
    (packed (H, W) i32, depth (H, W) f32)."""
    d = planes["den"]
    covered = d > 0
    inv = torch.reciprocal(torch.where(covered, d, 1.0))

    def chan(numer):
        c = torch.clamp(torch.where(covered, numer * inv, 0.0), 0.0, 1.0)
        return torch.floor(c * 255.0 + 0.5).to(I32)

    packed = (chan(planes["nr"]) | (chan(planes["ng"]) << 8)
              | (chan(planes["nb"]) << 16) | _ALPHA_BITS)
    ty, tx = packed.shape[:2]

    def frame(p):
        return p.permute(0, 2, 1, 3).reshape(ty * TILE_H, tx * TILE_W)

    return frame(packed).contiguous(), frame(planes["z"]).contiguous()


def raster_small_plain(counts, lists, supers, blocks, ti, tf,
                       width: int, height: int):
    """Plain torch K1 over ``prepare_binned_small``'s outputs: phase 1
    steps the list position k over max(counts) for all tiles at once,
    phase 2 runs the rows left in ``ti`` (the hierarchy's rows)."""
    del supers, blocks  # skip tables only; _scan_rows visits the same rows
    _check_frame(width, height)
    tiles_y, tiles_x = height // TILE_H, width // TILE_W
    num_tiles = tiles_y * tiles_x
    planes, py, px = _tile_planes(tiles_y, tiles_x, True, ti.device)
    lists2d = lists.reshape(num_tiles, -1)
    everything = (slice(None), slice(None))
    for k in range(int(counts.max().item())):
        rid = lists2d[:, k].long()
        ri = ti[rid].reshape(tiles_y, tiles_x, NI32)
        rf = tf[rid].reshape(tiles_y, tiles_x, NF32)
        tid = lists2d[:, k].reshape(tiles_y, tiles_x, 1, 1)
        active = (counts > k).reshape(tiles_y, tiles_x, 1, 1)
        _eval_rows(planes, everything, py, px, ri, rf, tid, active, True)
    _scan_rows(planes, py, px, ti, tf, tie=True)
    return _resolve_planes(planes)


def raster_hier_plain(supers, blocks, ti, tf, width: int, height: int):
    """Plain torch K3 over ``prepare_raster_inputs``' outputs: rows in
    submission order, strict-less depth test, per-tile bbox masks."""
    del supers, blocks  # skip tables only; _scan_rows visits the same rows
    _check_frame(width, height)
    planes, py, px = _tile_planes(height // TILE_H, width // TILE_W, False,
                                  ti.device)
    _scan_rows(planes, py, px, ti, tf, tie=False)
    return _resolve_planes(planes)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/raster_small.cu, csrc/raster_hier.cu)
# ---------------------------------------------------------------------------


def _require_cuda(device, **tensors):
    """Check the kernels' input contract; raise on anything else."""
    want = {"counts": I32, "lists": I32, "supers": I32, "blocks": I32,
            "ti": I32, "tf": F32}
    for name, t in tensors.items():
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: CUDA tensor on {device} expected, "
                             f"got {t.device}")
        if t.dtype != want[name]:
            raise TypeError(f"{name}: {want[name]} expected, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: contiguous tensor expected")
    ti, tf = tensors["ti"], tensors["tf"]
    blocks, supers = tensors["blocks"], tensors["supers"]
    if ti.ndim != 2 or ti.shape[1] != NI32:
        raise ValueError(f"ti: (R, {NI32}) expected, got {tuple(ti.shape)}")
    rows = ti.shape[0]
    if tuple(tf.shape) != (rows, NF32):
        raise ValueError(f"tf: ({rows}, {NF32}) expected")
    if rows % RASTER_BLOCK or rows > MAX_RESIDENT_ROWS:
        raise ValueError(f"ti: {rows} rows; need a multiple of "
                         f"{RASTER_BLOCK}, at most {MAX_RESIDENT_ROWS}")
    if (blocks.shape[1:] != (8,) or supers.shape[1:] != (8,)
            or blocks.shape[0] != supers.shape[0] * SUPER_BLOCK
            or blocks.shape[0] * RASTER_BLOCK < rows):
        raise ValueError("blocks/supers do not match the setup rows")


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        msg = _build.load_library().zr_error_string(err).decode()
        raise RuntimeError(
            f"{fn.__name__} launch failed: CUDA error {err} ({msg})")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def raster_small_kernel(counts, lists, supers, blocks, ti, tf,
                        width: int, height: int):
    """Launch K1 (``csrc/raster_small.cu``) on the current stream."""
    _check_frame(width, height)
    dev = ti.device
    _require_cuda(dev, counts=counts, lists=lists, supers=supers,
                  blocks=blocks, ti=ti, tf=tf)
    num_tiles = (height // TILE_H) * (width // TILE_W)
    if counts.shape != (num_tiles,) or lists.numel() % num_tiles:
        raise ValueError("counts/lists do not match the tile grid")
    n_head = lists.numel() // num_tiles
    if n_head > SMALL_BIN_MAX_ROWS or n_head > ti.shape[0]:
        raise ValueError(f"n_head {n_head} > {SMALL_BIN_MAX_ROWS} or rows")
    lib = _build.load_library()
    color = torch.empty((height, width), dtype=I32, device=dev)
    depth = torch.empty((height, width), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.zr_raster_small, _ptr(counts), _ptr(lists), n_head,
                _ptr(supers), supers.shape[0], _ptr(blocks), _ptr(ti),
                _ptr(tf), _ptr(color), _ptr(depth), height, width,
                ctypes.c_void_p(stream))
    raster_small_kernel.launches += 1
    return color, depth


def raster_hier_kernel(supers, blocks, ti, tf, width: int, height: int):
    """Launch K3 (``csrc/raster_hier.cu``) on the current stream."""
    _check_frame(width, height)
    dev = ti.device
    _require_cuda(dev, supers=supers, blocks=blocks, ti=ti, tf=tf)
    lib = _build.load_library()
    color = torch.empty((height, width), dtype=I32, device=dev)
    depth = torch.empty((height, width), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(lib.zr_raster_hier, _ptr(supers), supers.shape[0],
                _ptr(blocks), _ptr(ti), _ptr(tf), _ptr(color), _ptr(depth),
                height, width, ctypes.c_void_p(stream))
    raster_hier_kernel.launches += 1
    return color, depth


raster_small_kernel.launches = 0
raster_hier_kernel.launches = 0


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def rasterize_setup_small(tri_i32, tri_f32, width: int, height: int):
    """K1 wrapper: ``prepare_binned_small`` then the kernel (CUDA tensors)
    or its plain version (CPU tensors).  Returns (packed i32, depth f32)
    over the (height, width) padded frame."""
    _check_frame(width, height)
    prepared = prepare_binned_small(tri_i32, tri_f32, width, height)
    if _on_cpu(tri_i32):
        return raster_small_plain(*prepared, width, height)
    return raster_small_kernel(*prepared, width, height)


def rasterize_setup(tri_i32, tri_f32, width: int, height: int):
    """K3 wrapper: ``prepare_raster_inputs`` then the kernel (CUDA tensors)
    or its plain version (CPU tensors)."""
    _check_frame(width, height)
    prepared = prepare_raster_inputs(tri_i32, tri_f32)
    if _on_cpu(tri_i32):
        return raster_hier_plain(*prepared, width, height)
    return raster_hier_kernel(*prepared, width, height)


def unpack_rgba8(packed):
    """(H, W) i32 packed RGBA8 -> (H, W, 4) u8 (channel order r, g, b, a)."""
    return torch.stack(
        [(packed >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1
    ).to(torch.uint8)


def select_raster(binning: str, rows: int):
    """The dispatch of ``render_frame_pallas``, for the ported kernels:
    returns ``rasterize_setup_small`` (K1) or ``rasterize_setup`` (K3)."""
    if binning == "tile_lists":
        raise NotImplementedError(
            "binning='tile_lists' needs the global pair-list kernels "
            "(K6, and K4 above 32768 rows), not ported yet (ROADMAP.md "
            "Queue 2)"
        )
    if binning not in BINNINGS:
        raise ValueError(f"unknown binning {binning!r}; one of {BINNINGS}")
    if rows > MAX_RESIDENT_ROWS:
        raise NotImplementedError(
            f"{rows} setup rows > {MAX_RESIDENT_ROWS}: needs the "
            "record-streaming kernel (K4) or the streamed hierarchy (K5), "
            "not ported yet (ROADMAP.md Queue 2)"
        )
    if binning == "small" or (
            binning == "auto" and head_count(rows) <= SMALL_BIN_MAX_ROWS):
        return rasterize_setup_small
    return rasterize_setup


def render_frame(ccols, tri_node, matrices, width: int, height: int,
                 pad_height: int, pad_width: int, binning: str = "auto",
                 raw_packed: bool = False):
    """Full flat frame: column geometry at the true (width, height)
    viewport, then the raster kernel over the padded target.

    Returns (packed (height, width) i32, depth f32), cropped; with
    ``raw_packed`` the padded planes as the kernel wrote them.
    """
    tri_i32, tri_f32 = tg.geometry_pipeline_cols(
        ccols, tri_node, matrices, width, height)
    raster = select_raster(binning, tri_i32.shape[0])
    color, depth = raster(tri_i32, tri_f32, pad_width, pad_height)
    if raw_packed:
        return color, depth
    return color[:height, :width], depth[:height, :width]
