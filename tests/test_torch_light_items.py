"""K7's work items (zrenderer_tpu_torch/csrc/light_tiled.cu): each tile's
covered pixels, in row-major order, cut into items of at most
``ITEM_PIXELS``, one block each of an upper-bound grid of tiles x
ceil(4096 / ITEM_PIXELS) blocks.  Through ``light_work_items``, the CPU
mirror of the cut in zrenderer_tpu_torch/ops/light_kernel.py:

* the items cover each covered pixel of the frame exactly once, none
  holds more than the item size or a pixel of another tile, and every
  item fits the grid;
* the plain K7 evaluated item by item (each item's pixels alone in the
  mask) equals ``tiled_light_plain`` over the whole mask bit for bit;
* the constants the kernel is compiled with equal their mirrors in
  ``light_kernel``.

``tiled_light_plain`` is held against the reference's Pallas kernel in
interpret mode by test_torch_deferred_interpret.py, and the CUDA kernel
against the plain version on the card by chip_smoke.py (phase 4l).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zrenderer_tpu_torch.ops import light_kernel as tl

torch.set_num_threads(1)


def _mask(name, h, w, p):
    """A coverage mask (H, W) int32 of a shape the cut must handle; ``p``
    is the item size."""
    if name == "random":
        rng = np.random.default_rng(0)
        return (rng.random((h, w)) < 0.47).astype(np.int32)
    if name == "checkerboard":
        return ((np.arange(h)[:, None] + np.arange(w)[None, :])
                % 2).astype(np.int32)
    mask = np.full((h, w), int(name == "full"), np.int32)
    if name == "one_pixel":
        mask[5, 70] = 1  # one covered pixel in its tile
    if name == "exact_p_and_p_plus_1":
        # Exactly p covered pixels (row-major in the tile) in tile 0, p + 1
        # in the tile at rows 32-63, columns 128-255.
        for (r, c), n in (((0, 0), p), ((32, 128), p + 1)):
            t = np.zeros(tl.TILE_PIX, np.int32)
            t[:n] = 1
            mask[r:r + tl.TILE_H, c:c + tl.TILE_W] = t.reshape(tl.TILE_H,
                                                               tl.TILE_W)
    return mask


def _tile_major(h, w):
    """Frame index -> its tile and its row-major rank in the tile."""
    ty, tx = h // tl.TILE_H, w // tl.TILE_W
    r, c = np.divmod(np.arange(h * w), w)
    tile = (r // tl.TILE_H) * tx + c // tl.TILE_W
    pos = (r % tl.TILE_H) * tl.TILE_W + c % tl.TILE_W
    return tile, pos, ty * tx


@pytest.mark.parametrize("p", [1, 256, 700, 4096])
@pytest.mark.parametrize("mask_name", ["random", "checkerboard", "full",
                                       "empty", "one_pixel",
                                       "exact_p_and_p_plus_1"])
def test_items_cover_each_covered_pixel_once(mask_name, p):
    h, w = 64, 256
    mask = _mask(mask_name, h, w, min(p, tl.TILE_PIX - 1))
    items, grid = tl.light_work_items(torch.from_numpy(mask), p)
    tile_of, pos_of, tiles = _tile_major(h, w)
    per_tile = -(-tl.TILE_PIX // p)
    assert grid == tiles * per_tile
    pix = items[:, 2].numpy()
    covered = np.flatnonzero(mask.reshape(-1) > 0)
    # Each covered pixel exactly once, nothing else.
    assert np.array_equal(np.sort(pix), covered)
    assert np.unique(pix).size == pix.size
    # In its own tile, the item inside the grid's share of the tile.
    assert np.array_equal(items[:, 0].numpy(), tile_of[pix])
    assert ((items[:, 1] >= 0) & (items[:, 1] < per_tile)).all()
    # Tile by tile, in row-major order within the tile, items of at most p
    # consecutive pixels, full but the last.
    order = items[:, 0].numpy() * tl.TILE_PIX + pos_of[pix]
    assert (np.diff(order) > 0).all()
    for t in np.unique(items[:, 0].numpy()):
        mine = items[items[:, 0] == t]
        sizes = torch.bincount(mine[:, 1]).numpy()
        assert (sizes[:-1] == p).all() and 1 <= sizes[-1] <= p
    if mask_name == "exact_p_and_p_plus_1" and p < tl.TILE_PIX:
        second = w // tl.TILE_W + 1  # the tile at rows 32-63, cols 128-255
        counts = np.bincount(items[:, 0].numpy(), minlength=tiles)
        assert counts[0] == p and counts[second] == p + 1
        assert int(items[items[:, 0] == 0][-1, 1]) == 0  # one full item
        last = items[items[:, 0] == second][-1]
        assert int(last[1]) == 1  # the (p + 1)-th pixel opens an item


def _inputs(seed, h, w, mask, lights=64, planes=torch.float32,
            full_height=None, spread=6.0):
    """K7's inputs from seeded random planes and lights, seen through a
    camera at (0, 2, 8) looking down -z."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    vp = np.array([[1.2, 0, 0, 0], [0, 2.1, 0, 0], [0, 0, -1.0, -1.0],
                   [0, -4.2, 7.8, 8.0]], np.float32)
    pos = rng.uniform([-spread, 0.5, -spread], [spread, 6, spread],
                      (lights, 3)).astype(np.float32)
    col = rng.uniform(0.1, 1.0, (lights, 3)).astype(np.float32) * 0.02
    return tl.light_inputs(
        t(rng.random((h, w, 3), dtype=np.float32)),
        t(rng.standard_normal((h, w, 3)).astype(np.float32)),
        t(rng.uniform([-4, 0, -4], [4, 3, 4], (h, w, 3)).astype(np.float32)),
        t(mask > 0), t(np.float32([0, 2, 8])), t(pos), t(col), t(vp),
        roughness=t(rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)),
        metallic=t(rng.random((h, w), dtype=np.float32)),
        plane_dtype=planes, full_height=full_height)


def items_plain(planes, mask, bounds, lights, consts, row_offset=0,
                item_pixels=tl.ITEM_PIXELS):
    """The plain K7 item by item: each item's pixels lit alone (the mask
    cleared elsewhere), the rest of the frame 0."""
    h, w = mask.shape
    items, _ = tl.light_work_items(mask, item_pixels)
    out = torch.zeros((3, h * w), dtype=torch.float32)
    keys = items[:, 0] * tl.TILE_PIX + items[:, 1]
    for key in torch.unique(keys).tolist():
        pix = items[keys == key][:, 2]
        assert 0 < pix.numel() <= item_pixels
        alone = torch.zeros(h * w, dtype=mask.dtype)
        alone[pix] = mask.reshape(-1)[pix]
        lit = tl.tiled_light_plain(planes, alone.reshape(h, w), bounds,
                                   lights, consts, row_offset)
        out[:, pix] = lit.reshape(3, -1)[:, pix]
    return out.reshape(3, h, w)


def test_plain_k7_item_by_item_equals_plain():
    h, w, p = 64, 256, 256
    mask = _mask("random", h, w, p)
    inputs = _inputs(1, h, w, mask)
    ref = tl.tiled_light_plain(*inputs)
    got = items_plain(*inputs, item_pixels=p)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.numpy().view(np.uint32))
    covered = torch.from_numpy(mask > 0)
    assert (ref[:, ~covered] == 0).all()
    assert (ref[:, covered] != 0).any()
    hits = tl.tile_light_hits(inputs[2], h // tl.TILE_H, w // tl.TILE_W)
    assert 0 < int(hits.sum()) < hits.numel()  # culled, not empty


CU_SOURCE = (Path(tl.__file__).resolve().parent.parent / "csrc"
             / "light_tiled.cu")


@pytest.mark.parametrize("name", ["TILE_H", "TILE_W", "MAX_LIGHTS",
                                  "ITEM_PIXELS"])
def test_kernel_constants_equal_their_mirrors(name):
    """csrc/light_tiled.cu's constexpr ints, which the kernel is compiled
    with, against the Python constants that the wrappers, the plain
    version and the cut use."""
    found = re.findall(rf"constexpr int {name} = (\d+);",
                       CU_SOURCE.read_text())
    assert len(found) == 1
    assert int(found[0]) == getattr(tl, name)
