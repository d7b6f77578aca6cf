"""Sharded frames: triangle-shard geometry + one screen band per rank.

Counterpart of ``zrenderer_tpu/parallel/tiles.py`` on ``torch.distributed``
(the reference's shard_map steps become one rank's step under a process
group):

* **Geometry parallelism**: the triangle list is split into contiguous
  shards, one per rank; each rank runs the indexed geometry stage on its
  shard only, then one ``all_gather_into_tensor`` of the setup rows and a
  static permutation (``canonical_order_perm``) give every rank the rows
  in the single-device order, so depth ties resolve as on one device.
* **Screen bands**: rank r rasterizes rows [r * band_h, (r + 1) * band_h)
  with a band kernel (``ops/raster.py``): K3b up to 32768 gathered rows,
  K9 above them or with ``tile_lists``, K9g for the deferred G-buffer,
  K9d with ``binning="dist"``, where each rank bins its own shard and one
  ``all_to_all_single`` sends every band owner its records.

Each frame is one sequence of stages (``shard``, ``setup``, the setup
gather, for ``dist`` the all-to-all, the band stage) run for the ranks of
an exchange: ``GroupExchange`` is one rank under a process group, its
collectives ``torch.distributed`` calls; ``InTurnExchange`` is every rank
in one process, each collective the concatenation it delivers (one card
rendering the bands in turn: ``bands_in_turn`` and the others below).
CPU tensors take the plain versions of the kernels, CUDA tensors the
kernels.  A frame's height must split into whole 32-row tiles per band:
1080 never does, so sharded frames run at a tile-aligned height (1088
for 2 bands, 1024 for 4).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from zrenderer_tpu_torch.device import resolve_device
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.ops import shading, taa
from zrenderer_tpu_torch.ops.light_kernel import tiled_deferred_lighting

BINNINGS = ("auto", "hierarchy", "tile_lists", "dist")
F32 = torch.float32
I32 = torch.int32


def canonical_order_perm(n_shards: int, shard_tris: int) -> torch.Tensor:
    """Static permutation restoring the canonical row order after the
    gather of per-shard capped-layout setup rows: every shard's slot-0 rows
    in shard order, then the subset fans slot-major across shards (slot j
    of shard 0's subset, slot j of shard 1's, ...).  (n_rows,) int32."""
    cap = tg.clip_cap_for(shard_tris)
    shard_rows = shard_tris + tg.FAN_SLOTS * cap
    heads = np.arange(n_shards * shard_tris)
    head_rows = (heads // shard_tris) * shard_rows + heads % shard_tris
    fans = np.arange(n_shards * tg.FAN_SLOTS * cap)
    j = fans // (n_shards * cap)  # fan slot
    w = fans % (n_shards * cap)
    fan_rows = (w // cap) * shard_rows + shard_tris + j * cap + w % cap
    return torch.from_numpy(np.concatenate([head_rows, fan_rows]).astype(
        np.int32))


def _check_split(height: int, n_bands: int):
    if n_bands <= 0 or height % (tr.TILE_H * n_bands):
        raise ValueError(f"height {height} does not split into {n_bands} "
                         f"bands of whole {tr.TILE_H}-row tiles")


def _check_binning(binning: str, allowed=BINNINGS):
    if binning not in allowed:
        raise ValueError(f"unknown binning {binning!r}; one of {allowed}")


def _shard_tris(tri_count: int, n_shards: int) -> int:
    if tri_count % n_shards:
        raise ValueError(f"{tri_count} triangles do not split into "
                         f"{n_shards} shards")
    return tri_count // n_shards


def _put(x, dev, dtype=None):
    return torch.as_tensor(x, dtype=dtype).to(dev).contiguous()


# ---------------------------------------------------------------------------
# The band stages (one rank's raster after the collectives)
# ---------------------------------------------------------------------------


def band_raster(ti, tf, width: int, height: int, n_bands: int, band: int,
                n_head: int, binning: str = "auto"):
    """Rasterize band ``band`` of ``n_bands`` from the gathered canonical
    rows: K9 for ``tile_lists`` and for ``auto`` above 32768 rows (the
    band-local prepare, ``n_head`` head rows, ``band_pair_budget``), K3b
    otherwise.  Returns (rgba (band_h, W, 4) u8, depth (band_h, W) f32)."""
    band_h = height // n_bands
    row0 = band * band_h
    if binning == "tile_lists" or (
            binning == "auto" and ti.shape[0] > tr.MAX_RESIDENT_ROWS):
        color, depth = tr.rasterize_setup_binned_band(
            ti, tf, width, height, band_h, row0, n_head=n_head,
            pair_budget=tr.band_pair_budget(n_bands))
    else:
        color, depth = tr.rasterize_setup_band(ti, tf, width, band_h, row0)
    return tr.unpack_rgba8(color), depth


def dist_band_raster(ti, tf, received, width: int, height: int,
                     n_bands: int, band: int):
    """K9d over band ``band``: ``received`` = (listed, rec_i, rec_f, offs)
    as ``dist_exchange`` delivers them, stacked by source shard."""
    band_h = height // n_bands
    color, depth = tr.rasterize_setup_binned_band_dist(
        ti, tf, *received, width, height, band_h, band * band_h)
    return tr.unpack_rgba8(color), depth


def deferred_band(ti, tf, width: int, height: int, n_bands: int, band: int,
                  n_head: int, inv_view_proj, cam_pos, light_pos,
                  light_color, view_proj):
    """The deferred band: K9g's 13 planes, the world position of the
    band's global rows, K7 over the band's tiles (``row_offset``, bounds
    at the full frame), emissive, tonemap.  Returns (rgba, depth)."""
    band_h = height // n_bands
    row0 = band * band_h
    (packed, depth, _, _, nx, ny, nz, met, rgh, emr, emg, emb,
     _) = tr.rasterize_gbuffer_binned_band(
        ti, tf, width, height, band_h, row0, n_head=n_head,
        pair_budget=tr.band_pair_budget(n_bands))
    rgba = tr.unpack_rgba8(packed)
    covered = depth < 1.0
    albedo = rgba[..., :3].to(F32) / shading._const(depth, 255.0)
    normal = torch.stack([nx, ny, nz], dim=-1)
    world = shading.reconstruct_world_pos(depth, inv_view_proj, width,
                                          height, row_offset=row0)
    rgb = tiled_deferred_lighting(
        albedo, normal, world, covered, cam_pos, light_pos, light_color,
        view_proj, roughness=rgh, metallic=met, row_offset=row0,
        full_height=height)
    rgb = rgb + torch.stack([emr, emg, emb], dim=-1)
    return shading.tonemap_and_pack(rgb, covered), depth


def taa_resolve_band(history, rgba, above, below, alpha: float = 0.1):
    """``taa_resolve`` of one band: ``above``/``below`` are the (W, 4)
    rows next to the band in the full frame, wrapping at its top and
    bottom as the resolve's 3x3 clamp does.  Returns (new history
    (band_h, W, 3) int32, resolved (band_h, W, 4) u8)."""
    frame = torch.cat([above[None], rgba, below[None]])
    pad = torch.zeros_like(history[:1])
    new, res = taa.taa_resolve(torch.cat([pad, history, pad]), frame, alpha)
    return new[1:-1].contiguous(), res[1:-1].contiguous()


# ---------------------------------------------------------------------------
# The exchanges: whose ranks a frame's stages run for, and its collectives
# ---------------------------------------------------------------------------


def all_gather(group, t, n: int):
    """The n ranks' ``t`` concatenated along dim 0, in rank order."""
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


class GroupExchange:
    """One rank of ``group``: ``ranks`` is this rank alone, and each
    collective is one ``torch.distributed`` call."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.ranks = (dist.get_rank(group),)

    def gather(self, parts):
        """[this rank's t] -> every rank's t along dim 0, in rank order."""
        (t,) = parts
        return all_gather(self.group, t, self.n)

    def all_to_all(self, parts):
        """[this rank's (n, ...) sends, piece b for rank b] -> [the n
        pieces sent to this rank, stacked by source]."""
        (t,) = parts
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t.contiguous(), group=self.group)
        return [out]


class InTurnExchange:
    """Every rank of an n-rank frame in one process, one after another:
    each collective is the concatenation it delivers."""

    def __init__(self, n: int):
        self.n = n
        self.ranks = tuple(range(n))

    def gather(self, parts):
        return torch.cat(parts)

    def all_to_all(self, parts):
        return [torch.stack([p[b] for p in parts]) for b in range(self.n)]


# ---------------------------------------------------------------------------
# The stages before the band raster
# ---------------------------------------------------------------------------


def shard(n: int, rank: int, dev, positions, attrs, tri_vidx, matrices,
          node_ids, normal_mats=None, materials=None):
    """Rank ``rank``'s inputs on ``dev``: its contiguous shard of
    ``tri_vidx``, the other buffers whole.  With ``normal_mats`` or
    ``materials`` also those: the shard's rows of a per-triangle material
    table, or a per-draw table expanded to the shard's triangles, so every
    shard's table is per triangle whatever the draw count."""
    s = _shard_tris(len(tri_vidx), n)
    part = slice(rank * s, (rank + 1) * s)
    vidx = _put(tri_vidx[part], dev, I32)
    nodes = _put(node_ids, dev, I32)
    out = (_put(positions, dev, F32), _put(attrs, dev, F32), vidx,
           _put(matrices, dev, F32), nodes)
    if normal_mats is None and materials is None:
        return out
    if materials is not None:
        materials = _put(materials, dev, F32)
        materials = (materials[part] if len(materials) == len(tri_vidx)
                     else materials[nodes[vidx[:, 0].long()].long()])
    return (*out, None if normal_mats is None
            else _put(normal_mats, dev, F32),
            None if materials is None else materials.contiguous())


def setup(shard_args, width: int, height: int):
    """One rank's geometry stage on ``shard``'s output: the indexed
    pipeline over its triangle shard, its capped-layout (ti, tf)."""
    pos, attrs, vidx, mats, nodes, *lit = shard_args
    kw = dict(zip(("normal_matrices", "material_table"), lit))
    return tg.geometry_pipeline(pos, attrs, vidx, mats, nodes, width, height,
                                **kw)


def gather_rows(ex, locals_, shard_tris: int):
    """The setup collective: every shard's rows gathered (shard-major),
    then ``canonical_order_perm`` to the single-device row order."""
    ti = ex.gather([t for t, _ in locals_])
    tf = ex.gather([f for _, f in locals_])
    perm = canonical_order_perm(ex.n, shard_tris).to(ti.device).long()
    return ti[perm].contiguous(), tf[perm].contiguous()


def dist_exchange(ex, locals_, width: int, height: int, shard_tris: int,
                  slab_records: int | None = None):
    """``binning="dist"``'s collective: each rank bins its own shard
    (``prepare_binned_dist_local``) and one all-to-all of each part sends
    band b's slab, spans and listed rows to its owner.  Returns, for each
    of ``ex.ranks``, (listed (n * shard_tris,) bool, rec_i, rec_f, offs)
    stacked by source."""
    sends = [tr.prepare_binned_dist_local(t, f, width, height, ex.n, r,
                                          shard_tris, slab_records)
             for r, (t, f) in zip(ex.ranks, locals_)]
    listed = ex.all_to_all([x[3].to(I32) for x in sends])
    parts = [ex.all_to_all([x[k] for x in sends]) for k in range(3)]
    return [(lst.reshape(-1) > 0, *rest)
            for lst, *rest in zip(listed, *parts)]


# ---------------------------------------------------------------------------
# The frames, for the ranks of an exchange
# ---------------------------------------------------------------------------


def _flat_bands(ex, shards, width: int, height: int, n_bands: int,
                binning: str):
    """The flat frame: rank r's band is r % n_bands."""
    s = shards[0][2].shape[0]
    locals_ = [setup(a, width, height) for a in shards]
    ti, tf = gather_rows(ex, locals_, s)
    if binning == "dist":
        return [dist_band_raster(ti, tf, rec, width, height, n_bands, r)
                for r, rec in zip(ex.ranks, dist_exchange(
                    ex, locals_, width, height, s))]
    return [band_raster(ti, tf, width, height, n_bands, r % n_bands,
                        ex.n * s, binning) for r in ex.ranks]


def _deferred_bands(ex, shards, consts, width: int, height: int):
    s = shards[0][2].shape[0]
    ti, tf = gather_rows(ex, [setup(a, width, height) for a in shards], s)
    return [deferred_band(ti, tf, width, height, ex.n, r, ex.n * s, *consts)
            for r in ex.ranks]


def _taa_bands(ex, rgbas, histories, alpha: float):
    """The resolve of each band of ``ex.ranks``: one gather of every
    band's first and last rows gives each band the row above it and the
    row below it, wrapping at the frame's top and bottom."""
    edges = ex.gather([torch.stack([b[0], b[-1]]) for b in rgbas])
    edges = edges.reshape(ex.n, 2, *rgbas[0].shape[1:])
    out = []
    for r, rgba, hist in zip(ex.ranks, rgbas, histories):
        if hist is None:
            hist = taa.taa_init_history(rgba)
        out.append(taa_resolve_band(hist, rgba, edges[(r - 1) % ex.n, 1],
                                    edges[(r + 1) % ex.n, 0], alpha))
    return out


# ---------------------------------------------------------------------------
# One rank's step under a process group
# ---------------------------------------------------------------------------


def make_sharded_frame(group, width: int, height: int, binning: str = "auto",
                       device="cuda"):
    """The sharded flat frame for the ranks of ``group``: rank r sets up
    triangle shard r and rasterizes band r.

    Returns (frame_fn, shard_inputs): ``shard_inputs(positions, attrs,
    tri_vidx, matrices, node_ids)`` puts this rank's triangle shard and
    the whole other buffers on ``device``; ``frame_fn`` of those gives
    this rank's band, (rgba (band_h, W, 4) u8, depth (band_h, W) f32).
    ``binning``: "auto" (K9 above 32768 gathered rows, K3b below),
    "hierarchy" (K3b), "tile_lists" (K9) or "dist" (K9d: each rank bins
    its own shard, one all-to-all of slabs, spans and listed rows)."""
    ex = GroupExchange(group)
    _check_split(height, ex.n)
    _check_binning(binning)
    dev = resolve_device(device)

    def frame_fn(*shard_args):
        return _flat_bands(ex, [shard_args], width, height, ex.n,
                           binning)[0]

    def shard_inputs(*inputs):
        return shard(ex.n, ex.ranks[0], dev, *inputs)

    return frame_fn, shard_inputs


def make_sharded_frame_2d(group, n_geom: int, width: int, height: int,
                          binning: str = "auto", device="cuda"):
    """The geom x tiles grid over the ranks of ``group``, geom-major: rank
    r sets up triangle shard r (of n_geom * n_tiles) and rasterizes band
    r % n_tiles, each band rendered by the n_geom ranks of its tiles
    coordinate.  Returns (frame_fn, shard_inputs) as
    ``make_sharded_frame``; ``binning`` is "auto", "hierarchy" or
    "tile_lists"."""
    ex = GroupExchange(group)
    if n_geom <= 0 or ex.n % n_geom:
        raise ValueError(f"{ex.n} ranks do not form a {n_geom} x n grid")
    n_tiles = ex.n // n_geom
    _check_split(height, n_tiles)
    _check_binning(binning, BINNINGS[:3])
    dev = resolve_device(device)

    def frame_fn(*shard_args):
        return _flat_bands(ex, [shard_args], width, height, n_tiles,
                           binning)[0]

    def shard_inputs(*inputs):
        return shard(ex.n, ex.ranks[0], dev, *inputs)

    return frame_fn, shard_inputs


def make_sharded_deferred_frame(group, width: int, height: int,
                                device="cuda"):
    """The sharded deferred frame: triangle-shard geometry with normals
    and material constants, then per band K9g, the world position, K7 with
    the band's row offset, emissive and tonemap.

    Returns (frame_fn, shard_inputs): ``shard_inputs(positions, attrs,
    tri_vidx, matrices, node_ids, normal_mats, materials, inv_view_proj,
    cam_pos, light_pos, light_color, view_proj)`` puts this rank's inputs
    on ``device`` (the material table, per triangle or per draw, as
    ``shard`` splits it); ``frame_fn`` of those gives this rank's (rgba
    (band_h, W, 4) u8, depth (band_h, W) f32)."""
    ex = GroupExchange(group)
    _check_split(height, ex.n)
    dev = resolve_device(device)

    def frame_fn(*args):
        return _deferred_bands(ex, [args[:7]], args[7:], width, height)[0]

    def shard_inputs(*inputs):
        return (*shard(ex.n, ex.ranks[0], dev, *inputs[:7]),
                *(_put(x, dev, F32) for x in inputs[7:]))

    return frame_fn, shard_inputs


def make_sharded_taa_frame(group, width: int, height: int,
                           alpha: float = 0.1, binning: str = "auto",
                           device="cuda"):
    """BASELINE config 4 sharded: ``make_sharded_frame``, then the TAA
    resolve on this rank's band, its 3x3 clamp fed by one halo row from
    each ring neighbour (one all-gather of every band's first and last
    rows; the resolve wraps at the frame's top and bottom).

    Returns (taa_frame, shard_inputs): ``taa_frame(positions, attrs,
    tri_vidx_shard, matrices, node_ids, history)`` -> (resolved
    (band_h, W, 4) u8, depth, new history (band_h, W, 3) int32); history
    None starts from this frame (``taa_init_history``).  The per-frame
    jitter enters through ``matrices``."""
    frame_fn, shard_inputs = make_sharded_frame(group, width, height,
                                                binning, device)
    ex = GroupExchange(group)
    taa._blend_weight(alpha)  # raise now on an alpha that resolves to 0

    def taa_frame(positions, attrs, tri_vidx_shard, matrices, node_ids,
                  history=None):
        rgba, depth = frame_fn(positions, attrs, tri_vidx_shard, matrices,
                               node_ids)
        (new_hist, resolved), = _taa_bands(ex, [rgba], [history], alpha)
        return resolved, depth, new_hist

    return taa_frame, shard_inputs


# ---------------------------------------------------------------------------
# Every rank's step in one process (one card, the bands in turn)
# ---------------------------------------------------------------------------


def shards_in_turn(n: int, *inputs):
    """Every rank's ``shard`` of ``inputs`` (torch tensors), on their
    device."""
    return [shard(n, r, inputs[0].device, *inputs) for r in range(n)]


def setups_in_turn(n: int, positions, attrs, tri_vidx, matrices, node_ids,
                   width: int, height: int, normal_matrices=None,
                   material_table=None):
    """Every shard's setup rows and the gathered canonical rows: (locals_,
    ti, tf, shard_tris)."""
    shards = shards_in_turn(n, positions, attrs, tri_vidx, matrices,
                            node_ids, normal_matrices, material_table)
    s = shards[0][2].shape[0]
    locals_ = [setup(a, width, height) for a in shards]
    return (locals_, *gather_rows(InTurnExchange(n), locals_, s), s)


def bands_in_turn(n: int, width: int, height: int, positions, attrs,
                  tri_vidx, matrices, node_ids, binning: str = "auto"):
    """``make_sharded_frame``'s n ranks one after another on the inputs'
    device.  Returns the n bands' (rgba, depth), in band order."""
    _check_split(height, n)
    _check_binning(binning)
    return _flat_bands(InTurnExchange(n), shards_in_turn(
        n, positions, attrs, tri_vidx, matrices, node_ids), width, height, n,
        binning)


def deferred_bands_in_turn(n: int, width: int, height: int, *inputs):
    """``make_sharded_deferred_frame``'s n ranks in turn on the inputs'
    device, ``inputs`` as its ``shard_inputs`` takes them.  Returns the n
    bands' (rgba, depth)."""
    _check_split(height, n)
    return _deferred_bands(InTurnExchange(n), shards_in_turn(n, *inputs[:7]),
                           inputs[7:], width, height)


def taa_bands_in_turn(bands, histories, alpha: float = 0.1):
    """``make_sharded_taa_frame``'s resolve over the n bands' rgba in
    band order, with their histories (None: start from the bands).
    Returns [(new history, resolved)] per band."""
    return _taa_bands(InTurnExchange(len(bands)), bands, histories, alpha)
