"""Renderer configuration for the port's flat, lit, shadowed and deferred
pipelines.

Counterpart of ``zrenderer_tpu/engine/config.py``, with the fields those
paths read.  An option the port does not give an effect raises instead of
being ignored: ``supersample != 1`` off the flat pipeline and a clear
color other than the default raise ``NotImplementedError``; the
reference's ``readback`` and ``profile`` fields, which nothing reads, are
left out, so passing either raises ``TypeError`` (the profiling zones are
turned on by ``profiling.ztracy.enable``, ``ZRENDERER_TRACE`` or
``ztracy.trace``).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, replace

from zrenderer_tpu_torch.ops.geometry import MAX_SPAN_PX
from zrenderer_tpu_torch.ops.raster import TILE_H, TILE_W

PIPELINES = ("flat", "lit", "shadowed", "deferred")
LIGHTING_PLANES = ("f32", "bf16")
# The largest viewport extent the geometry stage's guard band allows
# (geometry.guard_px).
MAX_EXTENT = MAX_SPAN_PX - 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1920
    height: int = 1080
    # "flat" (config 0), "lit" (config 1, textured Blinn-Phong),
    # "shadowed" (config 2, directional shadow map + PCF) or "deferred"
    # (config 3, G-buffer + tiled GGX over many point lights, K7).
    pipeline: str = "flat"
    # Raster binning (ops/raster.select_raster; the lit pipeline's G-buffer
    # dispatch, select_gbuffer_raster, differs above and with tile_lists).
    # Up to 32768 setup rows:
    # "auto" (K1 small-scene lists up to 1024 head rows, K3 hierarchy
    # above), "small" (K1), "hierarchy" (K3) or "tile_lists" (K6 global
    # pair lists).  Above: "hierarchy" streams the hierarchy (K5),
    # "tile_lists" streams records with the coarse class (K4c), and the
    # others stream records (K4).
    binning: str = "auto"
    # The shadow map (config 2): shadow_size^2 texels, a multiple of the
    # raster tile (no crop, no padding); constant + slope-scaled depth bias;
    # PCF radius ((2*pcf_taps+1)^2 taps); shadow_lookup_stride 1 = PCF at
    # every pixel, 2 = at every second pixel with a bilinear upsample of
    # the lit fraction.
    shadow_size: int = 1024
    shadow_bias: float = 2e-3
    shadow_slope_bias: float = 3e-3
    pcf_taps: int = 1
    shadow_lookup_stride: int = 1
    # The deferred pipeline's G-buffer planes as K7 reads them: "f32", or
    # "bf16" (half the bytes; the BRDF math and the sums stay f32).
    lighting_planes: str = "f32"
    # The kernels and the lit tonemap resolve uncovered pixels to (0, 0, 0,
    # 255): the default clear color is the only one the port produces.
    clear_color: tuple = (0.0, 0.0, 0.0, 1.0)
    # Ordered-grid supersampling of the flat pipeline: the frame renders at
    # (supersample * width, supersample * height), padded to the tile, and
    # box-resolves down (raster.ssaa_resolve).  The other pipelines take 1
    # only.
    supersample: int = 1
    vert_align: int = 128
    tri_align: int = 256
    lod: int = 0  # mesh LOD drawn
    # Per-frame host-staging budget for the per-draw constants; exhaustion
    # stalls the device and retries (engine/upload_ring.py).
    upload_heap_bytes: int = 18 * 2**20
    # Host/device pipelining depth: present() fences only when the host is
    # this many frames ahead.  1 = fully synchronous present.
    frames_in_flight: int = 2
    # The debug layer: each frame is validated (finite depth in [0, 1],
    # Renderer._validate_frame) and counts the plane-crossing triangles the
    # capped clipper dropped (both a host sync), records them in
    # stats.clip_dropped and raises on a drop.  The kernels stay the card's
    # own under debug.
    debug: bool = False
    # Meshlet culling on the flat pipeline (the others raise): load_scene
    # builds the per-128-triangle meshlet table (tri_align a multiple of
    # 128), each frame kills the rows of the meshlets outside the frustum
    # or facing away (ops/geometry.meshlet_keep_mask).
    meshlet_cull: bool = False

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise ValueError(
                f"unknown pipeline {self.pipeline!r}: one of {PIPELINES}")
        if self.lighting_planes not in LIGHTING_PLANES:
            raise ValueError(f"lighting_planes {self.lighting_planes!r}: one "
                             f"of {LIGHTING_PLANES}")
        if int(self.supersample) != self.supersample or self.supersample < 1:
            raise ValueError(f"supersample {self.supersample}: a positive "
                             "integer")
        if self.supersample != 1 and self.pipeline != "flat":
            raise NotImplementedError(
                f"supersample != 1 on the {self.pipeline} pipeline: SSAA "
                "is the flat pipeline's only"
            )
        if self.meshlet_cull and self.pipeline != "flat":
            raise NotImplementedError(
                f"meshlet_cull on the {self.pipeline} pipeline: the cull is "
                "the flat frame's only")
        if tuple(self.clear_color) != (0.0, 0.0, 0.0, 1.0):
            raise NotImplementedError(
                "the port resolves uncovered pixels to the default clear "
                "color (0, 0, 0, 1) only"
            )
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad frame size {self.width}x{self.height}")
        if max(self.width, self.height) * self.supersample > MAX_EXTENT:
            raise ValueError(
                f"{self.width}x{self.height} at supersample "
                f"{self.supersample}: the rendered extent exceeds the "
                f"geometry stage's {MAX_EXTENT} pixels")
        if self.shadow_size <= 0 or self.shadow_size % TILE_W \
                or self.shadow_size % TILE_H:
            raise ValueError(
                f"shadow_size {self.shadow_size}: a positive multiple of "
                f"{TILE_W} and {TILE_H}")
        if self.shadow_lookup_stride not in (1, 2):
            raise ValueError(
                f"shadow_lookup_stride {self.shadow_lookup_stride}: 1 or 2")

    @property
    def pad_width(self) -> int:
        return _round_up(self.width, TILE_W)

    @property
    def pad_height(self) -> int:
        return _round_up(self.height, TILE_H)

    def content_hash(self) -> int:
        """Stable content hash for pipeline-cache keys."""
        return zlib.adler32(repr(self).encode())

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
