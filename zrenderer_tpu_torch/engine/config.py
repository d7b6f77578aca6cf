"""Renderer configuration for the port's flat, lit, shadowed and deferred
pipelines.

Counterpart of ``zrenderer_tpu/engine/config.py``, with the fields those
paths read.  Options whose passes are not ported yet raise
``NotImplementedError`` instead of being ignored.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, replace

from zrenderer_tpu_torch.ops.raster import TILE_H, TILE_W

PIPELINES = ("flat", "lit", "shadowed", "deferred")
LIGHTING_PLANES = ("f32", "bf16")


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
    # Ordered-grid supersampling: only 1 is ported (SSAA is ROADMAP Queue 1
    # item 6).
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
    # The debug layer: each frame counts the plane-crossing triangles the
    # capped clipper dropped (a host sync), records them in
    # stats.clip_dropped and raises on a drop.
    debug: bool = False

    def __post_init__(self):
        if self.pipeline not in PIPELINES:
            raise ValueError(
                f"unknown pipeline {self.pipeline!r}: one of {PIPELINES}")
        if self.lighting_planes not in LIGHTING_PLANES:
            raise ValueError(f"lighting_planes {self.lighting_planes!r}: one "
                             f"of {LIGHTING_PLANES}")
        if self.supersample != 1:
            raise NotImplementedError(
                "supersample != 1: SSAA is not ported (ROADMAP.md Queue 1 "
                "item 6)"
            )
        if tuple(self.clear_color) != (0.0, 0.0, 0.0, 1.0):
            raise NotImplementedError(
                "the port resolves uncovered pixels to the default clear "
                "color (0, 0, 0, 1) only"
            )
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"bad frame size {self.width}x{self.height}")
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
