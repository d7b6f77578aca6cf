"""The Renderer, flat, lit, shadowed and deferred pipelines (counterpart of
``zrenderer_tpu/engine/renderer.py``).

* ``load_scene`` flattens the scene once (the lit pipelines fold material
  base colors into the vertex colors) and uploads the buffers to the
  renderer's device, behind generational pool handles, with the
  per-triangle material table; it caches each draw's local AABB corners
  for the shadow pass's light frustum.
* ``set_environment`` binds the lit pipelines' texture (a Texture, or
  per-material textures stacked into a TextureArray), the point light
  (lit), the directional light (shadowed) and the point-light array
  (deferred); the atlas and the lights are uploaded once here.
* ``render`` computes the per-frame constants on the host (object_to_clip
  matrices; for lit also normal matrices, the inverse view-projection and
  the camera position), stages them in the pinned upload ring, copies them
  to the device without blocking and enqueues the frame.  Flat: column
  geometry, the raster dispatch (``raster.select_raster``: K1, K3, K4, K4c,
  K5 or K6), the RGBA8 unpack and the crop.  Lit
  (``passes.build_lit_frame``): the G-buffer dispatch
  (``raster.select_gbuffer_raster``: K2g, K3g, K4g, K5g or K6g), sampling,
  Blinn-Phong and the tonemap.  Shadowed (``passes.build_shadowed_frame``)
  adds per-draw object-to-light-clip matrices from an orthographic light
  frustum fitted to the transformed draw bounds (``_light_view_proj``),
  the depth-only pass (``raster.select_depth_raster``: K2d, K3d, K4d, K6d
  or K5's depth plane) and PCF, and keeps the frame's shadow map in
  ``_shadow_map``.  Deferred (``passes.build_deferred_frame``) takes the
  G-buffer, the world position and the tiled light kernel K7 over the
  light array.  ``jitter`` offsets the camera's projection by a sub-pixel
  TAA offset (``ops/taa.py``).  It returns before the device is done;
  ``present`` paces the host to ``frames_in_flight`` frames ahead with
  CUDA events, ``read_frame`` copies the newest frame back.
* ``render_animation`` renders N frames back to back with no host sync
  inside the loop, reducing each frame to a digest: flat frames as padded
  packed planes, the other pipelines' as the u8 sum of the visible frame.

Everything runs on the one explicit ``device``; ``device="cuda"`` on a
host without a card raises.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zrenderer_tpu_torch.device import resolve_device
from zrenderer_tpu_torch.engine import passes
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.pools import PipelineCache, ResourcePool
from zrenderer_tpu_torch.engine.stats import FrameStats
from zrenderer_tpu_torch.engine.upload import (
    FlatScene,
    flat_scene_to_device,
    flatten_scene,
)
from zrenderer_tpu_torch.engine.textures import (
    Texture,
    TextureArray,
    white_texture,
)
from zrenderer_tpu_torch.engine.upload_ring import UploadRing
from zrenderer_tpu_torch.math import zmath as zm
from zrenderer_tpu_torch.ops import raster
from zrenderer_tpu_torch.ops.geometry import (
    MATERIAL_COLS,
    clip_overflow_count,
    view_proj_from_camera,
)
from zrenderer_tpu_torch.ops.taa import jittered_view_proj

log = logging.getLogger("zrenderer_torch.engine")


def frame_digest(packed) -> torch.Tensor:
    """Sum of a packed plane's u32 values (alpha sets bit 31, so the int32
    bits are masked to u32), exact in int64, returned as f32."""
    return (packed.to(torch.int64) & 0xFFFFFFFF).sum().to(torch.float32)


def rgba_digest(rgba) -> torch.Tensor:
    """Sum of a u8 frame's channel values, exact in int64, returned as f32
    (the reference sums the f32 channels, within rtol 1e-5 of this)."""
    return rgba.to(torch.int64).sum().to(torch.float32)


class Renderer:
    def __init__(self, config: RenderConfig | None = None, device="cuda"):
        self.config = config or RenderConfig()
        self.device = resolve_device(device)
        self.pipelines = PipelineCache()
        self.resources = ResourcePool(name="device-buffer")
        self.stats = FrameStats()
        self.upload_ring = UploadRing(
            self.config.upload_heap_bytes,
            frames=max(self.config.frames_in_flight, 1),
            pin_memory=self.device.type == "cuda",
        )
        self._in_flight = []  # CUDA events of enqueued frames, oldest first
        self.flat: FlatScene | None = None
        self._buffer_handles = {}  # name -> generational Handle
        self._pending = None  # newest enqueued frame (color, depth)
        self._material_tex_layer = None  # material -> texture-array layer
        self._white_layer = 0
        self._draw_corners = None  # (D, 8, 4) local AABB corners per draw
        self._static_light_vp = None  # light frustum of the static scene
        self._shadow_map = None  # the newest shadowed frame's map
        log.info("Renderer on %s", self.device)

    # -- resource upload ----------------------------------------------------

    def load_scene(self, scene, mesh_data) -> None:
        """Flatten the scene and upload its buffers (reloading destroys the
        previous buffers' slots)."""
        self.scene = scene
        self.mesh_data = mesh_data
        cfg = self.config
        self.flat = flatten_scene(
            scene, mesh_data, pad=True, vert_align=cfg.vert_align,
            tri_align=cfg.tri_align, lod=cfg.lod,
            apply_materials=cfg.pipeline != "flat",
        )
        for h in self._buffer_handles.values():
            self.resources.destroy(h)
        self._buffer_handles = {}
        buffers = flat_scene_to_device(self.flat.host_arrays(), self.device)
        for name, tensor in buffers.items():
            self._buffer_handles[name] = self.resources.add((name, tensor))
        self._upload_material_table()
        self._draw_corners = _draw_aabb_corners(self.flat)
        self._static_light_vp = None
        f = self.flat
        log.info(
            "scene uploaded: %d draws, %d verts (%d padded), %d tris "
            "(%d padded)", f.draw_count, f.num_vertices, len(f.positions),
            f.num_triangles, len(f.tri_vidx),
        )

    # -- environment (textures, light) ---------------------------------------

    def set_environment(self, texture=None, light_pos=(4.0, 8.0, 6.0),
                        light_color=(1.0, 1.0, 1.0), textures=None,
                        material_textures=None,
                        light_dir=(-0.5, -1.0, -0.35), lights=None):
        """Bind the lit pipelines' resources: a Texture (None: 1x1 white),
        one point light (lit), one directional light (shadowed:
        ``light_dir`` points from the light, normalized here) and a light
        array (deferred: ``lights=(positions (L, 3), colors (L, 3))``;
        None: the one point light).

        Per-draw textures: ``textures`` (same-size Textures, stacked into a
        TextureArray with an all-white layer appended) plus
        ``material_textures`` mapping material index -> layer (-1 or
        missing: the white layer).  Draws find their layer through their
        mesh's material.  The atlas and the light go to the device here,
        once."""
        self._material_tex_layer = None
        if textures is not None:
            h, w = textures[0].base_shape
            white = Texture.from_array(np.ones((h, w, 4), np.float32),
                                       num_levels=textures[0].num_levels)
            array = TextureArray.from_textures(list(textures) + [white])
            white_layer = array.num_layers - 1
            mats = getattr(self, "mesh_data", None)
            num_materials = len(mats.materials) if mats else 0
            mapping = np.full(max(num_materials, 1), white_layer, np.int32)
            if material_textures is not None:
                for mi, layer in enumerate(material_textures):
                    if 0 <= mi < len(mapping) and layer >= 0:
                        mapping[mi] = layer
            self._material_tex_layer = mapping
            self._white_layer = white_layer
            texture = array
        else:
            self._white_layer = 0
            texture = texture if texture is not None else white_texture()
        self.texture = texture.to(self.device)
        self.light_pos = torch.tensor(np.asarray(light_pos, np.float32),
                                      device=self.device)
        self.light_color = torch.tensor(np.asarray(light_color, np.float32),
                                        device=self.device)
        d = np.asarray(light_dir, np.float32)
        self.light_dir = d / np.linalg.norm(d)  # host f32, for the frustum
        self._light_dir_dev = torch.from_numpy(self.light_dir).to(self.device)
        if lights is None:
            lights = ([light_pos], [light_color])
        self.lights = tuple(
            torch.tensor(np.asarray(x, np.float32).reshape(-1, 3),
                         device=self.device) for x in lights)
        self._static_light_vp = None  # the frustum depends on light_dir
        if self.flat is not None:
            self._upload_material_table()

    def _upload_material_table(self) -> None:
        """Per-draw material constants (metallic, roughness, emissive rgb,
        texture layer), expanded to per-triangle rows once on the host and
        uploaded as the 'materials' buffer.  Draws without a material get
        the Material defaults and the white layer."""
        mats = getattr(self, "mesh_data", None)
        tex_layer = self._material_tex_layer
        table = np.zeros((self.flat.draw_count, MATERIAL_COLS), np.float32)
        table[:, 1] = 0.5  # the Material dataclass's default roughness
        table[:, 5] = float(self._white_layer)
        for d, mesh_index in enumerate(self.flat.draw_mesh):
            mi = -1
            if mats is not None and mats.mesh_material:
                mi = mats.mesh_material[mesh_index]
            if mi is None or mi < 0:
                continue
            m = mats.materials[mi]
            table[d, 0] = m.metallic
            table[d, 1] = m.roughness
            table[d, 2:5] = m.emissive
            if tex_layer is not None and mi < len(tex_layer):
                table[d, 5] = float(tex_layer[mi])
        old = self._buffer_handles.pop("materials", None)
        if old is not None:
            self.resources.destroy(old)
        tri_draw = self.flat.vert_node[self.flat.tri_vidx[:, 0]]
        tensor = torch.from_numpy(np.ascontiguousarray(table[tri_draw]))
        self._buffer_handles["materials"] = self.resources.add(
            ("materials", tensor.to(self.device)))

    def _buffers(self) -> dict:
        """Resolve the scene's device buffers through their pool handles;
        a stale handle fails loudly."""
        out = {}
        for name, h in self._buffer_handles.items():
            payload = self.resources.lookup(h)
            if payload is None:
                raise RuntimeError(f"stale resource handle for {name!r}")
            out[name] = payload[1]
        return out

    # -- frame pipeline -----------------------------------------------------

    def _frame_fn(self):
        cfg = self.config
        key = (cfg.content_hash(), len(self.flat.positions),
               len(self.flat.tri_vidx), self.flat.draw_count)
        if cfg.pipeline != "flat":
            if not hasattr(self, "texture"):
                self.set_environment()
            tex = self.texture
            key += (tuple(tex.base_shape), tex.num_levels, tex.num_layers)
            if cfg.pipeline == "deferred":
                return self.pipelines.get_or_create(
                    key, lambda: passes.build_deferred_frame(
                        cfg.width, cfg.height, cfg.pad_height, cfg.pad_width,
                        lighting_planes=cfg.lighting_planes,
                        binning=cfg.binning))
            args = (cfg.width, cfg.height, cfg.pad_height, cfg.pad_width, tex)
            if cfg.pipeline == "lit":
                return self.pipelines.get_or_create(
                    key, lambda: passes.build_lit_frame(
                        *args, binning=cfg.binning))
            return self.pipelines.get_or_create(
                key, lambda: passes.build_shadowed_frame(
                    *args, shadow_size=cfg.shadow_size,
                    shadow_bias=cfg.shadow_bias,
                    shadow_slope_bias=cfg.shadow_slope_bias,
                    pcf_taps=cfg.pcf_taps,
                    shadow_lookup_stride=cfg.shadow_lookup_stride,
                    binning=cfg.binning))

        def build():
            def frame(ccols, tri_node, matrices):
                color, depth = raster.render_frame(
                    ccols, tri_node, matrices, cfg.width, cfg.height,
                    cfg.pad_height, cfg.pad_width, binning=cfg.binning,
                )
                return raster.unpack_rgba8(color), depth

            return frame

        return self.pipelines.get_or_create(key, build)

    def _view_proj(self, camera=None, jitter=None) -> np.ndarray:
        """The camera's view-projection, offset by ``jitter`` (jx, jy)
        pixels (the TAA sub-pixel offset) when given."""
        camera = camera if camera is not None else self.scene.active_camera
        vp = view_proj_from_camera(camera, self.config.width,
                                   self.config.height)
        if jitter is not None:
            vp = jittered_view_proj(vp, jitter, self.config.width,
                                    self.config.height)
        return vp

    def camera_matrices(self, camera=None, transforms=None,
                        jitter=None) -> np.ndarray:
        """Host-side per-frame constants: object_to_clip per draw.
        ``transforms``: optional (D, 4, 4) node_to_world overrides;
        ``jitter``: optional (jx, jy) sub-pixel TAA offset."""
        vp = self._view_proj(camera, jitter)
        node_to_world = self.flat.node_to_world
        if transforms is not None:
            node_to_world = np.asarray(transforms, np.float32)
        return np.einsum("nij,jk->nik", node_to_world, vp).astype(np.float32)

    def _lit_constants(self, camera=None, transforms=None,
                       jitter=None) -> dict:
        """Per-frame constants of the lit pipelines (host f32): per-draw
        object_to_clip matrices and normal matrices (inverse-transpose of
        the node rotation), the view-projection and its inverse (inverted
        in f64) for world-position reconstruction, and the camera position;
        shadowed adds the light's view-projection and the per-draw
        object-to-light-clip matrices.  ``jitter`` offsets the camera's
        view-projection, and so its inverse; the light's stays
        unjittered."""
        camera = camera if camera is not None else self.scene.active_camera
        vp = self._view_proj(camera, jitter)
        node_to_world = self.flat.node_to_world
        if transforms is not None:
            node_to_world = np.asarray(transforms, np.float32)
        matrices = np.einsum("nij,jk->nik", node_to_world,
                             vp).astype(np.float32)
        normal_mats = np.linalg.inv(
            node_to_world[:, :3, :3]).transpose(0, 2, 1).astype(np.float32)
        out = {
            "matrices": matrices,
            "normal_mats": normal_mats,
            "view_proj": vp.astype(np.float32),
            "inv_view_proj": np.linalg.inv(
                vp.astype(np.float64)).astype(np.float32),
            "cam_pos": np.asarray(camera.position, np.float32),
        }
        if self.config.pipeline == "shadowed":
            light_vp = self._light_view_proj(
                None if transforms is None else node_to_world)
            out["light_matrices"] = np.einsum(
                "nij,jk->nik", node_to_world, light_vp).astype(np.float32)
            out["light_vp"] = light_vp
        return out

    _LIT_KEYS = ("matrices", "normal_mats", "inv_view_proj", "cam_pos")
    _SHADOW_KEYS = _LIT_KEYS + ("light_matrices", "light_vp")
    _DEFERRED_KEYS = _LIT_KEYS + ("view_proj",)

    def _constant_keys(self):
        """The per-frame constants the lit pipelines' frame takes, in its
        argument order."""
        return {"shadowed": self._SHADOW_KEYS,
                "deferred": self._DEFERRED_KEYS}.get(self.config.pipeline,
                                                     self._LIT_KEYS)

    def _textures(self):
        """The frame's texture argument before the staged constants (the
        deferred frame samples none)."""
        if self.config.pipeline == "deferred":
            return ()
        return (self.texture.atlas_u32,)

    def _lights(self):
        """The frame's light arguments after the staged constants."""
        if self.config.pipeline == "shadowed":
            return self._light_dir_dev, self.light_color
        if self.config.pipeline == "deferred":
            return self.lights
        return self.light_pos, self.light_color

    def _light_view_proj(self, node_to_world=None) -> np.ndarray:
        """Directional-light orthographic view-projection fitted to the
        scene's world AABB: the per-draw local corners times the current
        transforms (exact under rotation and scale, O(draws) a frame),
        cached for the static transforms."""
        static = node_to_world is None
        if static and self._static_light_vp is not None:
            return self._static_light_vp
        mats = self.flat.node_to_world if static else node_to_world
        world = np.einsum("dkj,dji->dki", self._draw_corners, mats)
        pts = world.reshape(-1, 4)[:, :3]
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        center = (lo + hi) * 0.5
        radius = 0.5 * float(np.linalg.norm(hi - lo)) + 1e-3
        eye = center - self.light_dir * (2.0 * radius)
        up = (0, 1, 0) if abs(self.light_dir[1]) < 0.95 else (1, 0, 0)
        view = zm.look_at_rh(zm.load_vec3(eye), zm.load_vec3(center),
                             zm.vec3(*up))
        proj = zm.orthographic_rh(2.2 * radius, 2.2 * radius, 0.1,
                                  4.5 * radius)
        vp = zm.mul(view, proj)
        if static:
            self._static_light_vp = vp
        return vp

    def _stage_constants(self, arrays):
        """Per-frame constants through the bounded staging ring; on
        exhaustion stall the device, reset the frame's heap and retry."""
        staged = self.upload_ring.stage_all(arrays)
        if staged is None:
            self.upload_ring.stall_count += 1
            log.warning(
                "per-frame upload heap exhausted (%d bytes): stalling the "
                "device and retrying", self.config.upload_heap_bytes,
            )
            self.finish_gpu_commands()
            self.upload_ring.reset_frame()
            staged = self.upload_ring.stage_all(arrays)
            if staged is None:
                raise MemoryError(
                    "frame constants exceed the upload heap "
                    f"({self.config.upload_heap_bytes} bytes); raise "
                    "RenderConfig.upload_heap_bytes"
                )
        return [s.to(self.device, non_blocking=True) for s in staged]

    def _fence(self):
        if self.device.type != "cuda":
            return None  # CPU ops complete before they return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _pace(self) -> None:
        """Wait until at most ``frames_in_flight - 1`` frames are
        outstanding; the ring slot about to be reused belongs to a frame
        drained here."""
        keep = max(self.config.frames_in_flight - 1, 0)
        while len(self._in_flight) > keep:
            event = self._in_flight.pop(0)
            if event is not None:
                event.synchronize()

    def render(self, camera=None, transforms=None, jitter=None):
        """Enqueue one frame; returns the device frame
        (rgba (H, W, 4) u8, depth (H, W) f32) without waiting for it.
        ``jitter``: optional (jx, jy) sub-pixel TAA offset."""
        if self.flat is None:
            raise RuntimeError("load_scene first")
        self._pace()
        frame = self._frame_fn()
        b = self._buffers()
        if self.config.pipeline != "flat":
            c = self._lit_constants(camera, transforms, jitter)
            staged = self._stage_constants(
                [c[k] for k in self._constant_keys()])
            color, depth, *shadow = frame(b, *self._textures(), *staged,
                                          *self._lights())
            if shadow:
                self._shadow_map = shadow[0]
            matrices = staged[0]
        else:
            (matrices,) = self._stage_constants(
                [self.camera_matrices(camera, transforms, jitter)])
            color, depth = frame(b["corner_cols"], b["tri_node"], matrices)
        if self.config.debug:
            dropped = self.clip_overflow(matrices)
            self.stats.clip_dropped = dropped
            if dropped:
                raise RuntimeError(
                    f"debug validation: capped clipper dropped {dropped} "
                    "plane-crossing triangles this frame (raise the clip "
                    "cap; see geometry.clip_cap_for)")
        self._pending = (color, depth)
        self._in_flight.append(self._fence())
        self.stats.update(
            triangles=self.flat.num_triangles,
            pixels=self.config.width * self.config.height,
        )
        return color, depth

    def clip_overflow(self, matrices) -> int:
        """Triangles the capped clipper drops for these per-draw
        object_to_clip matrices ((D, 4, 4), host or device): run each frame
        under ``config.debug``, or on demand.  Reads the count back."""
        b = self._buffers()
        mats = torch.as_tensor(matrices, dtype=torch.float32).to(self.device)
        return int(clip_overflow_count(b["corner_cols"], b["tri_node"], mats,
                                       self.config.width,
                                       self.config.height).item())

    def present(self):
        """Fence pacing, then rotate the staging ring.  Returns the newest
        frame's device tensors (not necessarily complete yet)."""
        if self._pending is None:
            raise RuntimeError("render first")
        self._pace()
        self.upload_ring.begin_frame()
        return self._pending

    def read_frame(self):
        """Device -> host copy of the newest frame: (rgba_u8 (H, W, 4),
        depth (H, W)) as NumPy arrays."""
        if self._pending is None:
            raise RuntimeError("render first")
        color, depth = self._pending
        out = color.cpu().numpy(), depth.cpu().numpy()
        # The copy waited for the newest frame; older ones finished first.
        self._in_flight.clear()
        return out

    def render_and_read(self, camera=None, transforms=None, jitter=None):
        self.render(camera, transforms, jitter)
        return self.read_frame()

    def finish_gpu_commands(self) -> None:
        """Drain the device."""
        self._in_flight.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def drain_hard(self) -> None:
        """Drain, then read one pixel of the newest frame back: a value
        that only exists once the frame has run."""
        self.finish_gpu_commands()
        if self._pending is not None:
            self._pending[0][0, 0].cpu()

    def render_animation(self, num_frames: int | None = None, cameras=None,
                         transforms_seq=None, jitters=None):
        """Render a frame sequence back to back on the device.

        Per-frame constants for all N frames are computed on the host and
        uploaded once; then every frame is rendered and reduced to a
        digest with no host sync in the loop: flat frames at the padded
        size as packed planes (``frame_digest``), then the presented frame
        once more, cropped and unpacked; the other pipelines' frames as the
        visible u8 frame (``rgba_digest``), the last one presented.
        ``jitters``: optional (N, 2) sub-pixel TAA offsets.  Returns
        ``(digests (N,) f32, (color, depth))``; reading the digests is a
        true fence.
        """
        if self.flat is None:
            raise RuntimeError("load_scene first")
        if num_frames is None:
            num_frames = len(next(x for x in (transforms_seq, cameras, jitters)
                                  if x is not None))
        cfg = self.config

        def per_frame(i):
            return (cameras[i] if cameras is not None else None,
                    transforms_seq[i] if transforms_seq is not None else None,
                    jitters[i] if jitters is not None else None)

        def upload(host):
            t = torch.from_numpy(np.ascontiguousarray(host))
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        digests = torch.empty(num_frames, dtype=torch.float32,
                              device=self.device)
        if cfg.pipeline != "flat":
            frame = self._frame_fn()
            per = [self._lit_constants(*per_frame(i))
                   for i in range(num_frames)]
            xs = [upload(np.stack([c[k] for c in per]))
                  for k in self._constant_keys()]
            b = self._buffers()
            for i in range(num_frames):
                color, depth, *shadow = frame(
                    b, *self._textures(), *(x[i] for x in xs),
                    *self._lights())
                digests[i] = rgba_digest(color)
            if shadow:
                self._shadow_map = shadow[0]
        else:
            digests, (color, depth) = self._flat_animation(
                digests, upload(np.stack([self.camera_matrices(*per_frame(i))
                                          for i in range(num_frames)])))
        self._pending = (color, depth)
        self._in_flight.append(self._fence())
        self.stats.update(
            triangles=self.flat.num_triangles * num_frames,
            pixels=cfg.width * cfg.height * num_frames,
        )
        return digests, (color, depth)

    def _flat_animation(self, digests, mats):
        """The flat frames of ``render_animation``: each padded packed
        plane digested, then the presented frame rendered once more."""
        cfg = self.config
        num_frames = digests.shape[0]
        b = self._buffers()
        ccols, tri_node = b["corner_cols"], b["tri_node"]
        for i in range(num_frames):
            packed, _ = raster.render_frame(
                ccols, tri_node, mats[i], cfg.width, cfg.height,
                cfg.pad_height, cfg.pad_width, binning=cfg.binning,
                raw_packed=True,
            )
            digests[i] = frame_digest(packed)
        return digests, self._frame_fn()(ccols, tri_node, mats[-1])


def _draw_aabb_corners(flat: FlatScene) -> np.ndarray:
    """(D, 8, 4) f32: the 8 corners (x outer, z inner; w = 1) of each
    draw's local vertex AABB, over the unpadded vertices."""
    n = flat.num_vertices
    pts = flat.positions[:n, :3]
    node = flat.vert_node[:n]
    lo = np.full((flat.draw_count, 3), np.inf, np.float32)
    hi = np.full((flat.draw_count, 3), -np.inf, np.float32)
    np.minimum.at(lo, node, pts)
    np.maximum.at(hi, node, pts)
    bounds = np.stack([lo, hi], axis=1)  # (D, 2, 3)
    pick = np.array([(i, j, k) for i in (0, 1) for j in (0, 1)
                     for k in (0, 1)])
    corners = np.ones((flat.draw_count, 8, 4), np.float32)
    for axis in range(3):
        corners[:, :, axis] = bounds[:, pick[:, axis], axis]
    return corners
