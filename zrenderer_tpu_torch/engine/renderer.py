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
  geometry (indexed with a vertex shader bound), the meshlet cull under
  ``meshlet_cull``, the raster dispatch (``raster.select_raster``: K1, K3,
  K4, K4c, K5 or K6) at ``supersample`` times the frame size, the RGBA8
  unpack, the crop and, above 1x, the SSAA box resolve.  Lit
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
  packed planes (resolved u8 frames under SSAA), the other pipelines' as
  the u8 sum of the visible frame.
* ``set_vertex_shader`` binds an object-space vertex stage on tensors
  for every pipeline's camera pass (the indexed buffers then feed the
  geometry stage; the shadow pass stays unshaded, as the reference's);
  ``create_compute_pipeline`` and ``create_mesh_pipeline`` pool a device
  program by generational handle, ``dispatch`` runs one and
  ``destroy_pipeline`` frees it.  ``debug`` validates each frame's depth
  (``_validate_frame``) and counts the clipper's drops; the kernels stay
  the card's own.  ``load_scene``, ``render``, ``present``, ``read_frame``
  and ``dispatch`` run in profiling zones (``profiling/ztracy.py``), and
  ``render`` marks a frame.

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
    RASTER_BLOCK,
    clip_overflow_count,
    clip_overflow_count_indexed,
    view_proj_from_camera,
)
from zrenderer_tpu_torch.ops.taa import jittered_view_proj
from zrenderer_tpu_torch.profiling import ztracy

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
        self._vertex_shader = None
        self._vertex_shader_key = None
        self._meshlet_table = None  # (bounds, mdraw, enabled) on the device
        log.info("Renderer on %s", self.device)

    # -- resource upload ----------------------------------------------------

    def load_scene(self, scene, mesh_data) -> None:
        """Flatten the scene and upload its buffers (reloading destroys the
        previous buffers' slots); under ``meshlet_cull`` also the meshlet
        table."""
        with ztracy.zone("load_scene"):
            self._load_scene(scene, mesh_data)

    def _load_scene(self, scene, mesh_data) -> None:
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
        self._meshlet_table = None
        if cfg.meshlet_cull:
            self._meshlet_table = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in self.flat.build_meshlet_table(RASTER_BLOCK))
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
        vs = self._vertex_shader
        key = (cfg.content_hash(), len(self.flat.positions),
               len(self.flat.tri_vidx), self.flat.draw_count,
               self._vertex_shader_key)
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
                        binning=cfg.binning, vertex_shader=vs))
            args = (cfg.width, cfg.height, cfg.pad_height, cfg.pad_width, tex)
            if cfg.pipeline == "lit":
                return self.pipelines.get_or_create(
                    key, lambda: passes.build_lit_frame(
                        *args, binning=cfg.binning, vertex_shader=vs))
            return self.pipelines.get_or_create(
                key, lambda: passes.build_shadowed_frame(
                    *args, shadow_size=cfg.shadow_size,
                    shadow_bias=cfg.shadow_bias,
                    shadow_slope_bias=cfg.shadow_slope_bias,
                    pcf_taps=cfg.pcf_taps,
                    shadow_lookup_stride=cfg.shadow_lookup_stride,
                    binning=cfg.binning, vertex_shader=vs))
        return self.pipelines.get_or_create(key, self._build_flat_frame)

    def _flat_target(self):
        """The flat frame's rendered size and its tile-padded target:
        (width, height, pad_height, pad_width) at ``supersample``x."""
        s = self.config.supersample
        w, h = self.config.width * s, self.config.height * s
        return (w, h, -(-h // raster.TILE_H) * raster.TILE_H,
                -(-w // raster.TILE_W) * raster.TILE_W)

    def _build_flat_frame(self):
        """The flat frame function ``frame(b, matrices, cull=None,
        raw_packed=False)``: the column buffers, or the indexed ones
        through the bound vertex shader; ``cull`` the meshlet cull's
        (bounds, mdraw, enabled, cam_local).  Returns (rgba u8 (H, W, 4),
        depth (H, W)), resolved from the supersampled frame above 1x; with
        ``raw_packed`` the padded packed planes as the kernel wrote them."""
        cfg = self.config
        vs = self._vertex_shader
        target = self._flat_target()

        def frame(b, matrices, cull=None, raw_packed=False):
            kw = dict(binning=cfg.binning, raw_packed=raw_packed,
                      meshlet_cull=cull)
            if vs is None:
                color, depth = raster.render_frame(
                    b["corner_cols"], b["tri_node"], matrices, *target, **kw)
            else:
                color, depth = raster.render_frame_indexed(
                    b["positions"], b["attrs"], b["tri_vidx"], b["vert_node"],
                    matrices, *target, vertex_shader=vs, **kw)
            if raw_packed:
                return color, depth
            return self._finish_flat(color, depth)

        return frame

    def _finish_flat(self, packed, depth):
        """Unpack a cropped flat frame and, above 1x, box-resolve it."""
        color = raster.unpack_rgba8(packed)
        s = self.config.supersample
        if s > 1:
            color, depth = raster.ssaa_resolve(color, depth, s)
        return color, depth

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

    def cam_local_constants(self, camera=None, transforms=None) -> np.ndarray:
        """(D, 4) f32: the camera position in each draw's local space, the
        backface-cone input of meshlet culling (inverted in f64)."""
        camera = camera if camera is not None else self.scene.active_camera
        n2w = self.flat.node_to_world
        if transforms is not None:
            n2w = np.asarray(transforms, np.float32)
        cam = np.asarray([*camera.position[:3], 1.0], np.float32)
        inv = np.linalg.inv(n2w.astype(np.float64)).astype(np.float32)
        return np.einsum("j,djk->dk", cam, inv).astype(np.float32)

    def _cull(self, cam_local=None):
        """The flat frame's ``cull`` argument: the meshlet table and the
        frame's staged camera positions, or None without the table."""
        if self._meshlet_table is None:
            return None
        return (*self._meshlet_table, cam_local)

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
        ``jitter``: optional (jx, jy) sub-pixel TAA offset.  The frame is
        marked after the render zone closes, so that the frame spans nest
        around the zones."""
        if self.flat is None:
            raise RuntimeError("load_scene first")
        with ztracy.zone("render"):
            out = self._render(camera, transforms, jitter)
        ztracy.frame_mark()
        return out

    def _render(self, camera, transforms, jitter):
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
            host = [self.camera_matrices(camera, transforms, jitter)]
            if self._meshlet_table is not None:
                host.append(self.cam_local_constants(camera, transforms))
            matrices, *cam_local = self._stage_constants(host)
            color, depth = frame(b, matrices, self._cull(*cam_local))
        if self.config.debug:
            self._validate_frame(color, depth)
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
        under ``config.debug``, or on demand.  Reads the count back.  With
        a vertex shader bound it counts the shaded vertices; the viewport
        is the rendered one (``supersample`` times the frame on the flat
        pipeline)."""
        b = self._buffers()
        mats = torch.as_tensor(matrices, dtype=torch.float32).to(self.device)
        w, h = self.config.width, self.config.height
        if self.config.pipeline == "flat":
            w, h = self._flat_target()[:2]
        if self._vertex_shader is None:
            n = clip_overflow_count(b["corner_cols"], b["tri_node"], mats,
                                    w, h)
        else:
            n = clip_overflow_count_indexed(
                b["positions"], b["attrs"], b["tri_vidx"], mats,
                b["vert_node"], w, h, vertex_shader=self._vertex_shader)
        return int(n.item())

    def _validate_frame(self, color, depth) -> None:
        """The debug layer's frame check: ``FloatingPointError`` when the
        depth plane holds a non-finite value or one outside [0, 1] (a host
        sync).  ``color`` is accepted for the reference's signature."""
        del color
        d = torch.as_tensor(depth)
        if not bool(torch.isfinite(d).all()):
            raise FloatingPointError("debug validation: non-finite depth")
        lo, hi = float(d.min()), float(d.max())
        if lo < 0.0 or hi > 1.0:
            raise FloatingPointError(
                f"debug validation: depth outside [0,1] ({lo}, {hi})")

    def present(self):
        """Fence pacing, then rotate the staging ring.  Returns the newest
        frame's device tensors (not necessarily complete yet)."""
        if self._pending is None:
            raise RuntimeError("render first")
        with ztracy.zone("present"):
            self._pace()
            self.upload_ring.begin_frame()
            return self._pending

    def read_frame(self):
        """Device -> host copy of the newest frame: (rgba_u8 (H, W, 4),
        depth (H, W)) as NumPy arrays."""
        if self._pending is None:
            raise RuntimeError("render first")
        color, depth = self._pending
        with ztracy.zone("read_frame"):
            out = color.cpu().numpy(), depth.cpu().numpy()
        # The copy waited for the newest frame; older ones finished first.
        self._in_flight.clear()
        return out

    def render_and_read(self, camera=None, transforms=None, jitter=None):
        self.render(camera, transforms, jitter)
        return self.read_frame()

    # -- vertex shaders, compute and mesh pipelines -------------------------

    def set_vertex_shader(self, fn, name: str | None = None) -> None:
        """Bind a vertex stage: ``fn(positions (N, 4), attrs (N, 12)) ->
        (positions, attrs)`` on tensors of the renderer's device, applied
        in object space before the transform, in every pipeline's camera
        pass (the shadow pass runs unshaded, as the reference's) and in
        ``clip_overflow``.  The indexed
        buffers feed those stages while one is bound.  ``name`` keys the
        pipeline cache (default: the function's identity).
        ``set_vertex_shader(None)`` restores the column path."""
        self._vertex_shader = fn
        self._vertex_shader_key = (None if fn is None
                                   else (name or f"vs-{id(fn)}"))

    def create_compute_pipeline(self, fn, static_argnums=()):
        """Pool ``fn`` (any device program on tensors) as a pipeline and
        return its generational handle; ``dispatch`` runs it.  ``fn`` is
        pooled as it is: nothing is compiled, so ``static_argnums`` (the
        reference's jit argument) has no effect and is accepted for the
        API's sake."""
        del static_argnums
        return self.pipelines.add_pipeline(fn)

    def create_mesh_pipeline(self, fn):
        """Pool a flat frame whose geometry a device program generates:
        ``fn(*args) -> (positions (V, 4) f32, attrs (V, 12) f32, tri_vidx
        (T, 3) i32, vert_node (V,) i32)``, tensors on the renderer's
        device.  ``dispatch(handle, matrices, *args)`` pads them on the
        device with zero rows to ``vert_align``/``tri_align`` (degenerate
        triangles), renders them through the indexed flat entry under the
        config's binning (and supersample) and returns (rgba u8, depth);
        nothing goes to the host.  The pipeline's ``geometry(*args)``
        returns the padded buffers alone."""
        return self.pipelines.add_pipeline(_MeshPipeline(self, fn))

    def dispatch(self, handle, *args, **kwargs):
        """Run a pooled pipeline; a destroyed handle raises."""
        fn = self.pipelines.lookup_pipeline(handle)
        if fn is None:
            raise RuntimeError("dispatch on a stale/destroyed pipeline handle")
        with ztracy.zone("dispatch"):
            return fn(*args, **kwargs)

    def destroy_pipeline(self, handle) -> None:
        self.pipelines.destroy_pipeline(handle)

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
        size as packed planes (``frame_digest``), or under SSAA as the
        resolved u8 frame (``rgba_digest``), then the presented frame once
        more, cropped and unpacked; the other pipelines' frames as the
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
            mats = upload(np.stack([self.camera_matrices(*per_frame(i))
                                    for i in range(num_frames)]))
            cam_local = None
            if self._meshlet_table is not None:
                cam_local = upload(np.stack([
                    self.cam_local_constants(*per_frame(i)[:2])
                    for i in range(num_frames)]))
            digests, (color, depth) = self._flat_animation(digests, mats,
                                                           cam_local)
        self._pending = (color, depth)
        self._in_flight.append(self._fence())
        self.stats.update(
            triangles=self.flat.num_triangles * num_frames,
            pixels=cfg.width * cfg.height * num_frames,
        )
        return digests, (color, depth)

    def _flat_animation(self, digests, mats, cam_local=None):
        """The flat frames of ``render_animation``: each padded packed
        plane digested (the resolved frame under SSAA), then the presented
        frame rendered once more."""
        frame = self._frame_fn()
        b = self._buffers()

        def cull(i):
            return self._cull(None if cam_local is None else cam_local[i])

        for i in range(digests.shape[0]):
            if self.config.supersample == 1:
                packed, _ = frame(b, mats[i], cull(i), raw_packed=True)
                digests[i] = frame_digest(packed)
            else:
                digests[i] = rgba_digest(frame(b, mats[i], cull(i))[0])
        return digests, frame(b, mats[-1], cull(-1))


class _MeshPipeline:
    """A pooled mesh pipeline (``Renderer.create_mesh_pipeline``)."""

    def __init__(self, renderer: Renderer, fn):
        self._renderer = renderer
        self._fn = fn

    def geometry(self, *args):
        """``fn(*args)``'s buffers padded on the device with zero rows to
        the config's vertex and triangle alignments."""
        cfg = self._renderer.config
        positions, attrs, tri_vidx, vert_node = self._fn(*args)

        def pad(t, align):
            extra = -t.shape[0] % align
            zeros = torch.zeros((extra, *t.shape[1:]), dtype=t.dtype,
                                device=t.device)
            return torch.cat([t, zeros])

        return (pad(positions, cfg.vert_align), pad(attrs, cfg.vert_align),
                pad(tri_vidx, cfg.tri_align), pad(vert_node, cfg.vert_align))

    def __call__(self, matrices, *args):
        r = self._renderer
        mats = torch.as_tensor(matrices, dtype=torch.float32).to(r.device)
        color, depth = raster.render_frame_indexed(
            *self.geometry(*args), mats, *r._flat_target(),
            binning=r.config.binning)
        return r._finish_flat(color, depth)


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
