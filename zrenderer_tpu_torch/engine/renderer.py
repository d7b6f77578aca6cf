"""The Renderer, flat pipeline (counterpart of
``zrenderer_tpu/engine/renderer.py``).

* ``load_scene`` flattens the scene once and uploads the buffers to the
  renderer's device, behind generational pool handles.
* ``render`` computes the per-draw object_to_clip matrices on the host,
  stages them in the pinned upload ring, copies them to the device without
  blocking and enqueues the frame: column geometry, the raster dispatch
  (``raster.select_raster``: K1, K3, K4, K4c, K5 or K6), the RGBA8 unpack
  and the crop.  It returns before the device is done; ``present`` paces
  the host to ``frames_in_flight`` frames ahead with CUDA events,
  ``read_frame`` copies the newest frame back.
* ``render_animation`` renders N frames back to back with no host sync
  inside the loop, reducing each padded packed frame to a digest.

Everything runs on the one explicit ``device``; ``device="cuda"`` on a
host without a card raises.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from zrenderer_tpu_torch.device import resolve_device
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.pools import PipelineCache, ResourcePool
from zrenderer_tpu_torch.engine.stats import FrameStats
from zrenderer_tpu_torch.engine.upload import (
    FlatScene,
    flat_scene_to_device,
    flatten_scene,
)
from zrenderer_tpu_torch.engine.upload_ring import UploadRing
from zrenderer_tpu_torch.ops import raster
from zrenderer_tpu_torch.ops.geometry import view_proj_from_camera

log = logging.getLogger("zrenderer_torch.engine")


def frame_digest(packed) -> torch.Tensor:
    """Sum of a packed plane's u32 values (alpha sets bit 31, so the int32
    bits are masked to u32), exact in int64, returned as f32."""
    return (packed.to(torch.int64) & 0xFFFFFFFF).sum().to(torch.float32)


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
        )
        for h in self._buffer_handles.values():
            self.resources.destroy(h)
        self._buffer_handles = {}
        buffers = flat_scene_to_device(self.flat.host_arrays(), self.device)
        for name, tensor in buffers.items():
            self._buffer_handles[name] = self.resources.add((name, tensor))
        f = self.flat
        log.info(
            "scene uploaded: %d draws, %d verts (%d padded), %d tris "
            "(%d padded)", f.draw_count, f.num_vertices, len(f.positions),
            f.num_triangles, len(f.tri_vidx),
        )

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

        def build():
            def frame(ccols, tri_node, matrices):
                color, depth = raster.render_frame(
                    ccols, tri_node, matrices, cfg.width, cfg.height,
                    cfg.pad_height, cfg.pad_width, binning=cfg.binning,
                )
                return raster.unpack_rgba8(color), depth

            return frame

        return self.pipelines.get_or_create(key, build)

    def camera_matrices(self, camera=None, transforms=None) -> np.ndarray:
        """Host-side per-frame constants: object_to_clip per draw.
        ``transforms``: optional (D, 4, 4) node_to_world overrides."""
        camera = camera if camera is not None else self.scene.active_camera
        vp = view_proj_from_camera(camera, self.config.width,
                                   self.config.height)
        node_to_world = self.flat.node_to_world
        if transforms is not None:
            node_to_world = np.asarray(transforms, np.float32)
        return np.einsum("nij,jk->nik", node_to_world, vp).astype(np.float32)

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

    def render(self, camera=None, transforms=None):
        """Enqueue one frame; returns the device frame
        (rgba (H, W, 4) u8, depth (H, W) f32) without waiting for it."""
        if self.flat is None:
            raise RuntimeError("load_scene first")
        self._pace()
        frame = self._frame_fn()
        b = self._buffers()
        (matrices,) = self._stage_constants(
            [self.camera_matrices(camera, transforms)])
        color, depth = frame(b["corner_cols"], b["tri_node"], matrices)
        self._pending = (color, depth)
        self._in_flight.append(self._fence())
        self.stats.update(
            triangles=self.flat.num_triangles,
            pixels=self.config.width * self.config.height,
        )
        return color, depth

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

    def render_and_read(self, camera=None, transforms=None):
        self.render(camera, transforms)
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
                         transforms_seq=None):
        """Render a frame sequence back to back on the device.

        Per-frame matrices for all N frames are computed on the host and
        uploaded once; then every frame is rendered at the padded size
        and reduced to a digest (``frame_digest``) with no host sync in
        the loop.  The presented frame is rendered once more afterwards,
        cropped and unpacked.  Returns ``(digests (N,) f32, (color,
        depth))``; reading the digests is a true fence.
        """
        if self.flat is None:
            raise RuntimeError("load_scene first")
        if num_frames is None:
            num_frames = (len(transforms_seq) if transforms_seq is not None
                          else len(cameras))
        cfg = self.config
        mats = np.stack([
            self.camera_matrices(
                cameras[i] if cameras is not None else None,
                transforms_seq[i] if transforms_seq is not None else None)
            for i in range(num_frames)
        ])
        mats = torch.from_numpy(mats)
        if self.device.type == "cuda":
            mats = mats.pin_memory()
        mats = mats.to(self.device, non_blocking=True)
        b = self._buffers()
        ccols, tri_node = b["corner_cols"], b["tri_node"]
        digests = torch.empty(num_frames, dtype=torch.float32,
                              device=self.device)
        for i in range(num_frames):
            packed, _ = raster.render_frame(
                ccols, tri_node, mats[i], cfg.width, cfg.height,
                cfg.pad_height, cfg.pad_width, binning=cfg.binning,
                raw_packed=True,
            )
            digests[i] = frame_digest(packed)
        color, depth = self._frame_fn()(ccols, tri_node, mats[-1])
        self._pending = (color, depth)
        self._in_flight.append(self._fence())
        self.stats.update(
            triangles=self.flat.num_triangles * num_frames,
            pixels=cfg.width * cfg.height * num_frames,
        )
        return digests, (color, depth)
