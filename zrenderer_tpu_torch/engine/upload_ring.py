"""Per-frame host staging ring (counterpart of
``zrenderer_tpu/engine/upload_ring.py``).

Each in-flight frame owns one fixed-size host buffer (pinned when the
target is a CUDA device, so the copy to the card can be asynchronous).
``stage()`` bump-allocates from the current frame's buffer with 512-byte
alignment and returns None when the budget is exhausted; the renderer then
stalls the device, resets the frame's heap and retries.  A buffer is
reused ``frames`` presents later, by which time the renderer's fence
pacing has waited for the frame whose copy read from it.
"""

from __future__ import annotations

import numpy as np
import torch

ALLOC_ALIGNMENT = 512


class UploadRing:
    def __init__(self, frame_bytes: int = 18 * 2**20, frames: int = 2,
                 pin_memory: bool = False):
        if frames < 1 or frame_bytes <= 0:
            raise ValueError("UploadRing needs frames >= 1 and frame_bytes > 0")
        self.frame_bytes = frame_bytes
        self.frames = frames
        self._buffers = [
            torch.empty(frame_bytes, dtype=torch.uint8, pin_memory=pin_memory)
            for _ in range(frames)
        ]
        self._offset = 0
        self._frame = 0
        self.stall_count = 0  # how often back-pressure hit

    def begin_frame(self) -> None:
        """Rotate to the next per-frame buffer."""
        self._frame = (self._frame + 1) % self.frames
        self._offset = 0

    def reset_frame(self) -> None:
        """Reset the current frame's heap after a stall."""
        self._offset = 0

    def stage(self, arr: np.ndarray):
        """Copy ``arr`` into the current frame's buffer; returns a tensor
        view over the pooled storage (same dtype and shape), or None when
        the frame budget is exhausted."""
        arr = np.ascontiguousarray(arr)
        size = arr.nbytes
        aligned = -(-self._offset // ALLOC_ALIGNMENT) * ALLOC_ALIGNMENT
        if aligned + size > self.frame_bytes:
            return None
        buf = self._buffers[self._frame]
        view = buf[aligned:aligned + size].view(
            torch.from_numpy(arr).dtype).reshape(arr.shape)
        view.copy_(torch.from_numpy(arr))
        self._offset = aligned + size
        return view

    def stage_all(self, arrays):
        """Stage a list of arrays atomically; None if any would overflow."""
        saved = self._offset
        out = []
        for a in arrays:
            v = self.stage(a)
            if v is None:
                self._offset = saved
                return None
            out.append(v)
        return out
