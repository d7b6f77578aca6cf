"""Overlay UI: the stats line and the scene outliner on the 2D overlay pass
(counterpart of ``zrenderer_tpu/app/overlay_ui.py``).

``OverlayUI`` draws one imgui-style panel (translucent background, border,
atlas-textured glyph quads); ``ImguiOverlay`` runs the full imgui
``Context`` with a Stats window and the Scene Outliner window.  Both build
their draw lists on the host and composite them with ``overlay_pass``
(``ops/overlay.py``) on their device: K8 and K8b on a card, the plain
versions on the CPU.  The device is the caller's (the renderer's); there
is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from zrenderer_tpu_torch.app import font
from zrenderer_tpu_torch.app.draw_list import DrawList, padded_count
from zrenderer_tpu_torch.app.imgui import Context
from zrenderer_tpu_torch.device import resolve_device
from zrenderer_tpu_torch.ops.overlay import overlay_pass

PANEL_COLOR = (0.06, 0.06, 0.10, 0.82)
BORDER_COLOR = (0.25, 0.55, 0.25, 1.0)
TEXT_COLOR = (0.0, 0.9, 0.0, 1.0)  # the outliner's green
MAX_TRIS = 4096


def atlas_on(atlas: font.UIAtlas, device) -> torch.Tensor:
    """The packed atlas as an (h, w) int32 tensor of its u32 bits."""
    return torch.from_numpy(atlas.packed_u32.view(np.int32)).to(device)


def compose_draw_list(frame_u8, dl: DrawList, atlas_dev: torch.Tensor,
                      min_tris: int = 64) -> np.ndarray:
    """Composite finished draw data onto a frame on ``atlas_dev``'s device;
    returns the (H, W, 4) uint8 frame on the host.  ``frame_u8`` is a
    NumPy array or a tensor on any device.  The triangle arrays pad to
    power-of-two sizes that grow with the UI."""
    dev = atlas_dev.device
    ti, tf = dl.setup(padded_count(len(dl), lo=min_tris))
    frame = torch.as_tensor(frame_u8).to(dev).contiguous()
    out = overlay_pass(frame, torch.from_numpy(ti).to(dev),
                       torch.from_numpy(tf).to(dev), atlas_dev)
    return out.cpu().numpy()


class OverlayUI:
    def __init__(self, width: int, height: int, scale: int = 2,
                 device="cuda", max_tris: int = MAX_TRIS):
        self.width = width
        self.height = height
        self.scale = scale
        self.max_tris = max_tris
        self.atlas = font.UIAtlas()
        self.device = resolve_device(device)
        self.atlas_dev = atlas_on(self.atlas, self.device)

    def draw_panel(self, dl: DrawList, lines, origin=(8, 8)) -> None:
        """One imgui-style window: translucent background, border, text."""
        gw = font.GLYPH_W * self.scale
        gh = font.GLYPH_H * self.scale
        pad = 6
        max_cols = max((len(l) for l in lines), default=0)
        x0, y0 = origin[0] - pad, origin[1] - pad
        x1 = origin[0] + max_cols * gw + pad
        y1 = origin[1] + len(lines) * gh + pad
        dl.add_rect_filled(x0, y0, x1, y1, PANEL_COLOR)
        dl.add_rect(x0, y0, x1, y1, BORDER_COLOR, thickness=1)
        # Text clips to the panel interior (the window scissor).
        dl.push_clip_rect(x0 + 1, y0 + 1, x1 - 1, y1 - 1)
        for row, line in enumerate(lines):
            dl.add_text(origin[0], origin[1] + row * gh, line, TEXT_COLOR,
                        scale=self.scale)
        dl.pop_clip_rect()

    def draw_list(self, lines) -> DrawList:
        dl = DrawList(self.width, self.height, self.atlas)
        self.draw_panel(dl, list(lines))
        return dl

    def compose(self, frame_u8, lines) -> np.ndarray:
        """Blend the stats/outliner panel onto a frame on the device."""
        return compose_draw_list(frame_u8, self.draw_list(lines),
                                 self.atlas_dev)


class ImguiOverlay:
    """The imgui-window UI: a Stats window and the Scene Outliner window,
    composited by the overlay pass.  Headless apps call :meth:`compose`
    with no input; an interactive host (the viewer) feeds ``ctx.io`` first,
    which makes the windows draggable and collapsible live."""

    OUTLINER_GREEN = (0.0, 0.8, 0.0, 1.0)

    def __init__(self, width: int, height: int, device="cuda"):
        self.ctx = Context(width, height)
        self.device = resolve_device(device)
        self.atlas_dev = atlas_on(self.ctx.atlas, self.device)

    def build(self, stats_line: str, scene) -> None:
        """Submit the frame's windows (between new_frame and render)."""
        ctx = self.ctx
        if ctx.begin("Stats", pos=(8, 8)):
            ctx.text(stats_line)
        ctx.end()
        if ctx.begin("Scene Outliner", pos=(8, 70)):
            for node in scene.nodes:
                ctx.bullet_text("")
                ctx.same_line()
                ctx.text_colored(self.OUTLINER_GREEN, node.name)
        ctx.end()

    def draw_list(self, stats_line: str, scene) -> DrawList:
        """One UI frame with no new input: the windows' draw list."""
        self.ctx.new_frame()
        self.build(stats_line, scene)
        return self.ctx.render()

    def compose_dl(self, frame_u8, dl: DrawList) -> np.ndarray:
        return compose_draw_list(frame_u8, dl, self.atlas_dev)

    def compose(self, frame_u8, stats_line: str, scene) -> np.ndarray:
        return self.compose_dl(frame_u8, self.draw_list(stats_line, scene))
