"""Immediate-mode 2D draw list, the ImDrawList analog (counterpart of
``zrenderer_tpu/app/draw_list.py``, a host module copied so the port runs
without the JAX package; ``tests/test_torch_ui.py`` holds ``build`` and
``setup`` byte-equal to the reference's).

Host code appends textured/colored 2D triangles in submission order under
a clip-rect stack, and ``build()`` produces the padded arrays the overlay
pass consumes (``ops/overlay.py``).  All primitives resolve to triangles;
solid shapes sample the UI atlas's white cell (ImGui's white-pixel trick,
one texture for the whole pass).
"""

from __future__ import annotations

import math

import numpy as np

from zrenderer_tpu_torch.app.font import GLYPH_H, GLYPH_W, UIAtlas
from zrenderer_tpu_torch.ops import overlay as ov

f32 = np.float32


def padded_count(n: int, lo: int = 64, hi: int | None = None) -> int:
    """Next power-of-two ≥ n (≥ lo): the triangle arrays pad to a small
    set of sizes that grow with the UI (the growable vertex buffer's
    chunks), so a mostly-empty UI does not pay for the worst-case list."""
    t = lo
    while t < n:
        t *= 2
    return min(t, hi) if hi is not None else t


class DrawList:
    def __init__(self, width: int, height: int, atlas: UIAtlas | None = None):
        self.width = width
        self.height = height
        self.atlas = atlas or UIAtlas()
        self._wu, self._wv = self.atlas.white_uv
        self._clip_stack = [(0, 0, width, height)]
        self._tris: list = []  # (3, 8) float32
        self._scissors: list = []

    # -- clip-rect stack (the scissor rects) ---------------------------------

    def push_clip_rect(self, x0, y0, x1, y1, intersect: bool = True) -> None:
        if intersect:
            cx0, cy0, cx1, cy1 = self._clip_stack[-1]
            x0, y0 = max(x0, cx0), max(y0, cy0)
            x1, y1 = min(x1, cx1), min(y1, cy1)
        self._clip_stack.append((int(x0), int(y0), int(max(x1, x0)), int(max(y1, y0))))

    def pop_clip_rect(self) -> None:
        assert len(self._clip_stack) > 1, "clip stack underflow"
        self._clip_stack.pop()

    # -- primitives -----------------------------------------------------------

    def _vert(self, p, uv, color):
        return [p[0], p[1], uv[0], uv[1], color[0], color[1], color[2], color[3]]

    def add_triangle_filled(self, p0, p1, p2, color, uvs=None) -> None:
        uvs = uvs or [(self._wu, self._wv)] * 3
        self._tris.append(
            np.array(
                [
                    self._vert(p0, uvs[0], color),
                    self._vert(p1, uvs[1], color),
                    self._vert(p2, uvs[2], color),
                ],
                f32,
            )
        )
        self._scissors.append(self._clip_stack[-1])

    def add_quad_filled(self, p0, p1, p2, p3, color, uvs=None) -> None:
        """Quad (two triangles sharing the 0-2 diagonal; the top-left fill
        rule makes the seam watertight under blending)."""
        uvs = uvs or [(self._wu, self._wv)] * 4
        self.add_triangle_filled(p0, p1, p2, color, [uvs[0], uvs[1], uvs[2]])
        self.add_triangle_filled(p0, p2, p3, color, [uvs[0], uvs[2], uvs[3]])

    def add_rect_filled(self, x0, y0, x1, y1, color) -> None:
        self.add_quad_filled((x0, y0), (x1, y0), (x1, y1), (x0, y1), color)

    def add_rect(self, x0, y0, x1, y1, color, thickness: float = 1.0) -> None:
        t = thickness
        self.add_rect_filled(x0, y0, x1, y0 + t, color)  # top
        self.add_rect_filled(x0, y1 - t, x1, y1, color)  # bottom
        self.add_rect_filled(x0, y0 + t, x0 + t, y1 - t, color)  # left
        self.add_rect_filled(x1 - t, y0 + t, x1, y1 - t, color)  # right

    def add_line(self, p0, p1, color, thickness: float = 1.0) -> None:
        dx, dy = p1[0] - p0[0], p1[1] - p0[1]
        n = math.hypot(dx, dy)
        if n == 0.0:
            return
        ox, oy = -dy / n * thickness * 0.5, dx / n * thickness * 0.5
        self.add_quad_filled(
            (p0[0] + ox, p0[1] + oy), (p1[0] + ox, p1[1] + oy),
            (p1[0] - ox, p1[1] - oy), (p0[0] - ox, p0[1] - oy), color,
        )

    def add_circle_filled(self, cx, cy, radius, color, segments: int = 24) -> None:
        pts = [
            (cx + radius * math.cos(2 * math.pi * k / segments),
             cy + radius * math.sin(2 * math.pi * k / segments))
            for k in range(segments)
        ]
        for k in range(1, segments - 1):
            self.add_triangle_filled(pts[0], pts[k], pts[k + 1], color)

    def add_image(self, x0, y0, x1, y1, uv_rect=(0.0, 0.0, 1.0, 1.0),
                  color=(1.0, 1.0, 1.0, 1.0)) -> None:
        """Textured quad (atlas uv space) — the add_image analog."""
        u0, v0, u1, v1 = uv_rect
        self.add_quad_filled(
            (x0, y0), (x1, y0), (x1, y1), (x0, y1), color,
            uvs=[(u0, v0), (u1, v0), (u1, v1), (u0, v1)],
        )

    def add_text(self, x, y, text: str, color, scale: float = 2.0) -> None:
        """Atlas-textured glyph quads; advance = one full cell so adjacent
        glyph quads never overlap (keeps per-pixel layer depth at 1)."""
        cx = float(x)
        for ch in text:
            if ch == "\n":
                cx = float(x)
                y += GLYPH_H * scale
                continue
            if ch != " ":
                self.add_image(
                    cx, y, cx + GLYPH_W * scale, y + GLYPH_H * scale,
                    self.atlas.glyph_uv_rect(ch), color,
                )
            cx += GLYPH_W * scale

    # -- build ----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._tris)

    def clear(self) -> None:
        self._tris.clear()
        self._scissors.clear()
        del self._clip_stack[1:]

    def build(self, max_tris: int | None = None):
        """Padded (verts (T, 3, 8) f32, scissors (T, 4) i32) host arrays.
        Dead pad slots carry an empty scissor (culled in setup)."""
        n = len(self._tris)
        t = max_tris if max_tris is not None else n
        assert n <= t, f"draw list overflow: {n} > {t}"
        verts = np.zeros((t, 3, 8), f32)
        scissors = np.zeros((t, 4), np.int32)
        if n:
            verts[:n] = np.stack(self._tris)
            scissors[:n] = np.asarray(self._scissors, np.int32)
        return verts, scissors

    def setup(self, max_tris: int | None = None):
        """Host-side triangle setup: (tri_i32, tri_f32) NumPy arrays ready
        for the overlay pass."""
        verts, scissors = self.build(max_tris)
        return ov.setup_overlay_triangles(verts, scissors, self.width,
                                          self.height)
