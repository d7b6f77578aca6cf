"""Procedural 5x7 bitmap font and the UI atlas (counterpart of
``zrenderer_tpu/app/font.py``, a host module copied so the port runs
without the JAX package; ``tests/test_torch_ui.py`` holds the glyph table,
the atlas bytes and ``packed_u32`` equal to the reference's).

A compact 5x7 ASCII glyph set, defined below, baked into an (96, 8, 8)
alpha atlas (glyph cell 8x8 with the 5x7 bitmap top-left), and the UI
atlas: the one texture of the overlay pass, glyphs plus a white cell.
"""

from __future__ import annotations

import numpy as np

# Each glyph: 7 strings of 5 cells; '#' = opaque.  Covers printable ASCII
# subset used by the stats line and outliner; unknown chars render as blank.
_GLYPHS = {
    "A": ["  #  ", " # # ", "#   #", "#   #", "#####", "#   #", "#   #"],
    "B": ["#### ", "#   #", "#   #", "#### ", "#   #", "#   #", "#### "],
    "C": [" ### ", "#   #", "#    ", "#    ", "#    ", "#   #", " ### "],
    "D": ["#### ", "#   #", "#   #", "#   #", "#   #", "#   #", "#### "],
    "E": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#####"],
    "F": ["#####", "#    ", "#    ", "#### ", "#    ", "#    ", "#    "],
    "G": [" ### ", "#   #", "#    ", "# ###", "#   #", "#   #", " ### "],
    "H": ["#   #", "#   #", "#   #", "#####", "#   #", "#   #", "#   #"],
    "I": [" ### ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "J": ["  ###", "   # ", "   # ", "   # ", "   # ", "#  # ", " ##  "],
    "K": ["#   #", "#  # ", "# #  ", "##   ", "# #  ", "#  # ", "#   #"],
    "L": ["#    ", "#    ", "#    ", "#    ", "#    ", "#    ", "#####"],
    "M": ["#   #", "## ##", "# # #", "# # #", "#   #", "#   #", "#   #"],
    "N": ["#   #", "##  #", "# # #", "#  ##", "#   #", "#   #", "#   #"],
    "O": [" ### ", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "P": ["#### ", "#   #", "#   #", "#### ", "#    ", "#    ", "#    "],
    "Q": [" ### ", "#   #", "#   #", "#   #", "# # #", "#  # ", " ## #"],
    "R": ["#### ", "#   #", "#   #", "#### ", "# #  ", "#  # ", "#   #"],
    "S": [" ####", "#    ", "#    ", " ### ", "    #", "    #", "#### "],
    "T": ["#####", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "U": ["#   #", "#   #", "#   #", "#   #", "#   #", "#   #", " ### "],
    "V": ["#   #", "#   #", "#   #", "#   #", "#   #", " # # ", "  #  "],
    "W": ["#   #", "#   #", "#   #", "# # #", "# # #", "## ##", "#   #"],
    "X": ["#   #", "#   #", " # # ", "  #  ", " # # ", "#   #", "#   #"],
    "Y": ["#   #", "#   #", " # # ", "  #  ", "  #  ", "  #  ", "  #  "],
    "Z": ["#####", "    #", "   # ", "  #  ", " #   ", "#    ", "#####"],
    "0": [" ### ", "#   #", "#  ##", "# # #", "##  #", "#   #", " ### "],
    "1": ["  #  ", " ##  ", "  #  ", "  #  ", "  #  ", "  #  ", " ### "],
    "2": [" ### ", "#   #", "    #", "   # ", "  #  ", " #   ", "#####"],
    "3": [" ### ", "#   #", "    #", "  ## ", "    #", "#   #", " ### "],
    "4": ["   # ", "  ## ", " # # ", "#  # ", "#####", "   # ", "   # "],
    "5": ["#####", "#    ", "#### ", "    #", "    #", "#   #", " ### "],
    "6": [" ### ", "#    ", "#    ", "#### ", "#   #", "#   #", " ### "],
    "7": ["#####", "    #", "   # ", "  #  ", " #   ", " #   ", " #   "],
    "8": [" ### ", "#   #", "#   #", " ### ", "#   #", "#   #", " ### "],
    "9": [" ### ", "#   #", "#   #", " ####", "    #", "    #", " ### "],
    ".": ["     ", "     ", "     ", "     ", "     ", " ##  ", " ##  "],
    ",": ["     ", "     ", "     ", "     ", " ##  ", " ##  ", " #   "],
    ":": ["     ", " ##  ", " ##  ", "     ", " ##  ", " ##  ", "     "],
    ";": ["     ", " ##  ", " ##  ", "     ", " ##  ", " #   ", "     "],
    "-": ["     ", "     ", "     ", "#####", "     ", "     ", "     "],
    "+": ["     ", "  #  ", "  #  ", "#####", "  #  ", "  #  ", "     "],
    "*": ["     ", " # # ", "  #  ", "#####", "  #  ", " # # ", "     "],
    "/": ["    #", "    #", "   # ", "  #  ", " #   ", "#    ", "#    "],
    "\\": ["#    ", "#    ", " #   ", "  #  ", "   # ", "    #", "    #"],
    "|": ["  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "  #  "],
    "_": ["     ", "     ", "     ", "     ", "     ", "     ", "#####"],
    "(": ["   # ", "  #  ", " #   ", " #   ", " #   ", "  #  ", "   # "],
    ")": [" #   ", "  #  ", "   # ", "   # ", "   # ", "  #  ", " #   "],
    "[": [" ### ", " #   ", " #   ", " #   ", " #   ", " #   ", " ### "],
    "]": [" ### ", "   # ", "   # ", "   # ", "   # ", "   # ", " ### "],
    "%": ["##  #", "##  #", "   # ", "  #  ", " #   ", "#  ##", "#  ##"],
    "#": [" # # ", " # # ", "#####", " # # ", "#####", " # # ", " # # "],
    "=": ["     ", "     ", "#####", "     ", "#####", "     ", "     "],
    "<": ["   # ", "  #  ", " #   ", "#    ", " #   ", "  #  ", "   # "],
    ">": [" #   ", "  #  ", "   # ", "    #", "   # ", "  #  ", " #   "],
    "'": ["  #  ", "  #  ", "     ", "     ", "     ", "     ", "     "],
    '"': [" # # ", " # # ", "     ", "     ", "     ", "     ", "     "],
    "!": ["  #  ", "  #  ", "  #  ", "  #  ", "  #  ", "     ", "  #  "],
    "?": [" ### ", "#   #", "    #", "   # ", "  #  ", "     ", "  #  "],
    " ": ["     ", "     ", "     ", "     ", "     ", "     ", "     "],
}

GLYPH_W = 8  # atlas cell (5x7 bitmap + spacing)
GLYPH_H = 8
FIRST_CHAR = 32
NUM_CHARS = 96


def build_atlas() -> np.ndarray:
    """(NUM_CHARS, GLYPH_H, GLYPH_W) f32 alpha atlas for ASCII 32..127.
    Lowercase letters map to uppercase bitmaps."""
    atlas = np.zeros((NUM_CHARS, GLYPH_H, GLYPH_W), np.float32)
    for code in range(FIRST_CHAR, FIRST_CHAR + NUM_CHARS):
        ch = chr(code)
        rows = _GLYPHS.get(ch) or _GLYPHS.get(ch.upper())
        if rows is None:
            continue
        for y, row in enumerate(rows):
            for x, cell in enumerate(row):
                if cell == "#":
                    atlas[code - FIRST_CHAR, y, x] = 1.0
    return atlas


def glyph_index(ch: str) -> int:
    code = ord(ch)
    if code < FIRST_CHAR or code >= FIRST_CHAR + NUM_CHARS:
        return 0  # space
    return code - FIRST_CHAR


# ---------------------------------------------------------------------------
# UI atlas: the single overlay texture (glyphs + white cell)
# ---------------------------------------------------------------------------
# ONE texture for the whole GUI pass; solid geometry samples an opaque
# white texel inside it (ImGui's white-pixel trick).  Layout: 16x6 grid of 8x8 glyph
# cells (96 ASCII glyphs, bitmap content at +1,+1 so bilinear sampling never
# bleeds across cells), plus an 8x8 white cell at grid (row 6, col 0).

ATLAS_W = 128
ATLAS_H = 64
CELLS_PER_ROW = ATLAS_W // GLYPH_W  # 16
WHITE_CELL_ROW = NUM_CHARS // CELLS_PER_ROW  # 6


class UIAtlas:
    """The overlay pass's texture + uv metadata."""

    def __init__(self):
        data = np.zeros((ATLAS_H, ATLAS_W, 4), np.uint8)
        for code in range(FIRST_CHAR, FIRST_CHAR + NUM_CHARS):
            ch = chr(code)
            rows = _GLYPHS.get(ch) or _GLYPHS.get(ch.upper())
            if rows is None:
                continue
            idx = code - FIRST_CHAR
            cy = (idx // CELLS_PER_ROW) * GLYPH_H
            cx = (idx % CELLS_PER_ROW) * GLYPH_W
            for y, row in enumerate(rows):
                for x, cell in enumerate(row):
                    if cell == "#":
                        # rgb white, alpha = coverage; +1,+1 bleed margin
                        data[cy + y + 1, cx + x + 1] = (255, 255, 255, 255)
        wy = WHITE_CELL_ROW * GLYPH_H
        data[wy : wy + GLYPH_H, 0:GLYPH_W] = 255
        self.data = data  # (ATLAS_H, ATLAS_W, 4) u8 — the oracle's view
        self._packed = None
        self.white_uv = (
            (0.5 * GLYPH_W) / ATLAS_W,
            (wy + 0.5 * GLYPH_H) / ATLAS_H,
        )

    @property
    def packed_u32(self) -> np.ndarray:
        """(ATLAS_H, ATLAS_W) uint32 RGBA8 (r | g<<8 | b<<16 | a<<24), on
        the host; the overlay pass moves it to the device."""
        if self._packed is None:
            d = self.data.astype(np.uint32)
            self._packed = (d[..., 0] | (d[..., 1] << 8) | (d[..., 2] << 16)
                            | (d[..., 3] << 24))
        return self._packed

    def glyph_uv_rect(self, ch: str):
        """(u0, v0, u1, v1) of the full 8x8 cell for one character."""
        idx = glyph_index(ch)
        cy = (idx // CELLS_PER_ROW) * GLYPH_H
        cx = (idx % CELLS_PER_ROW) * GLYPH_W
        return (
            cx / ATLAS_W,
            cy / ATLAS_H,
            (cx + GLYPH_W) / ATLAS_W,
            (cy + GLYPH_H) / ATLAS_H,
        )
