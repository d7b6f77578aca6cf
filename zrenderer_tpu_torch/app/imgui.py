"""Immediate-mode GUI, the Dear ImGui analog, built on the overlay pass
(counterpart of ``zrenderer_tpu/app/imgui.py``, a host module copied so the
port runs without the JAX package; ``tests/test_torch_ui.py`` holds its
draw lists equal to the reference's for scripted input).

- :class:`InputState`, the ImGuiIO analog: an event QUEUE (mouse pos /
  button / wheel / key / char, the AddEvent API a window's message pump
  calls) drained once per frame so a press+release arriving in one frame
  still registers as a click.
- :class:`Context`: windows (drag by title bar, collapse arrow, close
  button, focus/z-order, auto-size, wheel scrolling + scrollbar) and
  widgets (text, bullet_text, text_colored, same_line, separator, button,
  checkbox, slider_float/int, progress_bar, selectable, collapsing_header)
  with the classic hot/active id protocol (mouse capture on the active
  widget, ids from label hashes with ``##`` suffix and push_id scoping).
- Each window owns its own :class:`DrawList`; ``render()`` concatenates
  them back-to-front (focus order) like ImGui's draw-data lists, so
  overlapping translucent windows composite correctly through the overlay
  pass (``ops/overlay.py``).

No device work happens here: this is host-side UI logic; the device
boundary is the overlay pass.
"""

from __future__ import annotations

import dataclasses
import zlib

from zrenderer_tpu_torch.app import font
from zrenderer_tpu_torch.app.draw_list import DrawList

# ---------------------------------------------------------------------------
# Style (one dark theme; the ImGuiStyle analog)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Style:
    text: tuple = (0.90, 0.90, 0.90, 1.00)
    text_disabled: tuple = (0.50, 0.50, 0.50, 1.00)
    window_bg: tuple = (0.06, 0.06, 0.10, 0.92)
    title_bg: tuple = (0.16, 0.29, 0.48, 1.00)
    title_bg_inactive: tuple = (0.10, 0.15, 0.25, 1.00)
    border: tuple = (0.43, 0.43, 0.50, 0.50)
    frame_bg: tuple = (0.16, 0.29, 0.48, 0.54)
    frame_bg_hot: tuple = (0.26, 0.59, 0.98, 0.40)
    frame_bg_active: tuple = (0.26, 0.59, 0.98, 0.67)
    button: tuple = (0.26, 0.59, 0.98, 0.40)
    button_hot: tuple = (0.26, 0.59, 0.98, 0.70)
    button_active: tuple = (0.06, 0.53, 0.98, 1.00)
    check_mark: tuple = (0.26, 0.59, 0.98, 1.00)
    slider_grab: tuple = (0.24, 0.52, 0.88, 1.00)
    slider_grab_active: tuple = (0.26, 0.59, 0.98, 1.00)
    header: tuple = (0.26, 0.59, 0.98, 0.31)
    header_hot: tuple = (0.26, 0.59, 0.98, 0.60)
    scrollbar_bg: tuple = (0.02, 0.02, 0.02, 0.53)
    scrollbar_grab: tuple = (0.31, 0.31, 0.31, 1.00)
    window_padding: int = 8
    item_spacing: int = 4
    inner_spacing: int = 4
    text_scale: int = 2
    title_bar_h: int = 22
    scrollbar_w: int = 10

    @property
    def glyph_w(self) -> int:
        return font.GLYPH_W * self.text_scale

    @property
    def line_h(self) -> int:
        return font.GLYPH_H * self.text_scale

    def text_w(self, s: str) -> int:
        return len(s) * self.glyph_w


# ---------------------------------------------------------------------------
# Input: event queue + per-frame snapshot (the ImGuiIO analog)
# ---------------------------------------------------------------------------

NUM_MOUSE_BUTTONS = 3  # left, right, middle


class InputState:
    """Queued input events, drained once per :meth:`Context.new_frame`.

    The feed methods mirror the ImGuiIO_Add*Event calls a window's message
    pump makes; any host event source (the interactive viewer, a replay
    script, tests) feeds them.
    """

    def __init__(self):
        self._events: list[tuple] = []
        # Live (post-drain) state, owned by the Context between frames.
        self.mouse_pos = (-1.0e30, -1.0e30)  # offscreen = WM_MOUSELEAVE
        self.mouse_down = [False] * NUM_MOUSE_BUTTONS
        self.keys_down: set[str] = set()

    # -- the WndProc-analog feed API ---------------------------------------

    def add_mouse_pos_event(self, x: float, y: float) -> None:
        self._events.append(("pos", float(x), float(y)))

    def add_mouse_button_event(self, button: int, down: bool) -> None:
        if 0 <= button < NUM_MOUSE_BUTTONS:
            self._events.append(("button", button, bool(down)))

    def add_mouse_wheel_event(self, wx: float, wy: float) -> None:
        self._events.append(("wheel", float(wx), float(wy)))

    def add_key_event(self, key: str, down: bool) -> None:
        self._events.append(("key", key, bool(down)))

    def add_input_character(self, ch: str) -> None:
        self._events.append(("char", ch))

    def mouse_leave(self) -> None:
        """The cursor left the window: park it offscreen."""
        self._events.append(("pos", -1.0e30, -1.0e30))


class FrameInput:
    """One frame's drained input snapshot."""

    def __init__(self, io: InputState):
        self.prev_mouse_pos = io.mouse_pos
        self.mouse_clicked = [False] * NUM_MOUSE_BUTTONS
        self.mouse_released = [False] * NUM_MOUSE_BUTTONS
        self.wheel = 0.0
        self.wheel_x = 0.0
        self.chars: list[str] = []
        self.keys_pressed: set[str] = set()
        for ev in io._events:
            kind = ev[0]
            if kind == "pos":
                io.mouse_pos = (ev[1], ev[2])
            elif kind == "button":
                _, b, down = ev
                if down and not io.mouse_down[b]:
                    self.mouse_clicked[b] = True
                if not down and io.mouse_down[b]:
                    self.mouse_released[b] = True
                io.mouse_down[b] = down
            elif kind == "wheel":
                self.wheel_x += ev[1]
                self.wheel += ev[2]
            elif kind == "key":
                _, key, down = ev
                if down and key not in io.keys_down:
                    self.keys_pressed.add(key)
                (io.keys_down.add if down else io.keys_down.discard)(key)
            elif kind == "char":
                self.chars.append(ev[1])
        io._events.clear()
        self.mouse_pos = io.mouse_pos
        self.mouse_down = list(io.mouse_down)
        # Delta is zero whenever EITHER endpoint is the offscreen park
        # value (mouse_leave), else a leave mid-drag teleports windows by
        # ~1e30 px.
        onscreen = (self.prev_mouse_pos[0] > -1.0e29
                    and self.mouse_pos[0] > -1.0e29)
        self.mouse_delta = (
            (self.mouse_pos[0] - self.prev_mouse_pos[0],
             self.mouse_pos[1] - self.prev_mouse_pos[1])
            if onscreen else (0.0, 0.0)
        )


def _in_rect(p, r) -> bool:
    return r[0] <= p[0] < r[2] and r[1] <= p[1] < r[3]


# ---------------------------------------------------------------------------
# Window state (persists across frames — the ImGuiWindow analog)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowState:
    name: str
    pos: list
    size: list  # outer size; [0, 0] = auto-size from content
    collapsed: bool = False
    scroll_y: float = 0.0
    content_h: float = 0.0  # measured last frame (for auto-size + scroll max)
    content_w: float = 0.0
    rect: tuple = (0, 0, 0, 0)  # outer rect last frame (hit testing)
    auto_size: bool = True
    dl: DrawList | None = None  # per-frame; rebuilt in begin()


class Context:
    """The ImGui context: persistent UI state + per-frame submission."""

    def __init__(self, width: int, height: int, style: Style | None = None,
                 atlas: font.UIAtlas | None = None):
        self.width = width
        self.height = height
        self.style = style or Style()
        self.atlas = atlas or font.UIAtlas()
        self.io = InputState()
        self.windows: dict[str, WindowState] = {}
        self.focus_order: list[str] = []  # back ... front
        self.hot_id = 0
        self.active_id = 0
        self._active_window: str | None = None  # window owning active_id
        self.frame: FrameInput | None = None
        self._hovered_window: str | None = None
        self._submitted: list[str] = []
        self._cur: WindowState | None = None
        self._id_stack: list[int] = []
        self._cursor = [0.0, 0.0]
        self._line_start_x = 0.0
        self._line_max_y = 0.0
        self._prev_item_rect = (0, 0, 0, 0)
        self._same_line = False
        self._closed_this_frame: set[str] = set()
        self._next_hot = 0
        self.want_capture_mouse = False
        self._header_state: dict = {}

    # -- ids ----------------------------------------------------------------

    def _id(self, label: str) -> int:
        """Stable widget id: window ⊕ push_id stack ⊕ label (text after
        '##' is id-only, like ImGui)."""
        seed = self._id_stack[-1] if self._id_stack else 0
        return zlib.crc32(label.encode(), seed) or 1

    def push_id(self, s) -> None:
        seed = self._id_stack[-1] if self._id_stack else 0
        self._id_stack.append(zlib.crc32(str(s).encode(), seed) or 1)

    def pop_id(self) -> None:
        self._id_stack.pop()

    @staticmethod
    def _visible_label(label: str) -> str:
        return label.split("##", 1)[0]

    # -- frame lifecycle ------------------------------------------------------

    def new_frame(self) -> None:
        self.frame = FrameInput(self.io)
        f = self.frame
        # Hovered window: topmost (front of focus_order) whose LAST-frame
        # rect contains the mouse — the one-frame-lag hit test ImGui uses
        # for inter-window routing.
        self._hovered_window = None
        for name in reversed(self.focus_order):
            w = self.windows.get(name)
            if w is not None and _in_rect(f.mouse_pos, w.rect):
                self._hovered_window = name
                break
        # Click focuses (brings to front) the hovered window.
        if any(f.mouse_clicked) and self._hovered_window is not None:
            self.focus_order.remove(self._hovered_window)
            self.focus_order.append(self._hovered_window)
        if not f.mouse_down[0] and self.active_id and \
                not f.mouse_released[0]:
            # Lost a release event (e.g. released outside the host window).
            self.active_id = 0
        self.hot_id = self._next_hot
        self._next_hot = 0
        self._submitted = []
        self._closed_this_frame.clear()
        self.want_capture_mouse = (
            self._hovered_window is not None or self.active_id != 0
        )

    # -- windows --------------------------------------------------------------

    def begin(self, title: str, pos=None, size=None,
              closable: bool = False) -> bool:
        """Start a window (igBegin).  Returns False when collapsed —
        callers may skip widget submission but MUST still call end().
        With ``closable=True`` a close box is drawn; a click on it is
        reported by :meth:`was_closed` (the p_open out-param analog) and
        the caller then stops submitting the window."""
        assert self._cur is None, "begin() without end()"
        st = self.style
        w = self.windows.get(title)
        if w is None:
            default_pos = [30 + 25 * len(self.windows),
                           30 + 25 * len(self.windows)]
            w = WindowState(
                name=title,
                pos=list(pos) if pos is not None else default_pos,
                size=list(size) if size is not None else [0.0, 0.0],
                auto_size=size is None,
            )
            self.windows[title] = w
            self.focus_order.append(title)
        elif size is not None and w.auto_size:
            w.size = list(size)
            w.auto_size = False
        if title not in self.focus_order:  # re-opened after a closed frame
            self.focus_order.append(title)
        self._cur = w
        self._submitted.append(title)
        self._id_stack = [zlib.crc32(title.encode()) or 1]
        w.dl = DrawList(self.width, self.height, self.atlas)
        f = self.frame
        focused = self.focus_order and self.focus_order[-1] == title

        # Auto-size from last frame's measured content.
        if w.auto_size:
            w.size[0] = max(st.text_w(self._visible_label(title))
                            + 6 * st.window_padding,
                            w.content_w + 2 * st.window_padding)
            w.size[1] = st.title_bar_h + (
                0 if w.collapsed else w.content_h + 2 * st.window_padding)

        x0, y0 = w.pos
        x1, y1 = x0 + w.size[0], y0 + w.size[1]
        title_rect = (x0, y0, x1, y0 + st.title_bar_h)

        # --- title-bar interactions (drag, collapse arrow, close box) ------
        hoverable = self._hovered_window == title and self.active_id == 0
        move_id = self._id("##move")
        arrow_rect = (x0 + 4, y0 + 4, x0 + st.title_bar_h - 4,
                      y0 + st.title_bar_h - 4)
        close_rect = (x1 - st.title_bar_h + 4, y0 + 4, x1 - 4,
                      y0 + st.title_bar_h - 4)
        if hoverable and _in_rect(f.mouse_pos, title_rect) and \
                f.mouse_clicked[0]:
            if _in_rect(f.mouse_pos, arrow_rect):
                w.collapsed = not w.collapsed
            elif closable and _in_rect(f.mouse_pos, close_rect):
                self._closed_this_frame.add(title)
            else:
                self.active_id = move_id
                self._active_window = title
        if self.active_id == move_id and self._active_window == title:
            w.pos[0] += f.mouse_delta[0]
            w.pos[1] += f.mouse_delta[1]
            x0, y0 = w.pos
            x1, y1 = x0 + w.size[0], y0 + w.size[1]
            title_rect = (x0, y0, x1, y0 + st.title_bar_h)
            if f.mouse_released[0]:
                self.active_id = 0

        body_y0 = y0 + st.title_bar_h
        outer = (x0, y0, x1, y0 + st.title_bar_h) if w.collapsed else \
            (x0, y0, x1, y1)
        w.rect = outer

        # Chrome is DRAWN in end() (prepended under the content) so an
        # auto-sized window's frame matches the content measured THIS frame
        # — no first-frame lag.  Stash what end() needs.
        close_hot = closable and hoverable and _in_rect(f.mouse_pos,
                                                        close_rect)
        self._chrome = (focused, closable, close_hot)

        if w.collapsed:
            # Empty scissor: a caller that ignores the False return and
            # submits widgets anyway gets them clipped away, not painted
            # over the scene.  end() pops this.
            w.dl.push_clip_rect(0, 0, 0, 0, intersect=False)
            self._cursor = [x0, body_y0]
            self._content_min_y = body_y0
            self._open = False
            return False

        # --- content region (scrolled + clipped) ----------------------------
        inner = (x0 + 1, body_y0, x1 - 1, y1 - 1)
        # Scroll math uses the un-inset body height (the 1px clip border is
        # cosmetic) so an exactly-fitting auto-sized window never scrolls.
        view_h = max(y1 - body_y0 - 2 * st.window_padding, 1.0)
        max_scroll = max(0.0, w.content_h - view_h)
        if hoverable and _in_rect(f.mouse_pos, inner) and f.wheel:
            w.scroll_y -= f.wheel * 3 * (st.line_h + st.item_spacing)
        w.scroll_y = min(max(w.scroll_y, 0.0), max_scroll)
        self._scrollbar = (inner, view_h, max_scroll)
        if w.auto_size:
            # Content defines the window; clip only against the screen so a
            # growing window shows all of this frame's content immediately.
            w.dl.push_clip_rect(x0 + 1, body_y0, self.width, self.height)
        else:
            w.dl.push_clip_rect(*inner)
        self._cursor = [x0 + st.window_padding,
                        body_y0 + st.window_padding - w.scroll_y]
        self._line_start_x = self._cursor[0]
        self._line_max_y = self._cursor[1]
        self._content_min_y = self._cursor[1]
        self._content_max_x = self._cursor[0]
        self._same_line = False
        self._open = True
        return True

    def was_closed(self, title: str) -> bool:
        """True the frame the user clicked a closable window's close box."""
        return title in self._closed_this_frame

    def end(self) -> None:
        assert self._cur is not None, "end() without begin()"
        st = self.style
        w = self._cur
        focused, closable, close_hot = self._chrome
        w.dl.pop_clip_rect()  # content clip (open) or empty clip (collapsed)
        if self._open:
            w.content_h = self._cursor[1] - self._content_min_y
            w.content_w = self._content_max_x - (w.pos[0] + st.window_padding)
            if w.auto_size:
                # Re-derive size + hit-test rect from the JUST-measured
                # content: chrome and routing track content with no lag.
                w.size[0] = max(st.text_w(self._visible_label(w.name))
                                + 6 * st.window_padding,
                                w.content_w + 2 * st.window_padding)
                w.size[1] = (st.title_bar_h + w.content_h
                             + 2 * st.window_padding)
                w.rect = (w.pos[0], w.pos[1], w.pos[0] + w.size[0],
                          w.pos[1] + w.size[1])

        x0, y0 = w.pos
        x1 = x0 + w.size[0]
        y1 = y0 + (st.title_bar_h if w.collapsed else w.size[1])
        body_y0 = y0 + st.title_bar_h

        # --- chrome (under the content → prepend) ---------------------------
        cd = DrawList(self.width, self.height, self.atlas)
        if not w.collapsed:
            cd.add_rect_filled(x0, body_y0, x1, y1, st.window_bg)
        cd.add_rect_filled(x0, y0, x1, y0 + st.title_bar_h,
                           st.title_bg if focused else st.title_bg_inactive)
        cd.add_rect(x0, y0, x1, y1, st.border)
        ax, ay = x0 + 6, y0 + st.title_bar_h / 2  # collapse arrow
        s = 5
        if w.collapsed:
            cd.add_triangle_filled((ax, ay - s), (ax + 2 * s, ay),
                                   (ax, ay + s), st.text)
        else:
            cd.add_triangle_filled((ax - s + 3, ay - s + 2),
                                   (ax + s + 3, ay - s + 2),
                                   (ax + 3, ay + s), st.text)
        cd.add_text(x0 + st.title_bar_h + 2,
                    y0 + (st.title_bar_h - st.line_h) / 2,
                    self._visible_label(w.name), st.text,
                    scale=st.text_scale)
        if closable:
            cc = st.button_hot if close_hot else st.text_disabled
            cx = x1 - st.title_bar_h / 2
            cy = y0 + st.title_bar_h / 2
            cd.add_line((cx - 4, cy - 4), (cx + 4, cy + 4), cc, 2)
            cd.add_line((cx - 4, cy + 4), (cx + 4, cy - 4), cc, 2)
        w.dl._tris[:0] = cd._tris
        w.dl._scissors[:0] = cd._scissors

        # --- scrollbar (over the content → append) --------------------------
        if self._open and not w.auto_size:
            inner, view_h, max_scroll = self._scrollbar
            if max_scroll > 0:
                dl = w.dl
                sb_x1 = x1 - 2
                sb_x0 = sb_x1 - st.scrollbar_w
                dl.add_rect_filled(sb_x0, inner[1], sb_x1, inner[3],
                                   st.scrollbar_bg)
                g_h = max(12.0, view_h * view_h / w.content_h)
                g_y = inner[1] + (w.scroll_y / max_scroll) * (view_h - g_h)
                dl.add_rect_filled(sb_x0 + 1, g_y, sb_x1 - 1, g_y + g_h,
                                   st.scrollbar_grab)
        self._cur = None

    # -- layout ---------------------------------------------------------------

    def same_line(self, spacing: float | None = None) -> None:
        """Place the next item on the previous item's line (igSameLine)."""
        sp = self.style.inner_spacing if spacing is None else spacing
        self._cursor = [self._prev_item_rect[2] + sp, self._prev_item_rect[1]]
        self._same_line = True

    def _item(self, w: float, h: float) -> tuple:
        """Advance the layout cursor; returns the item rect.  Tracks the
        tallest item on the current line so a new line starts below all
        same_line() items."""
        x, y = self._cursor
        rect = (x, y, x + w, y + h)
        self._prev_item_rect = rect
        if self._same_line:
            self._line_max_y = max(self._line_max_y, rect[3])
        else:
            self._line_max_y = rect[3]
        self._content_max_x = max(self._content_max_x, rect[2])
        self._cursor = [self._line_start_x,
                        self._line_max_y + self.style.item_spacing]
        self._same_line = False
        return rect

    def _behavior(self, rect, wid: int) -> tuple[bool, bool, bool]:
        """Hot/active protocol: returns (hovered, held, clicked)."""
        f = self.frame
        hovered = (
            self._hovered_window == self._cur.name
            and (self.active_id in (0, wid))
            and _in_rect(f.mouse_pos, rect)
            and _in_rect(f.mouse_pos, self._cur.dl._clip_stack[-1])
        )
        if hovered:
            self._next_hot = wid
        clicked = False
        if hovered and f.mouse_clicked[0] and self.active_id == 0:
            self.active_id = wid
            self._active_window = self._cur.name
        held = self.active_id == wid and self._active_window == self._cur.name
        if held and f.mouse_released[0]:
            clicked = hovered  # fire on release-inside (ImGui default)
            self.active_id = 0
        return hovered, held, clicked

    # -- widgets ----------------------------------------------------------------

    def text(self, s: str, color=None) -> None:
        st = self.style
        for line in s.split("\n"):
            rect = self._item(st.text_w(line), st.line_h)
            self._cur.dl.add_text(rect[0], rect[1], line,
                                  color or st.text, scale=st.text_scale)

    def text_colored(self, color, s: str) -> None:
        self.text(s, color=color)

    def text_disabled(self, s: str) -> None:
        self.text(s, color=self.style.text_disabled)

    def bullet_text(self, s: str) -> None:
        """igBulletText: small filled circle + text on one line."""
        st = self.style
        r = st.line_h * 0.2
        rect = self._item(2 * r + 4, st.line_h)
        self._cur.dl.add_circle_filled(
            rect[0] + r, rect[1] + st.line_h / 2, r, st.text, segments=10)
        self.same_line()
        self.text(s)

    def separator(self) -> None:
        st = self.style
        w = self._cur
        x1 = w.pos[0] + w.size[0] - st.window_padding
        rect = self._item(max(1.0, x1 - self._cursor[0]), 3)
        self._cur.dl.add_rect_filled(rect[0], rect[1] + 1, x1, rect[1] + 2,
                                     st.border)

    def button(self, label: str, size=None) -> bool:
        st = self.style
        vis = self._visible_label(label)
        bw = size[0] if size else st.text_w(vis) + 2 * st.window_padding
        bh = size[1] if size else st.line_h + 6
        rect = self._item(bw, bh)
        wid = self._id(label)
        hovered, held, clicked = self._behavior(rect, wid)
        col = st.button_active if held else (
            st.button_hot if hovered else st.button)
        dl = self._cur.dl
        dl.add_rect_filled(*rect, col)
        dl.add_text(rect[0] + (bw - st.text_w(vis)) / 2,
                    rect[1] + (bh - st.line_h) / 2, vis, st.text,
                    scale=st.text_scale)
        return clicked

    def checkbox(self, label: str, value: bool) -> tuple[bool, bool]:
        st = self.style
        box = st.line_h + 4
        vis = self._visible_label(label)
        rect = self._item(box + st.inner_spacing + st.text_w(vis), box)
        wid = self._id(label)
        hovered, held, clicked = self._behavior(rect, wid)
        if clicked:
            value = not value
        dl = self._cur.dl
        brect = (rect[0], rect[1], rect[0] + box, rect[1] + box)
        dl.add_rect_filled(*brect, st.frame_bg_active if held else
                           (st.frame_bg_hot if hovered else st.frame_bg))
        if value:
            pad = box * 0.25
            dl.add_rect_filled(brect[0] + pad, brect[1] + pad,
                               brect[2] - pad, brect[3] - pad, st.check_mark)
        dl.add_text(brect[2] + st.inner_spacing,
                    rect[1] + (box - st.line_h) / 2, vis, st.text,
                    scale=st.text_scale)
        return clicked, value

    def slider_float(self, label: str, value: float, vmin: float,
                     vmax: float, fmt: str = "{:.3f}",
                     width: float = 160.0) -> tuple[bool, float]:
        st = self.style
        vis = self._visible_label(label)
        h = st.line_h + 6
        rect = self._item(width + st.inner_spacing + st.text_w(vis), h)
        frame = (rect[0], rect[1], rect[0] + width, rect[1] + h)
        wid = self._id(label)
        hovered, held, _ = self._behavior(frame, wid)
        changed = False
        if held:
            t = (self.frame.mouse_pos[0] - frame[0]) / max(width, 1.0)
            t = min(max(t, 0.0), 1.0)
            nv = vmin + t * (vmax - vmin)
            changed = nv != value
            value = nv
        dl = self._cur.dl
        dl.add_rect_filled(*frame, st.frame_bg_active if held else
                           (st.frame_bg_hot if hovered else st.frame_bg))
        t = 0.0 if vmax == vmin else (value - vmin) / (vmax - vmin)
        t = min(max(t, 0.0), 1.0)
        gw = 10.0
        gx = frame[0] + 2 + t * (width - 4 - gw)
        dl.add_rect_filled(gx, frame[1] + 2, gx + gw, frame[3] - 2,
                           st.slider_grab_active if held else st.slider_grab)
        txt = fmt.format(value)
        dl.add_text(frame[0] + (width - st.text_w(txt)) / 2,
                    rect[1] + (h - st.line_h) / 2, txt, st.text,
                    scale=st.text_scale)
        dl.add_text(frame[2] + st.inner_spacing,
                    rect[1] + (h - st.line_h) / 2, vis, st.text,
                    scale=st.text_scale)
        return changed, value

    def slider_int(self, label: str, value: int, vmin: int, vmax: int,
                   width: float = 160.0) -> tuple[bool, int]:
        changed, v = self.slider_float(label, float(value), float(vmin),
                                       float(vmax), fmt="{:.0f}",
                                       width=width)
        v = int(round(v))
        return v != value, v

    def progress_bar(self, fraction: float, width: float = 160.0,
                     overlay: str | None = None) -> None:
        st = self.style
        h = st.line_h + 4
        rect = self._item(width, h)
        dl = self._cur.dl
        dl.add_rect_filled(*rect, st.frame_bg)
        f = min(max(fraction, 0.0), 1.0)
        if f > 0:
            dl.add_rect_filled(rect[0] + 1, rect[1] + 1,
                               rect[0] + 1 + f * (width - 2), rect[3] - 1,
                               st.check_mark)
        if overlay:
            dl.add_text(rect[0] + (width - st.text_w(overlay)) / 2,
                        rect[1] + (h - st.line_h) / 2, overlay, st.text,
                        scale=st.text_scale)

    def selectable(self, label: str, selected: bool = False) -> bool:
        st = self.style
        w = self._cur
        vis = self._visible_label(label)
        x1 = w.pos[0] + w.size[0] - st.window_padding
        rect = self._item(max(st.text_w(vis), x1 - self._cursor[0]),
                          st.line_h + 2)
        wid = self._id(label)
        hovered, held, clicked = self._behavior(rect, wid)
        if selected or hovered or held:
            self._cur.dl.add_rect_filled(
                *rect, st.header_hot if (hovered or held) else st.header)
        self._cur.dl.add_text(rect[0], rect[1] + 1, vis, st.text,
                              scale=st.text_scale)
        return clicked

    def collapsing_header(self, label: str, default_open: bool = False) -> bool:
        """Persistent open/closed section header; returns open state."""
        st = self.style
        w = self._cur
        key = ("hdr", w.name, label)
        open_now = self._header_state.setdefault(key, default_open)
        vis = self._visible_label(label)
        x1 = w.pos[0] + w.size[0] - st.window_padding
        rect = self._item(max(st.text_w(vis) + st.line_h + 6,
                              x1 - self._cursor[0]), st.line_h + 4)
        wid = self._id(label)
        hovered, held, clicked = self._behavior(rect, wid)
        if clicked:
            open_now = not open_now
            self._header_state[key] = open_now
        dl = self._cur.dl
        dl.add_rect_filled(*rect,
                           st.header_hot if (hovered or held) else st.header)
        ax = rect[0] + 4
        ay = (rect[1] + rect[3]) / 2
        s = 5
        if open_now:
            dl.add_triangle_filled((ax, ay - s + 2), (ax + 2 * s, ay - s + 2),
                                   (ax + s, ay + s), st.text)
        else:
            dl.add_triangle_filled((ax, ay - s), (ax + 2 * s, ay),
                                   (ax, ay + s), st.text)
        dl.add_text(rect[0] + st.line_h + 2,
                    rect[1] + (rect[3] - rect[1] - st.line_h) / 2, vis,
                    st.text, scale=st.text_scale)
        return open_now

    # -- render -----------------------------------------------------------------

    def render(self) -> DrawList:
        """Merge per-window draw lists back-to-front (focus order) into one
        submission-order list — the igRender/draw-data analog."""
        assert self._cur is None, "render() inside begin()/end()"
        # Drop state for windows not submitted this frame.
        self.focus_order = [n for n in self.focus_order
                            if n in self._submitted]
        out = DrawList(self.width, self.height, self.atlas)
        for name in self.focus_order:
            w = self.windows.get(name)
            if w is not None and w.dl is not None:
                out._tris.extend(w.dl._tris)
                out._scissors.extend(w.dl._scissors)
        return out
