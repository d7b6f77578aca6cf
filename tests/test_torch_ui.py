"""The port's UI host modules and app surfaces against the reference's on
the CPU: the font and UI atlas, the draw list, the imgui context, the
camera controller, the overlay oracle, the app's ``--overlay``, ``--ui``
and ``--orbit`` flags and the localhost viewer.

The host modules are copies (zrenderer_tpu_torch/app/font.py,
draw_list.py, imgui.py, camera.py, raster_ref/overlay_cpu.py); these
tests hold each equal to the reference, byte for byte: the atlas and its
packed u32 view, every ``add_*`` primitive's build and setup arrays, the
imgui draw lists and window state over scripted input (the reference's
tests/test_imgui.py scenarios), the camera's matrices, and the oracle's
frames.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from zrenderer_tpu.app import camera as ref_camera
from zrenderer_tpu.app import draw_list as ref_dl
from zrenderer_tpu.app import font as ref_font
from zrenderer_tpu.app import imgui as ref_imgui
from zrenderer_tpu.raster_ref import overlay_cpu as ref_oracle
from zrenderer_tpu.scene.procedural import make_test_scene as ref_test_scene
from zrenderer_tpu_torch.app import camera, draw_list, font, imgui
from zrenderer_tpu_torch.app.main import main as app_main
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.raster_ref import overlay_cpu
from zrenderer_tpu_torch.scene.procedural import make_test_scene
from zrenderer_tpu_torch.utils.png import decode_png, read_png

torch.set_num_threads(1)

W, H = 320, 240


# ---------------------------------------------------------------------------
# Font and atlas
# ---------------------------------------------------------------------------


def test_font_and_atlas_match_reference():
    assert font._GLYPHS == ref_font._GLYPHS
    for name in ("GLYPH_W", "GLYPH_H", "FIRST_CHAR", "NUM_CHARS", "ATLAS_W",
                 "ATLAS_H", "CELLS_PER_ROW", "WHITE_CELL_ROW"):
        assert getattr(font, name) == getattr(ref_font, name), name
    a = font.build_atlas()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, ref_font.build_atlas())
    ours, ref = font.UIAtlas(), ref_font.UIAtlas()
    assert ours.data.dtype == np.uint8
    np.testing.assert_array_equal(ours.data, ref.data)
    packed = ours.packed_u32
    assert packed.dtype == np.uint32 and packed.shape == (font.ATLAS_H,
                                                          font.ATLAS_W)
    np.testing.assert_array_equal(packed, np.asarray(ref.packed_u32))
    assert ours.white_uv == ref.white_uv
    for code in range(0, 140):
        ch = chr(code)
        assert font.glyph_index(ch) == ref_font.glyph_index(ch)
        assert ours.glyph_uv_rect(ch) == ref.glyph_uv_rect(ch)


# ---------------------------------------------------------------------------
# Draw list
# ---------------------------------------------------------------------------

PRIMITIVES = {
    "triangle": lambda dl: dl.add_triangle_filled(
        (3.5, 4.25), (60.0, 9.0), (20.0, 50.5), (0.9, 0.4, 0.1, 0.8)),
    "reversed_triangle": lambda dl: dl.add_triangle_filled(
        (3.5, 4.25), (20.0, 50.5), (60.0, 9.0), (0.2, 0.4, 1.0, 1.0),
        uvs=[(0.1, 0.2), (0.3, 0.9), (0.7, 0.4)]),
    "quad": lambda dl: dl.add_quad_filled(
        (15, 7), (90, 13), (101, 53), (9, 47), (0.5, 0.5, 0.5, 0.5)),
    "rect_filled": lambda dl: dl.add_rect_filled(4, 4, 70, 40,
                                                 (0.1, 0.1, 0.3, 0.8)),
    "rect": lambda dl: dl.add_rect(4, 4, 70, 40, (0.4, 0.9, 0.4, 1.0),
                                   thickness=1.5),
    "line": lambda dl: dl.add_line((0, 60), (127, 30), (1.0, 0.3, 0.8, 0.7),
                                   thickness=2),
    "zero_line": lambda dl: dl.add_line((5, 5), (5, 5), (1, 1, 1, 1)),
    "circle": lambda dl: dl.add_circle_filled(100, 45, 12,
                                              (0.2, 0.6, 0.9, 0.65),
                                              segments=12),
    "image": lambda dl: dl.add_image(200, 20, 264, 52,
                                     (0.0, 0.0, 0.5, 0.5)),
    "text": lambda dl: dl.add_text(5, 5, "Hello, 123!\nAXW?", (1.0, 0.8, 0.2,
                                                              1.0),
                                   scale=2.5),
    "clipped_text": lambda dl: (
        dl.push_clip_rect(10, 10, 52, 34),
        dl.push_clip_rect(0, 0, 40, 200),
        dl.add_text(12, 12, "HELLO 123", (0.0, 0.9, 0.0, 1.0), scale=2),
        dl.pop_clip_rect(),
        dl.push_clip_rect(30, 0, 20, 5, intersect=False),
        dl.add_rect_filled(0, 0, W, H, (1, 1, 1, 1)),
        dl.pop_clip_rect(),
        dl.pop_clip_rect(),
        dl.add_rect_filled(0, 0, 8, 8, (1, 0, 0, 1))),
}


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("prim", sorted(PRIMITIVES))
def test_draw_list_build_and_setup_match_reference(prim, padded):
    ours = draw_list.DrawList(W, H, font.UIAtlas())
    ref = ref_dl.DrawList(W, H, ref_font.UIAtlas())
    for dl in (ours, ref):
        PRIMITIVES[prim](dl)
    assert len(ours) == len(ref)
    n = draw_list.padded_count(len(ours)) if padded else None
    assert n is None or n == ref_dl.padded_count(len(ref))
    for a, b in zip(ours.build(n), ref.build(n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ti, tf = ours.setup(n)
    ri, rf = ref.setup(n)
    np.testing.assert_array_equal(ti, ri)
    np.testing.assert_array_equal(tf.view(np.int32), rf.view(np.int32))
    ours.clear()
    assert len(ours) == 0 and ours.build()[0].shape == (0, 3, 8)


def test_padded_count_matches_reference():
    for n in list(range(0, 300, 7)) + [4096, 5000]:
        assert draw_list.padded_count(n) == ref_dl.padded_count(n)
        assert (draw_list.padded_count(n, lo=16, hi=256)
                == ref_dl.padded_count(n, lo=16, hi=256))


# ---------------------------------------------------------------------------
# imgui: both contexts driven by the same scripted input
# ---------------------------------------------------------------------------


class Twin:
    """A port context and a reference context fed the same events; each
    frame's return value, draw list and window state must be equal."""

    def __init__(self):
        self.ctxs = (imgui.Context(W, H, atlas=font.UIAtlas()),
                     ref_imgui.Context(W, H, atlas=ref_font.UIAtlas()))
        self.state = ({}, {})

    def event(self, name, *args):
        for ctx in self.ctxs:
            getattr(ctx.io, name)(*args)

    def frame(self, build):
        out = []
        for ctx, st in zip(self.ctxs, self.state):
            ctx.new_frame()
            ret = build(ctx, st)
            dl = ctx.render()
            out.append((ret, dl.build(), dict(st)))
        (ret, (v, s), st), (rret, (rv, rs), rst) = out
        assert ret == rret and st == rst
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(s, rs)
        ours, ref = self.ctxs
        assert ours.focus_order == ref.focus_order
        assert (ours.hot_id, ours.active_id, ours.want_capture_mouse) == (
            ref.hot_id, ref.active_id, ref.want_capture_mouse)
        assert sorted(ours.windows) == sorted(ref.windows)
        for name, w in ours.windows.items():
            a = {k: v for k, v in dataclasses.asdict(w).items() if k != "dl"}
            b = {k: v for k, v in dataclasses.asdict(ref.windows[name])
                 .items() if k != "dl"}
            assert a == b, name
        return st, len(v)


def _center(r):
    return ((r[0] + r[2]) / 2, (r[1] + r[3]) / 2)


def _click(twin, build, x, y):
    twin.event("add_mouse_pos_event", x, y)
    twin.frame(build)
    twin.event("add_mouse_button_event", 0, True)
    twin.frame(build)
    twin.event("add_mouse_button_event", 0, False)
    return twin.frame(build)[0]


def _button(twin):
    def build(ui, st):
        ui.begin("Win", pos=(20, 20))
        st["clicked"] = ui.button("Go")
        st["rect"] = ui._prev_item_rect
        ui.end()

    st, _ = twin.frame(build)
    assert _click(twin, build, *_center(st["rect"]))["clicked"] is True


def _checkbox_and_slider(twin):
    def build(ui, st):
        ui.begin("Win", pos=(20, 20))
        _, st["v"] = ui.checkbox("opt", st.get("v", False))
        st["cb"] = ui._prev_item_rect
        _, st["s"] = ui.slider_float("s", st.get("s", 0.0), 0.0, 10.0,
                                     width=100.0)
        st["sl"] = ui._prev_item_rect
        st["n"] = ui.slider_int("n", 3, 0, 8)
        ui.progress_bar(0.4, width=80.0)
        st["sel"] = ui.selectable("pick me", st.get("sel", False))
        ui.end()

    st, _ = twin.frame(build)
    assert _click(twin, build, *_center(st["cb"]))["v"] is True
    r = st["sl"]
    twin.event("add_mouse_pos_event", r[0] + 50.0, _center(r)[1])
    twin.event("add_mouse_button_event", 0, True)
    twin.frame(build)
    twin.event("add_mouse_pos_event", r[0] + 150.0, _center(r)[1])
    st, _ = twin.frame(build)
    assert st["s"] == 10.0
    twin.event("add_mouse_button_event", 0, False)
    twin.frame(build)


def _window_drag_collapse_close(twin):
    def build(ui, st):
        st["vis"] = ui.begin("Win", pos=(50, 50), size=(120, 80))
        if st["vis"]:
            ui.text("body")
        ui.end()
        if st.get("show", True):
            ui.begin("Tool", pos=(150, 120), size=(120, 80), closable=True)
            ui.end()
            if ui.was_closed("Tool"):
                st["show"] = False

    twin.frame(build)
    twin.event("add_mouse_pos_event", 110, 58)  # title bar
    twin.event("add_mouse_button_event", 0, True)
    twin.frame(build)
    twin.event("add_mouse_pos_event", 140, 98)
    twin.frame(build)
    twin.event("add_mouse_button_event", 0, False)
    twin.frame(build)
    assert twin.ctxs[0].windows["Win"].pos == [80, 90]
    st = _click(twin, build, 88, 98)  # the collapse arrow
    assert st["vis"] is False
    r = twin.ctxs[0].windows["Tool"].rect
    st = _click(twin, build, r[2] - 8, r[1] + 11)  # the close box
    assert st["show"] is False


def _overlap_scroll_and_leave(twin):
    def build(ui, st):
        ui.begin("Back", pos=(20, 20), size=(150, 100))
        st["back"] = ui.button("B")
        for k in range(30):
            ui.text(f"row {k}")
        ui.end()
        ui.begin("Front", pos=(60, 40), size=(150, 100))
        st["front"] = ui.button("F")
        st["rect"] = ui._prev_item_rect
        if ui.collapsing_header("Section"):
            ui.bullet_text("inner")
            ui.separator()
            ui.text_disabled("disabled")
        ui.end()

    st, _ = twin.frame(build)
    assert _click(twin, build, *_center(st["rect"]))["front"] is True
    _click(twin, build, 100, 28)  # raise Back
    assert twin.ctxs[0].focus_order == ["Front", "Back"]
    twin.event("add_mouse_pos_event", 80, 80)
    twin.event("add_mouse_wheel_event", 0.0, -2.0)
    twin.frame(build)
    assert twin.ctxs[0].windows["Back"].scroll_y > 0.0
    twin.event("add_mouse_button_event", 0, True)
    twin.frame(build)
    twin.event("mouse_leave")
    twin.frame(build)
    twin.event("add_mouse_button_event", 0, False)
    twin.frame(build)


def _outliner(twin):
    scene, _ = make_test_scene()

    def build(ui, st):
        ui.begin("Stats", pos=(8, 8))
        ui.text("FPS: 60.0  CPU time: 16.667 ms")
        ui.end()
        ui.begin("Scene Outliner", pos=(8, 70))
        for node in scene.nodes:
            ui.bullet_text("")
            ui.same_line()
            ui.text_colored((0.0, 0.8, 0.0, 1.0), node.name)
        ui.end()

    _, n = twin.frame(build)
    assert n > 10


SCENARIOS = {
    "button_click": _button,
    "checkbox_slider_widgets": _checkbox_and_slider,
    "window_drag_collapse_close": _window_drag_collapse_close,
    "overlap_scroll_leave": _overlap_scroll_and_leave,
    "outliner": _outliner,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_imgui_draw_lists_match_reference(scenario):
    SCENARIOS[scenario](Twin())


# ---------------------------------------------------------------------------
# Camera controller
# ---------------------------------------------------------------------------


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_quat_and_forward_match_reference():
    for pitch, yaw in ((0.0, 0.0), (0.3, -1.2), (-1.5, 2.9), (1.55, 0.7)):
        np.testing.assert_array_equal(
            _bits(camera.forward_from_pitch_yaw(pitch, yaw)),
            _bits(ref_camera.forward_from_pitch_yaw(pitch, yaw)))


def test_camera_controller_matches_reference():
    (scene, _), (ref_scene, _) = make_test_scene(), ref_test_scene()
    ours = camera.CameraController(scene.active_camera)
    ref = ref_camera.CameraController(ref_scene.active_camera)
    steps = [
        ("look", (0.2, -0.4), {}), ("look", (2.0, 0.1), {}),
        ("move", (), dict(forward=0.5, right=-0.25, up=0.1)),
        ("look", (-3.5, 1.0), {}), ("move", (), dict(forward=-1.0)),
        ("orbit", ((0.0, 0.5, 0.0), 6.5, 0.7, 0.35), {}),
        ("move", (), dict(right=2.0)),
        ("orbit", ((1.0, 0.0, -2.0), 3.0, -2.2, -0.2), {}),
    ]
    for name, args, kw in steps:
        getattr(ours, name)(*args, **kw)
        getattr(ref, name)(*args, **kw)
        a, b = ours.camera, ref.camera
        np.testing.assert_array_equal(_bits(a.position), _bits(b.position))
        np.testing.assert_array_equal(_bits(a.forward), _bits(b.forward))
        assert (a.pitch, a.yaw) == (b.pitch, b.yaw)
    assert ours.camera.pitch == pytest.approx(np.arcsin(
        np.clip(ours.camera.forward[1], -1, 1)))


# ---------------------------------------------------------------------------
# The overlay oracle
# ---------------------------------------------------------------------------


def test_overlay_oracle_matches_reference():
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (96, 160, 4), np.uint8)
    ours = draw_list.DrawList(160, 96, font.UIAtlas())
    for prim in ("quad", "circle", "text", "clipped_text", "line", "image"):
        PRIMITIVES[prim](ours)
    verts, sc = ours.build()
    a, ca = overlay_cpu.composite_overlay_cpu(frame, verts, sc,
                                              font.UIAtlas().data,
                                              return_count=True)
    b, cb = ref_oracle.composite_overlay_cpu(frame, verts, sc,
                                             ref_font.UIAtlas().data,
                                             return_count=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    assert ca.max() >= 2 and (a != frame).any()


# ---------------------------------------------------------------------------
# The app's --overlay, --ui and --orbit, and the viewer (CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """The procedural test scene written as a scene folder."""
    d = tmp_path_factory.mktemp("scene")
    scene, mesh_data = ref_test_scene()
    scene.save(d / "scene.bin")
    mesh_data.save(d / "meshes.bin")
    return d


def _app(scene_dir, out, *extra, w=256, h=128, frames=1):
    return app_main(["--scene", str(scene_dir), "--width", str(w),
                     "--height", str(h), "--frames", str(frames), "--out",
                     str(out), "--device", "cpu", *extra])


def _greens(img):
    return ((img[..., 1] > 150) & (img[..., 0] < 100)).sum()


def test_app_overlay_burns_in_stats(scene_dir, tmp_path):
    assert _app(scene_dir, tmp_path, "--overlay") == 0
    img = read_png(tmp_path / "frame_0000.png")
    assert img.shape == (128, 256, 4)
    assert _greens(img) > 20
    assert _app(scene_dir, tmp_path / "plain") == 0
    plain = read_png(tmp_path / "plain" / "frame_0000.png")
    assert _greens(plain) == 0


def test_app_imgui_ui_burns_in_windows(scene_dir, tmp_path):
    assert _app(scene_dir, tmp_path, "--ui", h=160) == 0
    img = read_png(tmp_path / "frame_0000.png")
    assert _greens(img) > 20  # the outliner's node names
    blues = (img[..., 2] > 90) & (img[..., 2] > img[..., 1])
    assert blues.sum() > 100  # two title bars


def test_app_orbit_moves_camera(scene_dir, tmp_path):
    assert _app(scene_dir, tmp_path, "--orbit", "--overlay", w=128, h=64,
                frames=3) == 0
    a = read_png(tmp_path / "frame_0000.png")
    b = read_png(tmp_path / "frame_0002.png")
    assert (a != b).any()


def test_app_ui_without_out_drops_frames(scene_dir, capsys):
    rc = app_main(["--scene", str(scene_dir), "--width", "128", "--height",
                   "64", "--frames", "2", "--device", "cpu", "--ui",
                   "--pipeline", "deferred", "--taa"])
    assert rc == 0
    assert "FPS" in capsys.readouterr().out


@pytest.fixture()
def viewer():
    from zrenderer_tpu_torch.app.viewer import Viewer

    scene, mesh_data = make_test_scene()
    v = Viewer(scene, mesh_data, RenderConfig(width=W, height=H), port=0,
               device="cpu")
    yield v
    v.close()


def _get(viewer, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{viewer.port}{path}", timeout=10) as r:
        return r.status, r.read()


def _post(viewer, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{viewer.port}{path}", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status


def _events(viewer, events):
    assert _post(viewer, "/events", json.dumps(events).encode()) == 200


def test_viewer_endpoints_and_ui_drag(viewer):
    status, body = _get(viewer, "/")
    assert status == 200 and b"zrenderer-tpu" in body
    viewer.step()
    status, png = _get(viewer, "/frame.png")
    img = decode_png(png)
    assert status == 200 and img.shape == (H, W, 4)
    assert (img[..., :3].sum(axis=-1) > 0).mean() > 0.1
    assert _greens(img) > 20  # the UI windows are burnt in
    state = json.loads(_get(viewer, "/state")[1])
    assert state["frame"] == 1 and "FPS" in state["stats"]
    w = viewer.ctx.windows["Stats"]
    x0, y0 = w.pos
    _events(viewer, [{"t": "move", "x": x0 + 60, "y": y0 + 10},
                     {"t": "down", "b": 0}])
    viewer.step()
    yaw0 = viewer.camera.camera.yaw
    _events(viewer, [{"t": "move", "x": x0 + 90, "y": y0 + 30},
                     {"t": "up", "b": 0}])
    viewer.step()
    assert w.pos == [x0 + 30, y0 + 20]
    assert viewer.camera.camera.yaw == yaw0  # the UI captured the drag


def test_viewer_camera_routing_and_quit(viewer):
    viewer.step()
    yaw0 = viewer.camera.camera.yaw
    _events(viewer, [{"t": "move", "x": W - 30, "y": H - 30},
                     {"t": "down", "b": 0}])
    viewer.step()
    _events(viewer, [{"t": "move", "x": W - 60, "y": H - 30},
                     {"t": "bogus"}, "not a dict", {"t": "down"}])
    viewer.step()
    assert viewer.camera.camera.yaw != yaw0
    _events(viewer, [{"t": "up", "b": 0}])
    viewer.step()
    pos0 = np.asarray(viewer.camera.camera.position).copy()
    _events(viewer, [{"t": "key", "k": "w", "down": True}])
    viewer.step()
    viewer.step()
    _events(viewer, [{"t": "key", "k": "w", "down": False}])
    viewer.step()
    assert np.linalg.norm(np.asarray(viewer.camera.camera.position)
                          - pos0) > 0.0
    assert _post(viewer, "/quit", b"") == 200
    n = viewer.shared.frame_index
    viewer.run(max_frames=100, target_fps=0.0)
    assert viewer.shared.stop is True and viewer.shared.frame_index == n


def test_ui_takes_the_callers_device():
    from zrenderer_tpu_torch.app.overlay_ui import ImguiOverlay, OverlayUI

    for cls in (OverlayUI, ImguiOverlay):
        assert cls(64, 32, device="cpu").atlas_dev.device.type == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                cls(64, 32)  # the default device is the card, no fallback
