"""The port's engine API (zrenderer_tpu_torch: engine/renderer.py's vertex
shaders, compute and mesh pipelines, dispatch and the debug layer;
engine/pools.py's handles; profiling/ztracy.py; the app's --debug and
--trace) against the JAX package's Renderer on the CPU.

Frame contract (the port's flat frames against the JAX Renderer with
Pallas kernels in interpret mode, docs/RASTER_SPEC.md §5): coverage
exact, depth within 2e-6, u8 within 1 LSB; the shaded shadowed frame
as tests/test_torch_shadow.py holds shadowed frames (u8 within 2 LSB but
where one PCF tap flips).  A shaded frame against the port's own frame of
the scene whose vertices the host moved the same way: bit-exact on every
pipeline (the shader's f32 add is the host's; the shadowed one lit by the
unshaded scene's map, since the shadow pass runs no shader).
"""

import copy
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.engine.config import RenderConfig as JaxConfig
from zrenderer_tpu.engine.renderer import Renderer as JaxRenderer
from zrenderer_tpu.engine.textures import Texture as JaxTexture
from zrenderer_tpu.ops import geometry as jg
from zrenderer_tpu.scene.procedural import make_test_scene as jax_test_scene
from zrenderer_tpu_torch.app.main import main as app_main
from zrenderer_tpu_torch.engine import passes
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.pools import PipelineCache
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.engine.textures import Texture, checkerboard
from zrenderer_tpu_torch.ops import raster
from zrenderer_tpu_torch.ops.mipmap import generate_mip_chain
from zrenderer_tpu_torch.profiling import ztracy
from zrenderer_tpu_torch.scene.procedural import (
    make_test_scene,
    make_triangle_soup,
)

torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCENE_DIR = os.path.join(ROOT, "content", "scenes", "test_scene")
W, H = 96, 64
SHIFT = 0.5  # the exact shader's x offset


def _shift_torch(positions, attrs):
    """The exact shader: x + 0.5 in object space."""
    return torch.cat([positions[:, :1] + SHIFT, positions[:, 1:]], 1), attrs


def _shift_jax(positions, attrs):
    return positions.at[:, 0].add(SHIFT), attrs


def _moved_scene():
    """The test scene with every vertex's x moved by SHIFT on the host."""
    scene, md = make_test_scene()
    md = copy.deepcopy(md)
    v = md.vertex_data.reshape(-1, 16)
    v[:, 0] += np.float32(SHIFT)
    return scene, md


def _assert_frames_close(img, depth, ref_img, ref_depth):
    assert img.shape == ref_img.shape and img.dtype == np.uint8
    assert (depth < 1.0).mean() > 0.05
    np.testing.assert_array_equal(depth < 1.0, ref_depth < 1.0)
    np.testing.assert_allclose(depth, ref_depth, rtol=0, atol=2e-6)
    assert np.abs(img.astype(np.int32) - ref_img.astype(np.int32)).max() <= 1


def _port(pipeline="flat", scene_md=None, **kw):
    r = Renderer(RenderConfig(width=W, height=H, pipeline=pipeline,
                              tri_align=64, **kw), device="cpu")
    r.load_scene(*(scene_md or make_test_scene()))
    if pipeline in ("lit", "shadowed"):
        r.set_environment(texture=Texture.from_array(checkerboard(64)))
    return r


# -- pools --------------------------------------------------------------------


def test_pipeline_cache_handle_api():
    cache = PipelineCache()
    h = cache.add_pipeline("exe")
    assert cache.lookup_pipeline(h) == "exe"
    cache.destroy_pipeline(h)
    assert cache.lookup_pipeline(h) is None
    h2 = cache.add_pipeline("exe2")  # the slot comes back, a new generation
    assert (h2.index, h2.generation) == (h.index, h.generation + 1)
    assert cache.lookup_pipeline(h) is None
    # Destroying a keyed pipeline's handle drops its content key too.
    assert cache.get_or_create("k", lambda: "keyed") == "keyed"
    keyed = cache._cache["k"]
    cache.destroy_pipeline(keyed)
    assert "k" not in cache._cache and len(cache) == 0
    assert cache.get_or_create("k", lambda: "rebuilt") == "rebuilt"
    assert cache.misses == 2


# -- vertex shaders -------------------------------------------------------------


def test_vertex_shader_flat_matches_jax():
    port = _port()
    port.set_vertex_shader(_shift_torch, name="shift")
    img, depth = port.render_and_read()
    ref = JaxRenderer(JaxConfig(width=W, height=H, backend="pallas",
                                debug=True, tri_align=64))
    ref.load_scene(*jax_test_scene())
    ref.set_vertex_shader(_shift_jax, name="shift")
    ref_img, ref_depth = ref.render_and_read()
    _assert_frames_close(img, depth, np.asarray(ref_img),
                         np.asarray(ref_depth))
    base, _ = _port().render_and_read()
    assert (img != base).any()


def test_wobble_shader_changes_and_unbinding_restores():
    """tests/test_engine.py's wobble: the image changes, unbinding gives
    the column path's frame back bit for bit, and the shader's key joins
    the pipeline cache's."""
    r = _port()
    base, base_depth = r.render_and_read()

    def wobble(positions, attrs):
        offs = 0.35 * torch.sin(positions[:, 1:2] * 9.0)
        return torch.cat([positions[:, :1] + offs, positions[:, 1:]], 1), attrs

    r.set_vertex_shader(wobble, name="wobble-v1")
    warped, _ = r.render_and_read()
    assert (warped != base).any()
    assert len(r.pipelines) == 2
    r.set_vertex_shader(None)
    again, again_depth = r.render_and_read()
    np.testing.assert_array_equal(again, base)
    np.testing.assert_array_equal(again_depth, base_depth)
    assert r.pipelines.hits == 1


@pytest.mark.parametrize("pipeline", ["flat", "lit", "shadowed",
                                      "deferred"])
def test_vertex_shader_equals_the_host_moved_scene(pipeline, monkeypatch):
    """Each pipeline's shaded frame equals its frame of the host-moved
    scene, bit for bit, in render and in render_animation.  The light
    frustum is fitted to the bound buffers, not the shader's output, so
    the moved scene's renderer takes the shaded one's.  The shadow pass
    runs no shader (the reference's ``_depth_only``): the shaded frame's
    map is the unshaded scene's, and the moved scene's frame is lit by
    that map."""
    shaded = _port(pipeline)
    shaded.set_vertex_shader(_shift_torch, name="shift")
    moved = _port(pipeline, _moved_scene())
    img, depth = shaded.render_and_read()
    if pipeline == "shadowed":
        moved._static_light_vp = shaded._light_view_proj()
        unshaded = _port(pipeline)
        unshaded.render()
        shadow_map = shaded._shadow_map
        assert torch.equal(shadow_map, unshaded._shadow_map)
        monkeypatch.setattr(passes, "_depth_only",
                            lambda *args, **kw: shadow_map)
    ref_img, ref_depth = moved.render_and_read()
    assert (depth < 1.0).mean() > 0.05
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(depth.view(np.int32),
                                  ref_depth.view(np.int32))
    cams = [shaded.scene.active_camera] * 2
    digests, _ = shaded.render_animation(cameras=cams)
    ref_digests, _ = moved.render_animation(cameras=cams)
    np.testing.assert_array_equal(digests.numpy(), ref_digests.numpy())


# Pixels of the shaded 96x64 shadowed frame where one PCF tap may flip
# against the JAX Renderer: 0.2% of the covered pixels, as in
# tests/test_torch_shadow.py (a 1-ulp depth difference can move a D16
# texel or a threshold across an integer).
MAX_FLIPPED_SHADED_PX = 0.002


def test_vertex_shader_shadowed_matches_jax():
    """The shaded shadowed frame and its map against the JAX Renderer's
    (Pallas in interpret mode) at shadow_size 128: the shader moves the
    camera's geometry and leaves the shadow pass alone in both.  Coverage
    exact, depth and map within 2e-6, u8 within 2 LSB but on at most
    MAX_FLIPPED_SHADED_PX of the covered pixels, each off by one tap."""
    port = _port("shadowed", shadow_size=128)
    port.set_vertex_shader(_shift_torch, name="shift")
    img, depth = port.render_and_read()
    ref = JaxRenderer(JaxConfig(width=W, height=H, pipeline="shadowed",
                                backend="pallas", debug=True, tri_align=64,
                                shadow_size=128))
    ref.load_scene(*jax_test_scene())
    ref.set_environment(texture=JaxTexture.from_array(checkerboard(64)))
    ref.set_vertex_shader(_shift_jax, name="shift")
    ref_img, ref_depth = (np.asarray(x) for x in ref.render_and_read())
    covered = depth < 1.0
    assert covered.mean() > 0.05
    np.testing.assert_array_equal(covered, ref_depth < 1.0)
    np.testing.assert_allclose(depth, ref_depth, rtol=0, atol=2e-6)
    np.testing.assert_allclose(port._shadow_map.numpy(),
                               np.asarray(ref._shadow_map), rtol=0,
                               atol=2e-6)
    diff = np.abs(img.astype(np.int32) - ref_img.astype(np.int32)).max(-1)
    assert (diff > 2).sum() <= MAX_FLIPPED_SHADED_PX * covered.sum()
    assert diff.max() <= 29  # a whole tap of 9: up to 255/9 LSB
    unshaded, _ = _port("shadowed", shadow_size=128).render_and_read()
    assert (img != unshaded).any()


def test_clip_overflow_follows_the_shaded_vertices():
    """A soup whose triangles straddle the camera's plane overflows the
    capped clipper: the debug count equals the reference's
    ``clip_overflow_count`` on the same buffers; a shader that shrinks the
    soup to the origin, far in front of the camera, drops nothing; and
    unbinding it gives the count back."""
    scene, md = make_triangle_soup(20000, seed=3, extent=14.0,
                                   triangle_size=3.0)
    r = Renderer(RenderConfig(width=W, height=H), device="cpu")
    r.load_scene(scene, md)
    mats = r.camera_matrices()
    b = {k: v.numpy() for k, v in r._buffers().items()}
    ref = int(jg.clip_overflow_count(np, b["positions"], b["attrs"],
                                     b["tri_vidx"], mats, b["vert_node"],
                                     W, H))
    assert ref > 0
    assert r.clip_overflow(mats) == ref

    def shrink(positions, attrs):
        return positions * torch.tensor([0.01, 0.01, 0.01, 1.0]), attrs

    r.set_vertex_shader(shrink, name="shrink")
    assert r.clip_overflow(mats) == 0
    r.set_vertex_shader(None)
    assert r.clip_overflow(mats) == ref


# -- compute and mesh pipelines -------------------------------------------------


def test_compute_pipeline_create_dispatch_destroy():
    r = Renderer(RenderConfig(width=W, height=H), device="cpu")
    h = r.create_compute_pipeline(lambda img: generate_mip_chain(img, 3),
                                  static_argnums=())
    img = torch.ones((16, 16, 4)) * 0.5
    chain = r.dispatch(h, img)
    direct = generate_mip_chain(img, 3)
    assert len(chain) == 3 and tuple(chain[1].shape) == (8, 8, 4)
    for a, b in zip(chain, direct):
        assert torch.equal(a, b)
    np.testing.assert_allclose(chain[2].numpy(), 0.5)
    r.destroy_pipeline(h)
    with pytest.raises(RuntimeError, match="stale"):
        r.dispatch(h, img)


N_GRID = 6  # tests/test_engine.py's n x n grid of quads


def _grid_np():
    """tests/test_engine.py's grid: quads in the z = 0 plane, red from
    height, green 0.25 (the device-computed field)."""
    n = N_GRID
    xs = np.linspace(-1.0, 1.0, n + 1, dtype=np.float32)
    px, py = np.meshgrid(xs, xs, indexing="xy")
    v = (n + 1) * (n + 1)
    positions = np.stack([px.ravel(), py.ravel(), np.zeros(v, np.float32),
                          np.ones(v, np.float32)], axis=1)
    attrs = np.zeros((v, 12), np.float32)
    attrs[:, 2] = (py.ravel() + 1.0) * 0.5
    attrs[:, 3] = 0.3
    attrs[:, 5] = 1.0
    cell = np.arange(n * n, dtype=np.int32)
    r0 = (cell // n) * (n + 1) + (cell % n)
    quads = np.stack([r0, r0 + 1, r0 + n + 2, r0, r0 + n + 2, r0 + n + 1],
                     axis=1)
    return positions, attrs, quads.reshape(-1, 3), np.zeros(v, np.int32)


def test_mesh_pipeline_matches_jax_and_the_buffer_path():
    scene, _ = make_test_scene()
    mats = raster.tg.view_proj_from_camera(scene.active_camera, W,
                                           H)[None].astype(np.float32)

    def grid_torch():
        p, a, t, vn = (torch.from_numpy(x) for x in _grid_np())
        a = a.clone()
        a[:, 4] = p[:, 0] * 0.0 + 0.25  # one field computed on the device
        return p, a, t, vn

    def grid_jax():
        p, a, t, vn = _grid_np()
        a = jnp.asarray(a).at[:, 4].set(jnp.asarray(p)[:, 0] * 0.0 + 0.25)
        return jnp.asarray(p), a, jnp.asarray(t), jnp.asarray(vn)

    r = Renderer(RenderConfig(width=W, height=H, vert_align=32,
                              tri_align=64), device="cpu")
    handle = r.create_mesh_pipeline(grid_torch)
    color, depth = r.dispatch(handle, torch.from_numpy(mats))
    color, depth = color.numpy(), depth.numpy()

    ref = JaxRenderer(JaxConfig(width=W, height=H, backend="pallas",
                                debug=True, vert_align=32, tri_align=64))
    ref_color, ref_depth = ref.dispatch(ref.create_mesh_pipeline(grid_jax),
                                        mats)
    _assert_frames_close(color, depth, np.asarray(ref_color),
                         np.asarray(ref_depth))

    # The same geometry padded on the host, through the indexed entry.
    p, a, t, vn = _grid_np()
    a[:, 4] = 0.25
    pad_v, pad_t = -len(p) % 32, -len(t) % 64
    p = np.concatenate([p, np.zeros((pad_v, 4), np.float32)])
    a = np.concatenate([a, np.zeros((pad_v, 12), np.float32)])
    vn = np.concatenate([vn, np.zeros(pad_v, np.int32)])
    t = np.concatenate([t, np.zeros((pad_t, 3), np.int32)])
    packed, d = raster.render_frame_indexed(
        *(torch.from_numpy(x) for x in (p, a, t, vn)),
        torch.from_numpy(mats), W, H, r.config.pad_height,
        r.config.pad_width)
    np.testing.assert_array_equal(color, raster.unpack_rgba8(packed).numpy())
    np.testing.assert_array_equal(depth, d.numpy())
    assert (color[..., :3].sum(-1) > 0).any()
    geometry = r.pipelines.lookup_pipeline(handle).geometry()
    assert [tuple(x.shape) for x in geometry] == [(64, 4), (64, 12), (128, 3),
                                                  (64,)]
    r.destroy_pipeline(handle)
    with pytest.raises(RuntimeError, match="stale"):
        r.dispatch(handle, torch.from_numpy(mats))


def test_mesh_pipeline_honours_supersample_and_binning():
    """The port's mesh pipeline renders at the config's supersample and
    binning (the reference's runs auto at 1x): at supersample=2 its frame
    is the resolve of the 2x frame of the same geometry, and every binning
    gives auto's frame."""
    scene, _ = make_test_scene()
    grid = lambda: tuple(torch.from_numpy(x) for x in _grid_np())  # noqa: E731
    frames = {}
    for binning in ("auto", "small", "hierarchy", "tile_lists"):
        r = Renderer(RenderConfig(width=W, height=H, binning=binning),
                     device="cpu")
        mats = torch.from_numpy(raster.tg.view_proj_from_camera(
            scene.active_camera, W, H)[None].astype(np.float32))
        frames[binning] = r.dispatch(r.create_mesh_pipeline(grid), mats)
    for binning, (color, depth) in frames.items():
        assert torch.equal(color, frames["auto"][0]), binning
        assert torch.equal(depth, frames["auto"][1]), binning
    r2 = Renderer(RenderConfig(width=W, height=H, supersample=2),
                  device="cpu")
    big = Renderer(RenderConfig(width=2 * W, height=2 * H), device="cpu")
    color, depth = r2.dispatch(r2.create_mesh_pipeline(grid), mats)
    want = raster.ssaa_resolve(*big.dispatch(big.create_mesh_pipeline(grid),
                                             mats), 2)
    assert tuple(color.shape) == (H, W, 4)
    assert torch.equal(color, want[0]) and torch.equal(depth, want[1])


# -- the debug layer ------------------------------------------------------------


def test_debug_validation_mode():
    """tests/test_engine.py's debug test: a debug frame passes validation
    and equals the frame without debug; a NaN depth and a depth past 1
    raise FloatingPointError."""
    r = _port(debug=True)
    img, depth = r.render_and_read()
    assert np.isfinite(depth).all() and r.stats.clip_dropped == 0
    np.testing.assert_array_equal(img, _port().render_and_read()[0])
    color = torch.zeros((H, W, 4), dtype=torch.uint8)
    with pytest.raises(FloatingPointError, match="non-finite"):
        r._validate_frame(color, torch.full((H, W), float("nan")))
    with pytest.raises(FloatingPointError, match="outside"):
        r._validate_frame(color, torch.full((H, W), 1.5))
    r._validate_frame(color, np.zeros((H, W), np.float32))


# -- profiling --------------------------------------------------------------


@pytest.fixture
def zones_off():
    """Zones are module state: leave them as the test found them."""
    was = ztracy.is_enabled()
    ztracy.enable(False)
    yield
    ztracy.enable(was)


def test_ztracy_zones(zones_off):
    with ztracy.zone("outer") as z:
        assert z.name == "outer" and z.elapsed() >= 0.0
    z = ztracy.zone_nc("colored", color=0xFF0000)
    z.end()
    z.end()  # a second end is a no-op
    before = ztracy.frame_index()
    ztracy.frame_mark()
    assert ztracy.frame_index() == before + 1
    assert not ztracy.is_enabled()
    ztracy.enable()
    with ztracy.zone_n("on"):
        pass
    ztracy.frame_mark("named")
    ztracy.enable(False)
    ztracy.frame_mark()  # closes the open frame span


def _trace_events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_trace_writes_the_render_zone(tmp_path, zones_off):
    r = _port()
    with ztracy.trace(str(tmp_path)) as capture:
        assert ztracy.is_enabled()
        for _ in range(2):
            r.render()
            r.present()
        r.read_frame()
    assert not ztracy.is_enabled()
    assert os.path.dirname(capture.path) == str(tmp_path)
    names = [e["name"] for e in _trace_events(capture.path)]
    for zone in ("render", "present", "read_frame"):
        assert zone in names, zone
    assert names.count("render") == 2 and names.count("frame") == 2


def test_app_debug_trace_and_ssaa(tmp_path, capsys, zones_off):
    """--debug --trace on the test scene for 3 frames: the trace names the
    load_scene, render and present zones, three frame spans, and each
    render zone lies inside a frame span but the first; --ssaa 2 writes
    frames of the window's size; --ssaa off the flat pipeline raises as
    RenderConfig does."""
    trace_dir = tmp_path / "trace"
    rc = app_main(["--scene", SCENE_DIR, "--width", "128", "--height", "64",
                   "--frames", "3", "--device", "cpu", "--debug",
                   "--trace", str(trace_dir)])
    assert rc == 0
    (path,) = glob.glob(str(trace_dir / "*.json"))
    assert f"trace: {path}" in capsys.readouterr().out
    events = _trace_events(path)
    names = [e["name"] for e in events]
    assert names.count("load_scene") == 1
    assert names.count("render") == 3 and names.count("present") == 3
    frames = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "frame"]
    renders = [e["ts"] for e in events if e["name"] == "render"]
    assert len(frames) == 3
    assert sum(any(a <= t <= b for a, b in frames) for t in renders) == 2

    out = tmp_path / "ssaa"
    assert app_main(["--scene", SCENE_DIR, "--width", "128", "--height", "64",
                     "--frames", "2", "--device", "cpu", "--ssaa", "2",
                     "--out", str(out)]) == 0
    from zrenderer_tpu_torch.utils.png import read_png
    img = read_png(str(out / "frame_0001.png"))
    assert img.shape == (64, 128, 4)
    with pytest.raises(NotImplementedError, match="supersample"):
        app_main(["--scene", SCENE_DIR, "--width", "128", "--height", "64",
                  "--frames", "1", "--device", "cpu", "--ssaa", "2",
                  "--pipeline", "lit"])
