"""The port's flat frame path as a whole (zrenderer_tpu_torch.engine,
zrenderer_tpu_torch.app) against the JAX package's Renderer with Pallas
kernels in interpret mode, plus the engine's host-side contracts.

Frame contract: u8 within 1 LSB, coverage exact, depth within 2e-6
(docs/RASTER_SPEC.md §5: XLA:CPU contracts the interpret kernels' f32
chains); animation digests within rtol 1e-5 (the reference sums the u32
plane in f32, the port exactly in int64).

The JAX Renderer gets an identity vertex shader: that routes its frame
through the indexed geometry stage (the oracle's, bit-identical to the
column stage on these frames) instead of the column stage, whose jit
compile alone takes about 36 s on one CPU core.  Kernels, dispatch,
staging and digests are the Renderer's own.
"""

import ast
import dataclasses
import glob
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from zrenderer_tpu.engine.config import RenderConfig as JaxConfig
from zrenderer_tpu.engine.renderer import Renderer as JaxRenderer
from zrenderer_tpu.math import zmath as zm
from zrenderer_tpu.raster_ref import render_scene_cpu
from zrenderer_tpu.scene.mesh import MeshData
from zrenderer_tpu.scene.procedural import make_test_scene
from zrenderer_tpu.scene.scene import Scene
from zrenderer_tpu.utils.png import read_png
from zrenderer_tpu_torch.app.main import main as app_main
from zrenderer_tpu_torch.device import resolve_device
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.pools import PipelineCache, ResourcePool
from zrenderer_tpu_torch.engine.renderer import Renderer, frame_digest
from zrenderer_tpu_torch.engine.stats import FrameStats
from zrenderer_tpu_torch.engine.upload_ring import UploadRing

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCENE_DIR = os.path.join(ROOT, "content", "scenes", "test_scene")
SHOWCASE_DIR = os.path.join(ROOT, "content", "scenes", "showcase")
SHOWCASE_GLTF = os.path.join(ROOT, "content", "scenes", "showcase_src",
                             "showcase.gltf")
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")


def _scene():
    return (Scene.load(os.path.join(SCENE_DIR, "scene.bin")),
            MeshData.load(os.path.join(SCENE_DIR, "meshes.bin")))


def _moved_transforms(renderer):
    """Node 1 moved and turned (the transforms= override)."""
    t = renderer.flat.node_to_world.copy()
    t[1] = (zm.rotation_y(0.6) @ t[1]).astype(np.float32)
    t[1, 3, :3] += np.float32([0.4, -0.3, 0.2])
    return t


def _port_renderer(w, h, binning="auto"):
    r = Renderer(RenderConfig(width=w, height=h, binning=binning),
                 device="cpu")
    r.load_scene(*_scene())
    return r


def _jax_renderer(w, h, binning="auto"):
    r = JaxRenderer(JaxConfig(width=w, height=h, backend="pallas",
                              debug=True, binning=binning))
    r.load_scene(*_scene())
    r.set_vertex_shader(lambda positions, attrs: (positions, attrs),
                        name="identity")
    return r


def _assert_frames_close(img, depth, ref_img, ref_depth):
    assert img.shape == ref_img.shape and img.dtype == np.uint8
    assert (depth < 1.0).mean() > 0.05
    np.testing.assert_array_equal(depth < 1.0, ref_depth < 1.0)
    np.testing.assert_allclose(depth, ref_depth, rtol=0, atol=2e-6)
    assert np.abs(img.astype(np.int32) - ref_img.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("moved", [False, True])
def test_renderer_matches_jax_pallas(moved):
    w, h = 256, 64
    port, ref = _port_renderer(w, h), _jax_renderer(w, h)
    transforms = _moved_transforms(port) if moved else None
    img, depth = port.render_and_read(transforms=transforms)
    ref_img, ref_depth = ref.render_and_read(transforms=transforms)
    _assert_frames_close(img, depth, np.asarray(ref_img),
                         np.asarray(ref_depth))


@pytest.mark.parametrize("binning", ["tile_lists", "hierarchy"])
def test_renderer_binnings_match_jax_pallas(binning):
    """Explicit binnings below the row bound: tile_lists runs K6 and
    hierarchy K3 in both packages."""
    w, h = 256, 64
    img, depth = _port_renderer(w, h, binning).render_and_read()
    ref_img, ref_depth = _jax_renderer(w, h, binning).render_and_read()
    _assert_frames_close(img, depth, np.asarray(ref_img),
                         np.asarray(ref_depth))


def test_render_animation_digests_match_jax():
    w, h = 128, 64
    port, ref = _port_renderer(w, h), _jax_renderer(w, h)
    seq = np.stack([port.flat.node_to_world, _moved_transforms(port)])
    digests, (img, depth) = port.render_animation(transforms_seq=seq)
    ref_digests, (ref_img, ref_depth) = ref.render_animation(
        transforms_seq=seq)
    assert digests.dtype == torch.float32 and digests.shape == (2,)
    np.testing.assert_allclose(digests.numpy(), np.asarray(ref_digests),
                               rtol=1e-5)
    assert digests[0] != digests[1]
    _assert_frames_close(img.numpy(), depth.numpy(), np.asarray(ref_img),
                         np.asarray(ref_depth))


def test_render_animation_cameras_match_single_frames():
    """Per-frame cameras: each digest is the u32 sum of the frame that
    render() gives for that camera (128x64 needs no padding)."""
    r = _port_renderer(128, 64)
    cam = r.scene.active_camera
    moved = dataclasses.replace(
        cam, position=cam.position + np.float32([0.5, 0.2, -0.4]))
    digests, _ = r.render_animation(cameras=[cam, moved])
    for d, c in zip(digests, (cam, moved)):
        img, _ = r.render_and_read(camera=c)
        packed = (img.astype(np.uint64)
                  << np.uint64([0, 8, 16, 24])).sum(-1)
        assert d.item() == np.float32(packed.sum())
    assert digests[0] != digests[1]


def test_frame_digest_is_the_exact_u32_sum():
    packed = torch.tensor(np.array([[0xFF000000, 0xFFFFFFFF, 1]],
                                   np.uint32).view(np.int32))
    assert frame_digest(packed).item() == np.float32(
        0xFF000000 + 0xFFFFFFFF + 1)


def test_renderer_matches_oracle_at_parity_size():
    """bench.py's parity frame: 256x144 against the NumPy oracle."""
    w, h = 256, 144
    img, depth = _port_renderer(w, h).render_and_read()
    ref_img, ref_depth = render_scene_cpu(*_scene(), w, h)
    diff = np.abs(img.astype(np.int32) - ref_img.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).any(-1).sum() < 50
    np.testing.assert_array_equal(depth < 1.0, ref_depth < 1.0)


def test_port_matches_stored_goldens():
    """The oracle's pinned hash (tests/goldens/test_scene_128x96.sha256)
    and the Pallas renderer's stored flat frame (flat_160x96.png), both
    of the procedural test scene."""
    scene, md = make_test_scene()
    r = Renderer(RenderConfig(width=128, height=96), device="cpu")
    r.load_scene(scene, md)
    img, _ = r.render_and_read()
    with open(os.path.join(GOLDEN_DIR, "test_scene_128x96.sha256")) as f:
        assert hashlib.sha256(img.tobytes()).hexdigest() == f.read().strip()
    r = Renderer(RenderConfig(width=160, height=96, tri_align=64),
                 device="cpu")
    r.load_scene(scene, md)
    img, _ = r.render_and_read()
    np.testing.assert_array_equal(
        img, read_png(os.path.join(GOLDEN_DIR, "flat_160x96.png")))


def test_render_present_read_cycle():
    r = _port_renderer(128, 64)
    color, depth = r.render()
    assert tuple(color.shape) == (64, 128, 4) and color.dtype == torch.uint8
    assert r.present()[0] is color
    r.render()
    r.present()
    img, _ = r.read_frame()
    np.testing.assert_array_equal(img, color.numpy())
    r.finish_gpu_commands()
    r.drain_hard()
    assert r.pipelines.misses == 1 and r.pipelines.hits == 1


def test_upload_ring_stall_reset_retry():
    cfg = RenderConfig(width=128, height=64, upload_heap_bytes=1024,
                       frames_in_flight=1)
    r = Renderer(cfg, device="cpu")
    r.load_scene(*_scene())
    for _ in range(3):  # 512-byte slots: the third render exhausts the heap
        r.render()
    assert r.upload_ring.stall_count == 1
    tiny = Renderer(cfg.with_(upload_heap_bytes=64), device="cpu")
    tiny.load_scene(*_scene())
    with pytest.raises(MemoryError):
        tiny.render()


def test_upload_ring_stage_all_is_atomic():
    ring = UploadRing(frame_bytes=1024, frames=2)
    a = np.arange(16, dtype=np.float32)
    (v,) = ring.stage_all([a])
    np.testing.assert_array_equal(v.numpy(), a)
    assert ring.stage_all([a, np.zeros(300, np.float32)]) is None
    (w,) = ring.stage_all([a])  # the failed batch left no allocation
    assert w.data_ptr() - v.data_ptr() == 512
    ring.begin_frame()
    (x,) = ring.stage_all([a])
    assert x.data_ptr() != v.data_ptr()


def test_pools_detect_stale_handles():
    pool = ResourcePool(capacity=2)
    h = pool.add("a")
    pool.destroy(h)
    assert pool.lookup(h) is None
    h2 = pool.add("b")
    assert h2.index == h.index and h2.generation == h.generation + 1
    cache = PipelineCache()
    assert cache.get_or_create("k", lambda: 1) == 1
    assert cache.get_or_create("k", lambda: 2) == 1
    assert (cache.hits, cache.misses, len(cache)) == (1, 1, 1)


def test_frame_stats_line():
    stats = FrameStats()
    stats.update(triangles=10, pixels=100)
    assert "FPS" in stats.format_line()


def test_config_rejects_unported_options():
    with pytest.raises(ValueError, match="unknown pipeline"):
        RenderConfig(pipeline="forward_plus")
    for pipeline in ("lit", "shadowed", "deferred"):
        assert RenderConfig(pipeline=pipeline).pipeline == pipeline
    with pytest.raises(ValueError, match="lighting_planes"):
        RenderConfig(pipeline="deferred", lighting_planes="f16")
    for size in (96, 160, 1000, 0):  # not a multiple of both 32 and 128
        with pytest.raises(ValueError, match="shadow_size"):
            RenderConfig(pipeline="shadowed", shadow_size=size)
    assert RenderConfig(pipeline="shadowed", shadow_size=384).shadow_size
    with pytest.raises(ValueError, match="stride"):
        RenderConfig(pipeline="shadowed", shadow_lookup_stride=3)
    assert RenderConfig(supersample=2).supersample == 2  # flat SSAA
    for pipeline in ("lit", "shadowed", "deferred"):
        with pytest.raises(NotImplementedError):
            RenderConfig(pipeline=pipeline, supersample=2)
    for unread in ("readback", "profile"):  # the reference's unread fields
        with pytest.raises(TypeError):
            RenderConfig(**{unread: False})
    with pytest.raises(NotImplementedError):
        RenderConfig(clear_color=(1.0, 0.0, 0.0, 1.0))
    cfg = RenderConfig(width=1920, height=1080)
    assert (cfg.pad_width, cfg.pad_height) == (1920, 1088)
    assert cfg.content_hash() == RenderConfig().content_hash()


def test_device_resolution_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Renderer(RenderConfig(width=128, height=64), device="cuda")


def test_app_writes_png(tmp_path, capsys):
    rc = app_main(["--scene", SCENE_DIR, "--width", "256", "--height", "64",
                   "--frames", "2", "--out", str(tmp_path),
                   "--device", "cpu"])
    assert rc == 0
    assert "Cube.002" in capsys.readouterr().out
    img = read_png(str(tmp_path / "frame_0001.png"))
    assert img.shape[:2] == (64, 256)
    assert (img[..., :3].astype(np.int32).sum(-1) > 0).mean() > 0.05


def _reference_module(name: str) -> bool:
    """jax, or the JAX package (not the port)."""
    return name.split(".")[0] in ("jax", "zrenderer_tpu")


def test_port_never_imports_jax():
    """Every port module imports, and the app renders (off scene folders
    and off the showcase's glTF), with jax, the JAX package and PIL made
    unimportable; none is loaded afterwards."""
    modules = sorted(
        "zrenderer_tpu_torch." + os.path.relpath(p, ROOT + "/zrenderer_tpu_torch")
        [:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in glob.glob(ROOT + "/zrenderer_tpu_torch/**/*.py",
                           recursive=True))
    assert "zrenderer_tpu_torch.profiling.ztracy" in modules
    code = (
        "import importlib, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'zrenderer_tpu', 'PIL'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from zrenderer_tpu_torch.app.main import main\n"
        f"main(['--scene', {SCENE_DIR!r}, '--width', '128', '--height',"
        " '64', '--frames', '1', '--device', 'cpu'])\n"
        f"main(['--scene', {SHOWCASE_DIR!r}, '--width', '128', '--height',"
        " '64', '--frames', '1', '--device', 'cpu', '--pipeline', 'lit'])\n"
        f"main(['--scene', {SHOWCASE_GLTF!r}, '--width', '128', '--height',"
        " '64', '--frames', '1', '--device', 'cpu', '--pipeline', 'lit'])\n"
        "loaded = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'zrenderer_tpu', 'PIL')]\n"
        "assert not loaded, loaded\n"
        "print('no-jax-ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no-jax-ok" in out.stdout


def _imported_names(filename):
    """Every module a root script's import statements name."""
    with open(os.path.join(ROOT, filename)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs on a machine without jax: none of its imports
    names jax or the JAX package."""
    names = _imported_names("chip_smoke.py")
    assert "zrenderer_tpu_torch.engine.renderer" in names
    assert not [n for n in names if _reference_module(n)], names


def test_chip_ab_imports_only_the_port():
    """chip_ab.py runs beside chip_smoke.py on the card's machine: none of
    its imports names jax or the JAX package."""
    names = _imported_names("chip_ab.py")
    assert "chip_smoke" in names
    assert not [n for n in names if _reference_module(n)], names
