"""The port's lit pipeline (zrenderer_tpu_torch: ops/mipmap.py,
ops/sampling.py, ops/shading.py, engine/textures.py, engine/passes.py and
the lit Renderer) against the JAX package on the CPU.

Contract:

* mip chains and atlases, f32 and RGBA8 bits, are bit-exact against
  ``Texture.from_array``; trilinear samples are bit-exact against
  ``sample_trilinear_oct`` on the same atlas, uv and LOD (the port reads
  the mip atlas where the reference reads its oct atlas, the same taps);
  world reconstruction, the Blinn-Phong parameters and the tonemap are
  bit-exact;
* the LOD is within 1e-6 and Blinn-Phong within rtol/atol 1e-5: XLA:CPU
  evaluates log2, sqrt and pow with its own approximations, not libm's
  (LOD up to 2 ulp apart, Blinn-Phong up to 5.7e-6 at shininess 1024);
* whole lit frames: coverage exact, depth within 2e-6, u8 within 2 LSB;
  the 160x96 frame against the Pallas renderer (interpret mode) has no
  pixel over 1 LSB; ``render_animation`` digests within rtol 1e-5.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zrenderer_tpu.engine import passes as jpasses
from zrenderer_tpu.engine import textures as jt
from zrenderer_tpu.engine.config import RenderConfig as JaxConfig
from zrenderer_tpu.engine.renderer import Renderer as JaxRenderer
from zrenderer_tpu.ops import mipmap as jm
from zrenderer_tpu.ops import sampling as js
from zrenderer_tpu.ops import shading as jsh
from zrenderer_tpu.scene.mesh import MeshData as JaxMeshData
from zrenderer_tpu.scene.procedural import make_test_scene as jax_test_scene
from zrenderer_tpu.scene.scene import Scene as JaxScene
from zrenderer_tpu.utils.png import read_png
from zrenderer_tpu_torch.app.main import main as app_main
from zrenderer_tpu_torch.engine import passes, textures
from zrenderer_tpu_torch.engine.config import RenderConfig
from zrenderer_tpu_torch.engine.renderer import Renderer
from zrenderer_tpu_torch.ops import mipmap, sampling, shading
from zrenderer_tpu_torch.scene.mesh import MeshData
from zrenderer_tpu_torch.scene.procedural import make_test_scene
from zrenderer_tpu_torch.scene.scene import Scene
from zrenderer_tpu_torch.utils.png import write_png

# The plain kernels run thousands of small torch ops.  Under xdist every
# worker imports this module; one intra-op thread a worker keeps six
# workers from oversubscribing the cores, which slowed such ops 10-100x.
torch.set_num_threads(1)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHOWCASE = os.path.join(ROOT, "content", "scenes", "showcase")
TEST_SCENE = os.path.join(ROOT, "content", "scenes", "test_scene")
LIT_GOLDEN = os.path.join(ROOT, "tests", "goldens", "lit_160x96.png")

T = torch.from_numpy


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _checker_pattern(size=256):
    """The 256x256 pattern of the lit 1080p benchmark cell
    (benchmarks/configs.py checker_texture)."""
    y, x = np.mgrid[0:size, 0:size]
    c = (((x // 16) ^ (y // 16)) & 1).astype(np.float32)
    return np.stack([c, 0.5 + 0.5 * c, 1.0 - 0.5 * c, np.ones_like(c)],
                    axis=-1).astype(np.float32)


_RNG = np.random.default_rng(0)
IMAGES = {
    "checkerboard_64_8": (textures.checkerboard(64, 8), None),
    "checker_texture_256": (_checker_pattern(), None),
    "u8_rgba_64x32": (_RNG.integers(0, 256, (64, 32, 4), dtype=np.uint8),
                      None),
    "f32_rgb_32x64_3_levels": (_RNG.random((32, 64, 3), dtype=np.float32),
                               3),
}


def _textures(name):
    image, levels = IMAGES[name]
    return (textures.Texture.from_array(image, levels),
            jt.Texture.from_array(image, levels))


def _showcase_textures():
    port = textures.textures_from_mesh_data(
        MeshData.load(os.path.join(SHOWCASE, "meshes.bin")), SHOWCASE)
    ref = jt.textures_from_mesh_data(
        JaxMeshData.load(os.path.join(SHOWCASE, "meshes.bin")), SHOWCASE)
    return port, ref


@pytest.mark.parametrize("name", list(IMAGES))
def test_texture_atlas_bit_exact(name):
    ours, ref = _textures(name)
    assert ours.num_levels == ref.num_levels
    assert tuple(ours.base_shape) == tuple(ref.base_shape)
    _bits(ours.atlas.numpy(), ref.atlas)
    _bits(ours.atlas_u32.numpy(), ref.atlas_u32)
    np.testing.assert_array_equal(ours.offsets.numpy(), ref.offsets)
    np.testing.assert_array_equal(ours.sizes.numpy(), ref.sizes)


def test_showcase_texture_array_bit_exact():
    (tex, mat), (ref_tex, ref_mat) = _showcase_textures()
    assert len(tex) == len(ref_tex) == 2 and mat == ref_mat
    for a, b in zip(tex, ref_tex):
        _bits(a.atlas_u32.numpy(), b.atlas_u32)
    white = textures.white_texture()
    assert white.base_shape == (1, 1) and white.num_levels == 1
    array = textures.TextureArray.from_textures(tex)
    ref_array = jt.TextureArray.from_textures(ref_tex)
    assert (array.num_layers, array.num_levels) == (ref_array.num_layers,
                                                    ref_array.num_levels)
    _bits(array.atlas_u32.numpy(), ref_array.atlas_u32)
    with pytest.raises(ValueError, match="uniform"):
        textures.TextureArray.from_textures([tex[0], white])


def test_mip_chain_matches_reference():
    image = _RNG.random((16, 64, 4), dtype=np.float32)
    for levels in (None, 2, 9):
        ours = mipmap.generate_mip_chain(T(image), levels)
        ref = jm.generate_mip_chain(jnp.asarray(image), levels)
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _bits(a.numpy(), b)
    _bits(mipmap.downsample_2x2(T(image)).numpy(),
          jm.downsample_2x2(jnp.asarray(image)))
    with pytest.raises(ValueError, match="power-of-2"):
        mipmap.generate_mip_chain(torch.zeros(12, 16, 4))


def test_texel_packing_matches_reference():
    atlas = (_RNG.random((8, 16, 4), dtype=np.float32) * 1.6 - 0.3)
    packed = sampling.pack_texels_u32(T(atlas))
    assert packed.dtype == torch.int32
    _bits(packed.numpy(), js.pack_texels_u32(jnp.asarray(atlas)))
    texels = _RNG.integers(0, 2**32, (4, 8), dtype=np.uint64).astype(
        np.uint32)
    _bits(sampling._unpack_u32(T(texels.view(np.int32))).numpy(),
          js._unpack_u32(jnp.asarray(texels)))


def _uv_lod(levels, shape=(48, 64), seed=1):
    """uv over five wraps, LOD over the whole chain with its integers."""
    rng = np.random.default_rng(seed)
    uv = (rng.random((*shape, 2), dtype=np.float32) * 5 - 2).astype(
        np.float32)
    lod = (rng.random(shape, dtype=np.float32) * (levels - 1)).astype(
        np.float32)
    lod[0, :levels] = np.arange(levels, dtype=np.float32)
    return uv, lod


@pytest.mark.parametrize("name", ["checkerboard_64_8", "u8_rgba_64x32"])
def test_sample_trilinear_matches_oct(name):
    ours, ref = _textures(name)
    (th, tw), levels = ours.base_shape, ours.num_levels
    uv, lod = _uv_lod(levels)
    out = sampling.sample_trilinear(ours.atlas_u32, th, tw, levels, T(uv),
                                    T(lod))
    _bits(out.numpy(), js.sample_trilinear_oct(
        ref.oct_atlas_u32, th, tw, levels, jnp.asarray(uv), jnp.asarray(lod)))


def test_sample_trilinear_layered_matches_oct():
    (tex, _), (ref_tex, _) = _showcase_textures()
    array = textures.TextureArray.from_textures(tex)
    ref_array = jt.TextureArray.from_textures(ref_tex)
    (th, tw), levels = array.base_shape, array.num_levels
    uv, lod = _uv_lod(levels, seed=2)
    layer = np.random.default_rng(3).integers(0, 2, lod.shape).astype(
        np.int32)
    out = sampling.sample_trilinear(array.atlas_u32, th, tw, levels, T(uv),
                                    T(lod), layer=T(layer))
    _bits(out.numpy(), js.sample_trilinear_oct(
        ref_array.oct_atlas_u32, th, tw, levels, jnp.asarray(uv),
        jnp.asarray(lod), layer=jnp.asarray(layer)))


def test_mip_level_matches_reference():
    rng = np.random.default_rng(4)
    uv = (rng.random((40, 56, 2), dtype=np.float32) * 0.05).cumsum(
        axis=1).astype(np.float32)
    for th, tw, levels in ((64, 64, 7), (32, 128, 6), (256, 256, 9)):
        ours = sampling.mip_level_from_derivatives(T(uv), th, tw, levels)
        ref = np.asarray(js.mip_level_from_derivatives(jnp.asarray(uv), th,
                                                       tw, levels))
        assert 0 < ours.max() <= levels - 1
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)


def test_shading_matches_reference():
    rng = np.random.default_rng(5)
    h, w = 40, 64
    depth = rng.random((h, w), dtype=np.float32)
    inv_vp = rng.standard_normal((4, 4)).astype(np.float32)
    _bits(shading.reconstruct_world_pos(T(depth), T(inv_vp), w, h).numpy(),
          jsh.reconstruct_world_pos(jnp.asarray(depth), jnp.asarray(inv_vp),
                                    w, h))

    met, rgh = (rng.random((h, w), dtype=np.float32) for _ in range(2))
    spec, shin = shading.blinn_params_from_material(T(met), T(rgh))
    ref_spec, ref_shin = jsh.blinn_params_from_material(jnp.asarray(met),
                                                        jnp.asarray(rgh))
    _bits(spec.numpy(), ref_spec)
    _bits(shin.numpy(), ref_shin)

    albedo = rng.random((h, w, 3), dtype=np.float32)
    normal, world = (rng.standard_normal((h, w, 3)).astype(np.float32)
                     for _ in range(2))
    consts = [np.float32(v) for v in ([1, 2, 3], [4, 8, 6], [1, .9, .8])]
    for kw, ref_kw in (({}, {}), (dict(specular=spec, shininess=shin),
                                  dict(specular=ref_spec,
                                       shininess=ref_shin))):
        ours = shading.blinn_phong(T(albedo), T(normal), T(world),
                                   *map(T, consts), **kw)
        ref = jsh.blinn_phong(jnp.asarray(albedo), jnp.asarray(normal),
                              jnp.asarray(world), *map(jnp.asarray, consts),
                              **ref_kw)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)

    rgb = (rng.random((h, w, 3), dtype=np.float32) * 1.4 - 0.2).astype(
        np.float32)
    covered = rng.random((h, w)) > 0.3
    packed = shading.tonemap_and_pack(T(rgb), T(covered))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), jsh.tonemap_and_pack(
        jnp.asarray(rgb), jnp.asarray(covered)))


@pytest.mark.parametrize("kind", ["white", "texture", "array"])
def test_sample_albedo_matches_reference(kind):
    """The 1x1 white shortcut, one texture, and a texture array picked by
    the per-pixel layer plane (uv smooth enough for a real LOD)."""
    rng = np.random.default_rng(6)
    h, w = 32, 48
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    uv = np.stack(np.meshgrid(np.linspace(0, 1.5, w, dtype=np.float32),
                              np.linspace(0, 0.7, h, dtype=np.float32)),
                  axis=-1)
    layer = rng.integers(0, 2, (h, w)).astype(np.float32)
    if kind == "white":
        ours, ref = textures.white_texture(), jt.white_texture()
    elif kind == "texture":
        ours, ref = _textures("checkerboard_64_8")
    else:
        (tex, _), (ref_tex, _) = _showcase_textures()
        ours = textures.TextureArray.from_textures(tex)
        ref = jt.TextureArray.from_textures(ref_tex)
    (th, tw), levels = ours.base_shape, ours.num_levels
    layered = ours.num_layers > 1
    out = passes._sample_albedo(T(rgba), ours.atlas_u32, T(uv[..., 0]),
                                T(uv[..., 1]), T(layer), th, tw, levels,
                                layered)
    ref_out = jpasses._sample_albedo(
        jnp.asarray(rgba), ref.oct_atlas_u32, jnp.asarray(uv[..., 0]),
        jnp.asarray(uv[..., 1]), jnp.asarray(layer), th, tw, levels, layered)
    if kind == "white":
        _bits(out.numpy(), ref_out)
    else:  # the LOD's log2 sets the trilinear weights
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   rtol=0, atol=1e-6)


def _assert_lit_frames_close(img, depth, ref_img, ref_depth, max_over_1):
    """Coverage exact, depth within 2e-6, u8 within 2 LSB with at most
    ``max_over_1`` pixels over 1 LSB."""
    ref_img, ref_depth = np.asarray(ref_img), np.asarray(ref_depth)
    assert img.shape == ref_img.shape and img.dtype == np.uint8
    assert (depth < 1.0).mean() > 0.15
    np.testing.assert_array_equal(depth < 1.0, ref_depth < 1.0)
    np.testing.assert_allclose(depth, ref_depth, rtol=0, atol=2e-6)
    diff = np.abs(img.astype(np.int32) - ref_img.astype(np.int32))
    assert diff.max() <= 2
    assert (diff > 1).any(-1).sum() <= max_over_1
    assert (img[..., :3].std(axis=(0, 1)) > 5).any()  # lit, shaded


def test_lit_frame_matches_jax_pallas():
    """The procedural test scene at 160x96 with checkerboard(64, 8): the
    port's CPU frame against the Pallas renderer in interpret mode (the
    renderer of tests/goldens/lit_160x96.png): no pixel over 1 LSB."""
    r = Renderer(RenderConfig(width=160, height=96, pipeline="lit",
                              tri_align=64), device="cpu")
    r.load_scene(*make_test_scene())
    r.set_environment(texture=textures.Texture.from_array(
        textures.checkerboard(64, 8)))
    img, depth = r.render_and_read()
    ref = JaxRenderer(JaxConfig(width=160, height=96, pipeline="lit",
                                backend="pallas", debug=True, tri_align=64))
    ref.load_scene(*jax_test_scene())
    ref.set_environment(texture=jt.Texture.from_array(
        jt.checkerboard(64, 8)))
    ref_img, ref_depth = ref.render_and_read()
    _assert_lit_frames_close(img, depth, ref_img, ref_depth, max_over_1=0)
    golden = read_png(LIT_GOLDEN)
    assert np.abs(img.astype(np.int32) - golden.astype(np.int32)).max() <= 1


def test_lit_showcase_animation_matches_jax_xla():
    """The textured showcase at 160x120 (three materials: texture layers
    0, 1 and the white layer): the port's render_animation over two
    transforms against the XLA renderer's frames for the same transforms,
    each digest within rtol 1e-5 of the reference's ``sum(color)``
    (renderer.py:916), the presented frame close to the last one."""
    (tex, mat), (ref_tex, ref_mat) = _showcase_textures()
    r = Renderer(RenderConfig(width=160, height=120, pipeline="lit",
                              tri_align=64), device="cpu")
    r.load_scene(Scene.load(os.path.join(SHOWCASE, "scene.bin")),
                 MeshData.load(os.path.join(SHOWCASE, "meshes.bin")))
    r.set_environment(textures=tex, material_textures=mat)
    assert r.texture.num_layers == 3
    ref = JaxRenderer(JaxConfig(width=160, height=120, pipeline="lit",
                                backend="xla", tri_align=64))
    ref.load_scene(JaxScene.load(os.path.join(SHOWCASE, "scene.bin")),
                   JaxMeshData.load(os.path.join(SHOWCASE, "meshes.bin")))
    ref.set_environment(textures=ref_tex, material_textures=ref_mat)

    moved = r.flat.node_to_world.copy()
    moved[0, 3, :3] += np.float32([0.3, 0.1, 0.0])
    seq = np.stack([moved, r.flat.node_to_world])
    digests, (img, depth) = r.render_animation(transforms_seq=seq)
    assert digests.dtype == torch.float32 and digests.shape == (2,)
    assert digests[0] != digests[1]
    for digest, transforms in zip(digests, seq):
        ref_img, ref_depth = ref.render_and_read(transforms=transforms)
        assert digest.item() == pytest.approx(
            float(jnp.sum(jnp.asarray(ref_img).astype(jnp.float32))),
            rel=1e-5)
    _assert_lit_frames_close(img.numpy(), depth.numpy(), ref_img, ref_depth,
                             max_over_1=0)
    # The presented frame is the last one, as render_and_read gives it.
    one, _ = r.render_and_read()
    np.testing.assert_array_equal(one, img.numpy())
    assert digests[1].item() == np.float32(one.astype(np.int64).sum())


def test_lit_renderer_default_texture_and_device():
    """Without set_environment the lit frame binds the 1x1 white texture
    (the reference's default); the default device is the card, which a
    CPU-only host refuses."""
    r = Renderer(RenderConfig(width=128, height=64, pipeline="lit"),
                 device="cpu")
    r.load_scene(*make_test_scene())
    img, depth = r.render_and_read()
    assert r.texture.base_shape == (1, 1)
    w = Renderer(RenderConfig(width=128, height=64, pipeline="lit"),
                 device="cpu")
    w.load_scene(*make_test_scene())
    w.set_environment(texture=textures.white_texture())
    img_w, _ = w.render_and_read()
    np.testing.assert_array_equal(img, img_w)
    assert (depth < 1.0).mean() > 0.15
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError):
        Renderer(RenderConfig(width=128, height=64, pipeline="lit"))


def test_texture_loading_falls_back(tmp_path):
    """A non-PNG image, a missing file or mixed sizes give (None, None);
    a scene without textures too."""
    (tmp_path / "a.dds").write_bytes(b"DDS \x7c\x00\x00\x00")
    with pytest.raises(ValueError, match="PNG"):
        textures.Texture.from_png(tmp_path / "a.dds")
    write_png(str(tmp_path / "small.png"), np.zeros((4, 4, 4), np.uint8))
    write_png(str(tmp_path / "big.png"), np.zeros((8, 8, 4), np.uint8))

    def mesh(*uris):
        return types.SimpleNamespace(texture_uris=list(uris),
                                     material_texture=[0])

    for uris in (["a.dds"], ["missing.png"], ["small.png", "big.png"], []):
        assert textures.textures_from_mesh_data(
            mesh(*uris), str(tmp_path)) == (None, None)
    tex, mat = textures.textures_from_mesh_data(mesh("small.png"),
                                                str(tmp_path))
    assert len(tex) == 1 and tex[0].num_levels == 3 and mat == [0]


@pytest.mark.parametrize("scene_dir", [TEST_SCENE, SHOWCASE])
def test_app_renders_lit_png(tmp_path, scene_dir):
    """--pipeline lit: the showcase binds its TEXS textures, the test scene
    (none) the 256x256 checkerboard."""
    rc = app_main(["--scene", scene_dir, "--width", "128", "--height", "64",
                   "--frames", "1", "--out", str(tmp_path), "--device", "cpu",
                   "--pipeline", "lit"])
    assert rc == 0
    img = read_png(str(tmp_path / "frame_0000.png"))
    assert img.shape[:2] == (64, 128)
    assert (img[..., :3].astype(np.int32).sum(-1) > 0).mean() > 0.05
