"""Render-pass composition of the lit, shadowed and deferred pipelines
(counterpart of ``_gbuffer``, ``_depth_only``, ``_sample_albedo``,
``build_lit_frame``, ``build_shadowed_frame`` and ``build_deferred_frame``
in ``zrenderer_tpu/engine/passes.py``).

``build_lit_frame`` returns the frame function of BASELINE config 1:
G-buffer raster (``raster.render_gbuffer``: K2g, K3g, K4g, K5g or K6g),
then trilinear texture sampling, Blinn-Phong with one point light,
emissive and the u8 tonemap.  ``build_shadowed_frame`` returns that of
config 2: a depth-only pass from a directional light into a square shadow
map (``raster.render_depth``: K2d, K3d, K4d, K6d or K5's depth plane),
the same G-buffer and sampling, PCF shadowing, N.L diffuse with ambient
0.10, emissive and the tonemap.  ``build_deferred_frame`` returns that
of config 3: the G-buffer, albedo from the vertex colour alone (no
texture), the world position, the tiled GGX light kernel K7 over many
point lights (``light_kernel.tiled_light`` on the padded planes),
emissive and the tonemap.  Everything runs on the device of the buffers
it is given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zrenderer_tpu_torch.ops import raster, sampling, shading
from zrenderer_tpu_torch.ops.light_kernel import light_inputs, tiled_light

F32 = torch.float32


def _indexed(b):
    """The indexed buffers a vertex shader runs on: positions, attrs,
    tri_vidx, vert_node."""
    return b["positions"], b["attrs"], b["tri_vidx"], b["vert_node"]


def _gbuffer(b, matrices, normal_mats, width: int, height: int,
             pad_height: int, pad_width: int, binning: str = "auto",
             vertex_shader=None):
    """Returns (rgba u8 (H, W, 4), depth, u, v, nx, ny, nz, metallic,
    roughness, emissive r/g/b, texture layer), cropped to (height, width).
    The per-triangle material table rides the buffers as b['materials'].
    Without a vertex shader the column buffers feed the geometry stage;
    with one, the indexed buffers (the shader runs on per-vertex rows), as
    the reference's ``_geom_buffers`` chooses."""
    frame = (width, height, pad_height, pad_width)
    if vertex_shader is None:
        planes = raster.render_gbuffer(
            b["corner_cols"], b["tri_node"], matrices, normal_mats,
            b.get("materials"), *frame, binning=binning)
    else:
        planes = raster.render_gbuffer_indexed(
            *_indexed(b), matrices, normal_mats, b.get("materials"), *frame,
            binning=binning, vertex_shader=vertex_shader)
    return [raster.unpack_rgba8(planes[0])] + planes[1:]


def _depth_only(b, light_matrices, size: int, binning: str = "auto"):
    """Depth-only pass from the light's view (the shadow-map pass):
    (size, size) f32.  It takes the column buffers with no vertex shader,
    as the reference's ``_depth_only`` does: a shaded mesh casts the shadow
    of its unshaded vertices."""
    return raster.render_depth(b["corner_cols"], b["tri_node"],
                               light_matrices, size, binning=binning)


def _sample_albedo(rgba, atlas_u32, u, v, tex_layer, th: int, tw: int,
                   levels: int, layered: bool):
    """Vertex rgb times the trilinear texture sample; with a texture array
    the per-pixel layer plane picks the draw's texture."""
    base = rgba[..., :3].to(F32) / shading._const(u, 255.0)
    if th == 1 and tw == 1 and not layered:
        # The 1x1 default binding: one texel, a broadcast multiply.
        return base * sampling._unpack_u32(atlas_u32[0, 0])[:3]
    uv = torch.stack([u, v], dim=-1)
    lod = sampling.mip_level_from_derivatives(uv, th, tw, levels)
    layer = tex_layer.to(torch.int32) if layered else None
    tex = sampling.sample_trilinear(atlas_u32, th, tw, levels, uv, lod,
                                    layer=layer)
    return base * tex[..., :3]


def build_lit_frame(width: int, height: int, pad_height: int,
                    pad_width: int, texture, binning: str = "auto",
                    vertex_shader=None):
    """Config 1: textured + Blinn-Phong point light, Z-buffered.

    Materials modulate the Blinn-Phong knobs per pixel and emissive adds
    after lighting; ``texture`` is a Texture or a TextureArray (per-draw
    texture layers).  The returned ``frame(b, atlas_u32, matrices,
    normal_mats, inv_view_proj, cam_pos, light_pos, light_color)`` gives
    (rgba u8 (H, W, 4), depth (H, W)).  ``vertex_shader``: optional
    ``fn(positions (N, 4), attrs (N, 12)) -> (positions, attrs)``."""
    th, tw = int(texture.base_shape[0]), int(texture.base_shape[1])
    levels = texture.num_levels
    layered = texture.num_layers > 1

    def frame(b, atlas_u32, matrices, normal_mats, inv_view_proj, cam_pos,
              light_pos, light_color):
        (rgba, depth, u, v, nx, ny, nz,
         met, rgh, emr, emg, emb, tex_layer) = _gbuffer(
            b, matrices, normal_mats, width, height, pad_height, pad_width,
            binning, vertex_shader)
        covered = depth < 1.0
        albedo = _sample_albedo(rgba, atlas_u32, u, v, tex_layer, th, tw,
                                levels, layered)
        normal = torch.stack([nx, ny, nz], dim=-1)
        world = shading.reconstruct_world_pos(depth, inv_view_proj, width,
                                              height)
        specular, shininess = shading.blinn_params_from_material(met, rgh)
        lit = shading.blinn_phong(albedo, normal, world, cam_pos, light_pos,
                                  light_color, specular=specular,
                                  shininess=shininess)
        lit = lit + torch.stack([emr, emg, emb], dim=-1)
        return shading.tonemap_and_pack(lit, covered), depth

    return frame


def build_shadowed_frame(width: int, height: int, pad_height: int,
                         pad_width: int, texture, shadow_size: int = 1024,
                         shadow_bias: float = 2e-3,
                         shadow_slope_bias: float = 3e-3, pcf_taps: int = 1,
                         shadow_lookup_stride: int = 1,
                         binning: str = "auto", vertex_shader=None):
    """Config 2: directional-light shadow map (depth-only pass + PCF).

    The returned ``frame(b, atlas_u32, matrices, normal_mats,
    inv_view_proj, cam_pos, light_matrices, light_view_proj, light_dir,
    light_color)`` gives (rgba u8 (H, W, 4), depth (H, W), shadow_depth
    (shadow_size, shadow_size)); ``light_matrices`` are the per-draw
    object-to-light-clip matrices, ``light_dir`` the unit direction from
    the light.  A ``vertex_shader`` runs in the camera's G-buffer pass
    only, as in the reference."""
    th, tw = int(texture.base_shape[0]), int(texture.base_shape[1])
    levels = texture.num_levels
    layered = texture.num_layers > 1

    def frame(b, atlas_u32, matrices, normal_mats, inv_view_proj, cam_pos,
              light_matrices, light_view_proj, light_dir, light_color):
        del cam_pos  # the reference's frame takes it and reads it nowhere
        shadow_depth = _depth_only(b, light_matrices, shadow_size, binning)
        (rgba, depth, u, v, nx, ny, nz,
         met, rgh, emr, emg, emb, tex_layer) = _gbuffer(
            b, matrices, normal_mats, width, height, pad_height, pad_width,
            binning, vertex_shader)
        covered = depth < 1.0
        albedo = _sample_albedo(rgba, atlas_u32, u, v, tex_layer, th, tw,
                                levels, layered)
        normal = torch.stack([nx, ny, nz], dim=-1)
        n = normal / torch.clamp_min(shading._norm(normal),
                                     shading._f32(1e-8))
        world = shading.reconstruct_world_pos(depth, inv_view_proj, width,
                                              height)
        lit_mask = shading.shadow_factor_pcf_strided(
            shadow_depth, world, light_view_proj,
            stride=shadow_lookup_stride, bias=shadow_bias, taps=pcf_taps,
            normal=n, light_dir=light_dir, slope_bias=shadow_slope_bias)
        ndotl = torch.clamp_min(shading._dot(n, -light_dir), 0.0)
        rgb = albedo * (shading._f32(0.10)
                        + ndotl * lit_mask[..., None] * light_color)
        rgb = rgb + torch.stack([emr, emg, emb], dim=-1)
        return shading.tonemap_and_pack(rgb, covered), depth, shadow_depth

    return frame


def deferred_light_inputs(gbuffer, world, cam_pos, view_proj, light_pos,
                          light_color, width: int, height: int,
                          pad_height: int, pad_width: int,
                          plane_dtype=F32):
    """K7's inputs from the cropped G-buffer planes (``_gbuffer``) and the
    world position: albedo (vertex colour / 255, no texture), normal,
    world, coverage, metallic and roughness, padded with zeros back to the
    (pad_height, pad_width) raster target as the reference pads them, so
    the light bounds use the padded size.  Returns
    ``light_kernel.light_inputs``' (planes, mask, bounds, lights,
    consts)."""
    rgba, depth, _, _, nx, ny, nz, met, rgh = gbuffer[:9]

    def pad(x):
        # (H, W, ...) -> (pad_height, pad_width, ...), zeros after.
        tail = (0, 0) * (x.dim() - 2)
        return F.pad(x, tail + (0, pad_width - width, 0, pad_height - height))

    albedo = rgba[..., :3].to(F32) / shading._const(depth, 255.0)
    normal = torch.stack([nx, ny, nz], dim=-1)
    return light_inputs(pad(albedo), pad(normal), pad(world),
                        pad(depth < 1.0), cam_pos, light_pos, light_color,
                        view_proj, roughness=pad(rgh), metallic=pad(met),
                        plane_dtype=plane_dtype)


def build_deferred_frame(width: int, height: int, pad_height: int,
                         pad_width: int, lighting_planes: str = "f32",
                         binning: str = "auto", vertex_shader=None):
    """Config 3: deferred G-buffer + GGX lighting with many point lights.

    The returned ``frame(b, matrices, normal_mats, inv_view_proj, cam_pos,
    view_proj, light_pos, light_color)`` gives (rgba u8 (H, W, 4), depth
    (H, W)); light_pos/light_color are (L, 3).  Per-pixel metallic and
    roughness from the G-buffer drive the BRDF; K7 lights the padded
    planes (``deferred_light_inputs``), its output is cropped, and emissive
    adds after the light loop."""
    plane_dtype = torch.bfloat16 if lighting_planes == "bf16" else F32

    def frame(b, matrices, normal_mats, inv_view_proj, cam_pos, view_proj,
              light_pos, light_color):
        g = _gbuffer(b, matrices, normal_mats, width, height, pad_height,
                     pad_width, binning, vertex_shader)
        depth = g[1]
        world = shading.reconstruct_world_pos(depth, inv_view_proj, width,
                                              height)
        inputs = deferred_light_inputs(g, world, cam_pos, view_proj,
                                       light_pos, light_color, width, height,
                                       pad_height, pad_width, plane_dtype)
        rgb = tiled_light(*inputs).permute(1, 2, 0)[:height, :width]
        rgb = rgb + torch.stack(g[9:12], dim=-1)
        return shading.tonemap_and_pack(rgb, depth < 1.0), depth

    return frame
