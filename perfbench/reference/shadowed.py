"""Plain reference of the shadowed pipeline (BASELINE config 2), as the
JAX package's ``build_shadowed_frame`` defines it: a depth-only pass from
a directional light into a square map, over an orthographic frustum
fitted to the scene's bounds; the camera's G-buffer (vertex colour,
normals, depth); albedo = vertex colour x the bound texture's one white
texel; the world position from depth; percentage-closer filtering of the
map as D16 with a slope-scaled bias; N.L diffuse with ambient 0.10; the
clamp tonemap to RGBA8.

Every expression keeps the association of ``zrenderer_tpu_torch/ops/
shading.py`` and ``engine/renderer.py`` at commit 1b17ee2 (a frozen copy,
importing neither): a division by a constant divides by a 0-dim tensor,
and Python constants are rounded to float32 first.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import common
from perfbench.reference import flat
from perfbench.reference import geometry as geo
from perfbench.reference import precision
from perfbench.reference import raster
from perfbench.reference import zmath as zm
from perfbench.reference.geometry import F32, f32


def _const(like, value: float):
    return torch.tensor(f32(value), dtype=F32, device=like.device)


def _norm(x):
    s = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
    return torch.sqrt(s)[..., None]


def _dot(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])[..., None]


def light_dir_unit(config: dict) -> np.ndarray:
    d = np.asarray(config["environment"]["light_dir"], np.float32)
    return d / np.linalg.norm(d)


def light_view_proj(inputs: common.Inputs,
                    light_dir: np.ndarray) -> np.ndarray:
    """The orthographic light frustum fitted to the scene's world bounds
    (each draw's local vertex box moved by its transform): the centre, a
    radius of half the diagonal plus 1e-3, the eye two radii back along
    the light."""
    pts = inputs.world_corners()
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    center = (lo + hi) * 0.5
    radius = 0.5 * float(np.linalg.norm(hi - lo)) + 1e-3
    eye = center - light_dir * (2.0 * radius)
    up = (0, 1, 0) if abs(light_dir[1]) < 0.95 else (1, 0, 0)
    view = zm.look_at_rh(zm.load_vec3(eye), zm.load_vec3(center),
                         zm.vec3(*up))
    proj = zm.orthographic_rh(2.2 * radius, 2.2 * radius, 0.1, 4.5 * radius)
    return zm.mul(view, proj)


def reconstruct_world(depth, inv_view_proj, width: int, height: int, prec):
    h, w = depth.shape
    dev = depth.device
    mul = prec.mul
    ix = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
    iy = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
    xs = (ix + 0.5) * f32(2.0 / w) - 1.0
    ys = 1.0 - (iy + 0.5) * f32(2.0 / height)
    m = inv_view_proj
    out = [((mul(xs, m[0, j]) + mul(ys, m[1, j])) + mul(depth, m[2, j]))
           + m[3, j] for j in range(4)]
    return torch.stack(out[:3], dim=-1) / out[3][..., None]


def pcf(shadow_depth, world, light_vp, normal, light_dir, config: dict, prec):
    """Lit fraction (H, W) over the edge-clamped (2 taps + 1)^2 texels
    around the pixel's map texel; 1 outside the light's frustum."""
    r = config["render"]
    bias = r.get("shadow_bias", 2e-3)
    slope_bias = r.get("shadow_slope_bias", 3e-3)
    taps = int(r.get("pcf_taps", 1))
    max_bias = 1.2e-2
    mul = prec.mul
    sh, sw = shadow_depth.shape
    wx, wy, wz = world[..., 0], world[..., 1], world[..., 2]
    m = light_vp
    clip = [((mul(wx, m[0, j]) + mul(wy, m[1, j])) + mul(wz, m[2, j]))
            + m[3, j] for j in range(4)]
    w = torch.clamp_min(clip[3], f32(1e-8))
    ndc_x, ndc_y, z = clip[0] / w, clip[1] / w, clip[2] / w
    sx = (ndc_x + 1.0) * f32(sw * 0.5)
    sy = (1.0 - ndc_y) * f32(sh * 0.5)
    ndotl = torch.clamp(_dot(normal, -light_dir)[..., 0], f32(1e-3), 1.0)
    tan_theta = torch.sqrt(torch.clamp_min(1.0 - ndotl * ndotl, 0.0)) / ndotl
    total_bias = torch.clamp_max(f32(bias) + f32(slope_bias) * tan_theta,
                                 f32(max_bias))
    ix = torch.clamp(torch.nan_to_num(sx), 0, sw - 1).to(torch.int64)
    iy = torch.clamp(torch.nan_to_num(sy), 0, sh - 1).to(torch.int64)
    d16 = torch.floor(torch.clamp(shadow_depth, 0.0, 1.0) * 65535.0 + 0.5)
    t16 = torch.clamp(torch.ceil((z - total_bias) * 65535.0), 0.0, 65535.0)
    hits = torch.zeros(ix.shape, dtype=torch.int64, device=ix.device)
    for dy in range(-taps, taps + 1):
        for dx in range(-taps, taps + 1):
            ty = torch.clamp(iy + dy, 0, sh - 1)
            tx = torch.clamp(ix + dx, 0, sw - 1)
            hits += (d16[ty, tx] >= t16).to(torch.int64)
    k = 2 * taps + 1
    lit = hits.to(F32) / _const(hits, k * k)
    inside = ((ndc_x >= -1) & (ndc_x <= 1) & (ndc_y >= -1) & (ndc_y <= 1)
              & (z >= 0) & (z <= 1))
    return torch.where(inside, lit, 1.0)


def _light_rows(inputs, config: dict, prec):
    ldir = light_dir_unit(config)
    lvp = light_view_proj(inputs, ldir)
    size = int(config["render"].get("shadow_size", 1024))
    rows = geo.geometry(
        inputs.obj, inputs.rows_in,
        inputs.per_row(common.draw_matrices(inputs.node_to_world, lvp)),
        size, size, prec)
    return rows, size, ldir, lvp


def render(inputs: common.Inputs, cam, config: dict, prec):
    """(rgba u8 (H, W, 4), depth f32 (H, W)) of one frame."""
    if config["render"].get("shadow_lookup_stride", 1) != 1:
        raise NotImplementedError("the reference does PCF at every pixel")
    w, h = inputs.width, inputs.height
    lrows, size, ldir, lvp = _light_rows(inputs, config, prec)
    _, shadow_depth = raster.winners(lrows, size, size, prec)
    del lrows
    rows, vp = flat.camera_rows(inputs, cam, prec, normals=True)
    row, depth = raster.winners(rows, w, h, prec)
    den, num = raster.latch(rows, row, prec)
    del rows
    rgba = raster.rgba8(den, num)
    attr = raster.resolve(den, num[5:8])
    normal = attr.permute(1, 2, 0)
    covered = depth < 1.0
    white = torch.tensor(255.0, dtype=F32, device=depth.device) * f32(1 / 255)
    albedo = (rgba[..., :3].to(F32) / _const(depth, 255.0)) * white
    n = normal / torch.clamp_min(_norm(normal), f32(1e-8))
    inv_vp = inputs.tensor(np.linalg.inv(vp.astype(np.float64))
                           .astype(np.float32))
    world = reconstruct_world(depth, inv_vp, w, h, prec)
    light_dir = inputs.tensor(ldir)
    lit = pcf(shadow_depth, world, inputs.tensor(lvp), n, light_dir, config,
              prec)
    color = inputs.tensor(np.asarray(config["environment"].get(
        "light_color", (1.0, 1.0, 1.0)), np.float32))
    ndotl = torch.clamp_min(_dot(n, -light_dir), 0.0)
    rgb = albedo * (f32(0.10) + ndotl * lit[..., None] * color)
    c = torch.clamp(torch.where(covered[..., None], rgb, 0.0), 0.0, 1.0)
    rgba_out = torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)
    return torch.floor(rgba_out * 255.0 + 0.5).to(torch.uint8), depth


def raster_work(inputs: common.Inputs, cam, config: dict) -> dict:
    """One frame's least raster work: the light's depth pass (its map
    written once, 4 bytes a texel) and the camera's pass (the presented
    colour and depth, 8 bytes a pixel)."""
    lrows, size, _, _ = _light_rows(inputs, config, precision.F32)
    light = common.pass_work(lrows, size, size, 4)
    del lrows
    rows, _ = flat.camera_rows(inputs, cam, precision.F32, normals=True)
    return common.add_work(light, common.pass_work(rows, inputs.width,
                                                   inputs.height, 8))
