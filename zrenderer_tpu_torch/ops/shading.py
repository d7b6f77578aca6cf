"""Shading of the lit, shadowed and deferred pipelines (counterpart of
``reconstruct_world_pos``, ``blinn_params_from_material``, ``blinn_phong``,
``ggx_shade_many_lights``, ``shadow_factor_pcf``,
``shadow_factor_pcf_strided`` and ``tonemap_and_pack`` in
``zrenderer_tpu/ops/shading.py``).

Plain torch ops over (H, W, ...) G-buffer planes, as the reference leaves
them to XLA.  Each expression keeps the reference's association; Python
float constants are the float32 values JAX's weak types give them; a
vector norm is ``sqrt((x*x + y*y) + z*z)``; and a division by a constant
divides by a 0-dim tensor on the planes' device (CUDA turns a division by
a Python scalar into a multiply by its reciprocal).  On the CPU the
results are the reference's eager bits; on the card ``pow``, ``log2`` and
``sqrt`` are CUDA's, so a lit frame there stays within 2 LSB of the CPU
frame instead of bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


def _f32(x: float) -> float:
    return float(np.float32(x))


def _const(like, value: float):
    """A 0-dim f32 tensor holding float32(value) on ``like``'s device."""
    return torch.tensor(_f32(value), dtype=F32, device=like.device)


def _norm(x):
    """sqrt((x0*x0 + x1*x1) + x2*x2) over the last axis, kept as (..., 1)."""
    s = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]
    return torch.sqrt(s)[..., None]


def _dot(a, b):
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])[..., None]


def reconstruct_world_pos(depth_ndc, inv_view_proj, width: int, height: int,
                          row_offset: int = 0):
    """World position from the depth plane: pixel centres (j+0.5, i+0.5)
    to NDC, times the (4, 4) row-vector inverse view-projection, divided by
    w.  Returns (H, W, 3).  ``row_offset``: the global row of the plane's
    first row, for a band of a ``height``-tall frame."""
    h, w = depth_ndc.shape
    dev = depth_ndc.device
    ix = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
    iy = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
    xs = (ix + 0.5) * _f32(2.0 / w) - 1.0
    ys = 1.0 - ((iy + 0.5) + float(row_offset)) * _f32(2.0 / height)
    m = inv_view_proj
    out = [((xs * m[0, j] + ys * m[1, j]) + depth_ndc * m[2, j]) + m[3, j]
           for j in range(4)]
    return torch.stack(out[:3], dim=-1) / out[3][..., None]


def blinn_params_from_material(metallic, roughness):
    """PBR metallic/roughness planes -> the Blinn-Phong knobs: exponent
    2/alpha^2 - 2 with alpha = roughness^2 (clipped), specular strength
    0.04 -> 1.0.  Returns (specular (H, W, 1), shininess (H, W, 1))."""
    met = metallic.to(F32)[..., None]
    r = roughness.to(F32)[..., None]
    alpha = torch.clamp(r * r, _f32(0.05), 1.0)
    shininess = torch.clamp(
        _const(alpha, 2.0) / (alpha * alpha) - 2.0, 2.0, 1024.0)
    specular = _f32(0.04) + _f32(0.96) * met
    return specular, shininess


def blinn_phong(albedo, normal, world_pos, cam_pos, light_pos, light_color,
                ambient=0.08, specular=0.35, shininess=48.0,
                attenuation=0.005):
    """Point-light Blinn-Phong.  albedo/normal/world_pos (H, W, 3);
    cam_pos/light_pos/light_color (3,) tensors; specular/shininess floats
    or (H, W, 1) planes.  Returns (H, W, 3) linear RGB."""
    n = normal / torch.clamp_min(_norm(normal), _f32(1e-8))
    lvec = light_pos - world_pos
    dist2 = _dot(lvec, lvec)
    l = lvec / torch.sqrt(torch.clamp_min(dist2, _f32(1e-12)))
    v = cam_pos - world_pos
    v = v / torch.clamp_min(_norm(v), _f32(1e-8))
    hvec = l + v
    hvec = hvec / torch.clamp_min(_norm(hvec), _f32(1e-8))

    ndotl = torch.clamp_min(_dot(n, l), 0.0)
    ndoth = torch.clamp_min(_dot(n, hvec), 0.0)
    atten = _const(dist2, 1.0) / (1.0 + _f32(attenuation) * dist2)
    diffuse = albedo * ndotl
    spec = specular * torch.pow(ndoth, shininess) * torch.sign(ndotl)
    return (_f32(ambient) * albedo
            + ((diffuse + spec) * light_color) * atten).to(F32)


def _fresnel_schlick(vdoth, f0):
    return f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - vdoth, 0.0, 1.0),
                                       5.0)


def ggx_shade_many_lights(albedo, normal, world_pos, cam_pos, light_pos,
                          light_color, metallic=0.0, roughness=0.4,
                          ambient=0.03, chunk: int = 32):
    """Cook-Torrance GGX with L point lights and no culling, in chunks of
    ``chunk`` lights ((H, W, chunk, 3) broadcasts): the reference's XLA
    shade, the merged form K7 evaluates per tile.  light_pos/light_color
    (L, 3); metallic/roughness scalars or (H, W) planes.  Returns
    (H, W, 3)."""
    dev = albedo.device
    n = normal / torch.clamp_min(_norm(normal), _f32(1e-8))
    v = cam_pos - world_pos
    v = v / torch.clamp_min(_norm(v), _f32(1e-8))
    nv_raw = _dot(n, v)
    ndotv = torch.clamp_min(nv_raw, _f32(1e-4))
    shape = albedo.shape[:2]
    metallic = torch.as_tensor(metallic, dtype=F32, device=dev).expand(
        shape)[..., None]
    roughness = torch.as_tensor(roughness, dtype=F32, device=dev).expand(
        shape)[..., None]
    met_l = metallic[..., None, :]
    f0 = _f32(0.04) * (1.0 - metallic) + albedo * metallic
    a = roughness * roughness
    a2 = a * a
    k = (roughness + 1.0) ** 2 / _const(roughness, 8.0)
    gv = ndotv / (ndotv * (1.0 - k) + k)
    cs = a2 * gv * 0.25 / ndotv
    a2m1 = a2[..., None, :] - 1.0
    k_l = k[..., None, :]
    cs_l = cs[..., None, :]
    pi = _const(albedo, np.pi)

    num_lights = light_pos.shape[0]
    if num_lights % chunk:
        chunk = num_lights  # small light counts: one chunk
    acc = torch.zeros_like(albedo)
    for c in range(num_lights // chunk):
        lpos = light_pos[c * chunk:(c + 1) * chunk]
        lcol = light_color[c * chunk:(c + 1) * chunk]
        lvec = lpos - world_pos[..., None, :]  # (H, W, chunk, 3)
        dist2 = _dot(lvec, lvec)
        inv_d = _const(dist2, 1.0) / torch.sqrt(
            torch.clamp_min(dist2, _f32(1e-12)))
        l = lvec * inv_d
        nl_raw = _dot(n[..., None, :], l)
        ndotl = torch.clamp_min(nl_raw, 0.0)
        ldotv = _dot(v[..., None, :], l)
        inv_h = _const(ldotv, 1.0) / torch.sqrt(
            torch.clamp_min(2.0 + 2.0 * ldotv, _f32(1e-12)))
        ndoth = torch.clamp_min((nl_raw + nv_raw[..., None, :]) * inv_h, 0.0)
        vdoth = torch.clamp_min((1.0 + ldotv) * inv_h, 0.0)
        dterm = ndoth * ndoth * a2m1 + 1.0
        denom = torch.clamp_min(_f32(np.pi) * dterm * dterm, _f32(1e-8)) * (
            ndotl * (1.0 - k_l) + k_l)
        spec = cs_l / denom
        f = _fresnel_schlick(vdoth, f0[..., None, :])
        kd = (1.0 - f) * (1.0 - met_l)
        radiance = lcol * (inv_d * inv_d)
        contrib = (kd * albedo[..., None, :] / pi + f * spec) \
            * radiance * ndotl
        acc = acc + contrib.sum(dim=-2)
    return (_f32(ambient) * albedo + acc).to(F32)


def shadow_factor_pcf(shadow_depth, world_pos, light_view_proj,
                      bias: float = 2e-3, taps: int = 1, normal=None,
                      light_dir=None, slope_bias: float = 3e-3,
                      max_bias: float = 1.2e-2):
    """Percentage-closer filtering against a depth-only shadow map.

    ``shadow_depth`` (Sh, Sw) z in [0, 1] from the light's pass;
    ``world_pos`` (H, W, 3); ``light_view_proj`` (4, 4) row-vector.
    Returns (H, W) f32 in [0, 1], 1 fully lit, over the edge-clamped
    (2*taps+1)^2 neighbourhood of the pixel's shadow-map texel; 1 outside
    the light's frustum.  With ``normal`` (H, W, 3, unit) and ``light_dir``
    (3,) pointing from the light, the bias is slope-scaled,
    bias + slope_bias * tan(acos(N.L)), capped at ``max_bias``.

    The map is compared as D16, floor(clip(d, 0, 1) * 65535 + 0.5),
    against the integer threshold clip(ceil((z - bias) * 65535), 0, 65535),
    as the reference does.  The reference packs two taps a u32 lane for its
    TPU gather; here every tap is a column of one (Sh*Sw, taps) table of
    the edge-clamped shifted maps, read by one gather: the same bits."""
    sh, sw = shadow_depth.shape
    wx, wy, wz = world_pos[..., 0], world_pos[..., 1], world_pos[..., 2]
    m = light_view_proj
    clip = [((wx * m[0, j] + wy * m[1, j]) + wz * m[2, j]) + m[3, j]
            for j in range(4)]
    w = torch.clamp_min(clip[3], _f32(1e-8))
    ndc_x, ndc_y, z = clip[0] / w, clip[1] / w, clip[2] / w
    sx = (ndc_x + 1.0) * _f32(sw * 0.5)
    sy = (1.0 - ndc_y) * _f32(sh * 0.5)

    total_bias = _f32(bias)
    if normal is not None and light_dir is not None:
        ndotl = torch.clamp(_dot(normal, -light_dir)[..., 0], _f32(1e-3), 1.0)
        tan_theta = torch.sqrt(
            torch.clamp_min(1.0 - ndotl * ndotl, 0.0)) / ndotl
        total_bias = torch.clamp_max(
            _f32(bias) + _f32(slope_bias) * tan_theta, _f32(max_bias))

    # The reference truncates to int32, then clamps; clamping first gives
    # the same index for every number (NaN, outside the frustum, reads 0).
    ix = torch.clamp(torch.nan_to_num(sx), 0, sw - 1).to(torch.int32)
    iy = torch.clamp(torch.nan_to_num(sy), 0, sh - 1).to(torch.int32)
    d16 = torch.floor(torch.clamp(shadow_depth, 0.0, 1.0) * 65535.0 + 0.5)
    k = 2 * taps + 1
    padded = F.pad(d16[None, None], (taps, taps, taps, taps),
                   mode="replicate")
    # (Sh*Sw, k*k): one row a texel, its taps (dy, dx) in row-major order.
    table = F.unfold(padded, k)[0].T.contiguous()
    rows = table[(iy * sw + ix).long()]  # (H, W, k*k)
    t16 = torch.clamp(torch.ceil((z - total_bias) * 65535.0), 0.0, 65535.0)
    hits = (rows >= t16[..., None]).sum(dim=-1)
    lit = hits.to(F32) / _const(hits, k * k)
    inside = ((ndc_x >= -1) & (ndc_x <= 1) & (ndc_y >= -1) & (ndc_y <= 1)
              & (z >= 0) & (z <= 1))
    return torch.where(inside, lit, 1.0)


def shadow_factor_pcf_strided(shadow_depth, world_pos, light_view_proj,
                              stride: int = 1, normal=None, **kw):
    """PCF at every ``stride``-th pixel.  ``stride=1`` is the per-pixel
    ``shadow_factor_pcf``; ``stride=2`` evaluates it on 2x2 mean-pooled
    world positions (and normals) and bilinearly upsamples the lit
    fraction with edge-clamped neighbours, as the reference does (H and W
    even)."""
    if stride == 1:
        return shadow_factor_pcf(shadow_depth, world_pos, light_view_proj,
                                 normal=normal, **kw)
    if stride != 2:
        raise ValueError(f"shadow lookup stride {stride}: 1 or 2")
    h, w = world_pos.shape[:2]

    def pool(x):
        return x.reshape(h // 2, 2, w // 2, 2, *x.shape[2:]).mean(dim=(1, 3))

    sub = shadow_factor_pcf(shadow_depth, pool(world_pos), light_view_proj,
                            normal=None if normal is None else pool(normal),
                            **kw)
    right = torch.cat([sub[:, 1:], sub[:, -1:]], dim=1)
    down = torch.cat([sub[1:, :], sub[-1:, :]], dim=0)
    diag = torch.cat([right[1:, :], right[-1:, :]], dim=0)
    row_a = torch.stack([sub, (sub + right) * 0.5], dim=-1).reshape(
        sub.shape[0], -1)
    row_b = torch.stack([(sub + down) * 0.5,
                         (((sub + right) + down) + diag) * 0.25],
                        dim=-1).reshape(sub.shape[0], -1)
    out = torch.stack([row_a, row_b], dim=1).reshape(-1, row_a.shape[1])
    return out[:h, :w]


def tonemap_and_pack(rgb, covered, clear_rgb=(0.0, 0.0, 0.0)):
    """Clamp-tonemap and pack to (H, W, 4) u8 with the spec's rounding."""
    clear = torch.tensor([_f32(c) for c in clear_rgb], dtype=F32,
                         device=rgb.device)
    c = torch.clamp(torch.where(covered[..., None], rgb, clear), 0.0, 1.0)
    rgba = torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)
    return torch.floor(rgba * 255.0 + 0.5).to(torch.uint8)
