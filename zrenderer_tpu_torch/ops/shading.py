"""Blinn-Phong shading of the lit pipeline (counterpart of
``reconstruct_world_pos``, ``blinn_params_from_material``, ``blinn_phong``
and ``tonemap_and_pack`` in ``zrenderer_tpu/ops/shading.py``).

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


def reconstruct_world_pos(depth_ndc, inv_view_proj, width: int, height: int):
    """World position from the depth plane: pixel centres (j+0.5, i+0.5)
    to NDC, times the (4, 4) row-vector inverse view-projection, divided by
    w.  Returns (H, W, 3)."""
    h, w = depth_ndc.shape
    dev = depth_ndc.device
    ix = torch.arange(w, dtype=F32, device=dev)[None, :].expand(h, w)
    iy = torch.arange(h, dtype=F32, device=dev)[:, None].expand(h, w)
    xs = (ix + 0.5) * _f32(2.0 / w) - 1.0
    ys = 1.0 - (iy + 0.5) * _f32(2.0 / height)
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


def tonemap_and_pack(rgb, covered, clear_rgb=(0.0, 0.0, 0.0)):
    """Clamp-tonemap and pack to (H, W, 4) u8 with the spec's rounding."""
    clear = torch.tensor([_f32(c) for c in clear_rgb], dtype=F32,
                         device=rgb.device)
    c = torch.clamp(torch.where(covered[..., None], rgb, clear), 0.0, 1.0)
    rgba = torch.cat([c, torch.ones_like(c[..., :1])], dim=-1)
    return torch.floor(rgba * 255.0 + 0.5).to(torch.uint8)
