"""The host matrix math the reference needs, in float32 NumPy: a frozen
copy of ``look_to_lh``, ``look_at_rh``, ``perspective_fov_rh``,
``orthographic_rh`` and ``mul`` of ``zrenderer_tpu_torch/math/zmath.py``
at commit 1b17ee2 (the zmath library's conventions: row-major matrices,
row vectors, right-handed view space, D3D [0, 1] clip depth)."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def load_vec3(mem, w: float = 0.0) -> np.ndarray:
    m = np.asarray(mem, dtype=F32).reshape(-1)
    return np.array([m[0], m[1], m[2], w], dtype=F32)


def vec3(x: float, y: float, z: float) -> np.ndarray:
    return np.array([x, y, z, 0.0], dtype=F32)


def dot3(a, b) -> F32:
    a = np.asarray(a, dtype=F32)
    b = np.asarray(b, dtype=F32)
    return F32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross3(a, b) -> np.ndarray:
    a = np.asarray(a, dtype=F32)
    b = np.asarray(b, dtype=F32)
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0], 0.0], dtype=F32)


def normalize3(a) -> np.ndarray:
    a = np.asarray(a, dtype=F32)
    n = F32(np.sqrt(dot3(a, a), dtype=F32))
    out = a.copy()
    out[:3] = a[:3] / n
    out[3] = a[3] / n
    return out


def mul(a, b) -> np.ndarray:
    return (np.asarray(a, dtype=F32) @ np.asarray(b, dtype=F32)).astype(F32)


def look_to_lh(eyepos, eyedir, updir) -> np.ndarray:
    az = normalize3(np.asarray(eyedir, dtype=F32))
    ax = normalize3(cross3(np.asarray(updir, dtype=F32), az))
    ay = normalize3(cross3(az, ax))
    eye = np.asarray(eyepos, dtype=F32)
    return np.array([
        [ax[0], ay[0], az[0], 0.0],
        [ax[1], ay[1], az[1], 0.0],
        [ax[2], ay[2], az[2], 0.0],
        [-dot3(ax, eye), -dot3(ay, eye), -dot3(az, eye), 1.0],
    ], dtype=F32)


def look_at_rh(eyepos, focuspos, updir) -> np.ndarray:
    return look_to_lh(eyepos, np.asarray(eyepos, dtype=F32)
                      - np.asarray(focuspos, dtype=F32), updir)


def perspective_fov_rh(fovy: float, aspect: float, near: float,
                       far: float) -> np.ndarray:
    h = F32(np.cos(F32(0.5 * fovy)) / np.sin(F32(0.5 * fovy)))
    w = F32(h / F32(aspect))
    r = F32(far / (near - far))
    return np.array([[w, 0, 0, 0], [0, h, 0, 0], [0, 0, r, -1],
                     [0, 0, r * near, 0]], dtype=F32)


def orthographic_rh(w: float, h: float, near: float, far: float) -> np.ndarray:
    r = F32(1.0 / (near - far))
    return np.array([[2.0 / w, 0, 0, 0], [0, 2.0 / h, 0, 0], [0, 0, r, 0],
                     [0, 0, r * near, 1]], dtype=F32)


def view_proj(position, forward, yfov: float, znear: float, zfar: float,
              width: int, height: int) -> np.ndarray:
    """A camera's view-projection: look at position + forward, the
    viewport's aspect (``view_proj_from_camera``)."""
    view = look_at_rh(load_vec3(position),
                      load_vec3(np.asarray(position) + np.asarray(forward)),
                      np.array([0.0, 1.0, 0.0, 0.0], dtype=F32))
    zfar = zfar if zfar > znear else 1000.0
    proj = perspective_fov_rh(yfov, float(width) / float(height), znear, zfar)
    return mul(view, proj)
