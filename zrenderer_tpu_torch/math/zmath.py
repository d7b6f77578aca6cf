"""Host camera and transform math of the port: the part of
``zrenderer_tpu/math/zmath.py`` that the flat frame path's camera uses,
copied so the port runs without the JAX package.

Conventions (those of the reference's zmath): row-major matrices with
row vectors (``v' = v @ M``; ``mul(A, B)`` applies A first), a
right-handed view space looking down -Z, D3D-style [0, 1] clip depth.
Everything is float32 NumPy, operation for
operation as in the reference module, so the camera matrices, and with
them every setup row, are the same bits; ``tests/test_torch_host.py``
holds the two modules equal.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def f32x4(x: float, y: float, z: float, w: float) -> np.ndarray:
    """A 4-wide float32 vector (zmath ``f32x4``)."""
    return np.array([x, y, z, w], dtype=F32)


def load_vec3(mem, w: float = 0.0) -> np.ndarray:
    """zmath ``load(mem, Vec, 3)``: read 3 floats, set the 4th lane."""
    m = np.asarray(mem, dtype=F32).reshape(-1)
    return np.array([m[0], m[1], m[2], w], dtype=F32)


def identity() -> np.ndarray:
    return np.eye(4, dtype=F32)


def dot3(a: np.ndarray, b: np.ndarray) -> F32:
    a = np.asarray(a, dtype=F32)
    b = np.asarray(b, dtype=F32)
    return F32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def cross3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=F32)
    b = np.asarray(b, dtype=F32)
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
            0.0,
        ],
        dtype=F32,
    )


def normalize3(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=F32)
    n = F32(np.sqrt(dot3(a, a), dtype=F32))
    out = a.copy()
    out[:3] = a[:3] / n
    out[3] = a[3] / n  # zmath normalize3 divides the whole register
    return out


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """zmath ``mul``: ``mul(A, B)`` composes so that A is applied first."""
    return (np.asarray(a, dtype=F32) @ np.asarray(b, dtype=F32)).astype(F32)


def look_to_lh(eyepos, eyedir, updir) -> np.ndarray:
    az = normalize3(np.asarray(eyedir, dtype=F32))
    ax = normalize3(cross3(np.asarray(updir, dtype=F32), az))
    ay = normalize3(cross3(az, ax))
    eye = np.asarray(eyepos, dtype=F32)
    return np.array(
        [
            [ax[0], ay[0], az[0], 0.0],
            [ax[1], ay[1], az[1], 0.0],
            [ax[2], ay[2], az[2], 0.0],
            [-dot3(ax, eye), -dot3(ay, eye), -dot3(az, eye), 1.0],
        ],
        dtype=F32,
    )


def look_at_rh(eyepos, focuspos, updir) -> np.ndarray:
    """zmath.lookAtRh: lookToLh(eye, eye - focus)."""
    return look_to_lh(
        eyepos, np.asarray(eyepos, dtype=F32) - np.asarray(focuspos, dtype=F32), updir
    )


def perspective_fov_rh(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """zmath.perspectiveFovRh: ``w_clip = -z_view`` and ``z_ndc`` in [0, 1]
    (0 at z = -near, 1 at z = -far)."""
    assert near > 0.0 and far > 0.0 and far > near
    h = F32(np.cos(F32(0.5 * fovy)) / np.sin(F32(0.5 * fovy)))
    w = F32(h / F32(aspect))
    r = F32(far / (near - far))
    return np.array(
        [[w, 0, 0, 0], [0, h, 0, 0], [0, 0, r, -1], [0, 0, r * near, 0]], dtype=F32
    )
