"""Host camera and transform math of the port: the part of
``zrenderer_tpu/math/zmath.py`` that the frame paths' cameras, the
shadow pass's light frustum and the procedural test scene use, copied so
the port runs without the JAX package.

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


def vec3(x: float, y: float, z: float) -> np.ndarray:
    """A 3-component point/direction as an f32x4 with w = 0."""
    return np.array([x, y, z, 0.0], dtype=F32)


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


def orthographic_rh(w: float, h: float, near: float, far: float) -> np.ndarray:
    """zmath.orthographicRh: [0, 1] depth, 0 at z = -near, 1 at z = -far."""
    r = F32(1.0 / (near - far))
    return np.array(
        [[2.0 / w, 0, 0, 0], [0, 2.0 / h, 0, 0], [0, 0, r, 0], [0, 0, r * near, 1]],
        dtype=F32,
    )


def translation(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[3, 0] = x
    m[3, 1] = y
    m[3, 2] = z
    return m


def qmul(q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    """Hamilton product q1 * q0 (applies q0's rotation first)."""
    ax, ay, az, aw = (F32(v) for v in np.asarray(q1, dtype=F32))
    bx, by, bz, bw = (F32(v) for v in np.asarray(q0, dtype=F32))
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dtype=F32,
    )


def quat_from_norm_axis_angle(axis, angle: float) -> np.ndarray:
    """Rotation by ``angle`` about the unit ``axis``."""
    axis = np.asarray(axis, dtype=F32)
    half = F32(0.5 * angle)
    s, c = F32(np.sin(half)), F32(np.cos(half))
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, c], dtype=F32)


def quat_from_roll_pitch_yaw(pitch: float, yaw: float,
                             roll: float) -> np.ndarray:
    """Intrinsic rotations roll (Z), then pitch (X), then yaw (Y) for row
    vectors: qmul(qmul(q_roll, q_pitch), q_yaw)."""
    qx = quat_from_norm_axis_angle((1.0, 0.0, 0.0), pitch)
    qy = quat_from_norm_axis_angle((0.0, 1.0, 0.0), yaw)
    qz = quat_from_norm_axis_angle((0.0, 0.0, 1.0), roll)
    return qmul(qmul(qz, qx), qy)


def mat_from_quat(q: np.ndarray) -> np.ndarray:
    """Rotation matrix for quaternion q, row-vector convention."""
    x, y, z, w = (F32(v) for v in np.asarray(q, dtype=F32))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    two = F32(2.0)
    one = F32(1.0)
    return np.array(
        [
            [one - two * (yy + zz), two * (xy + wz), two * (xz - wy), 0.0],
            [two * (xy - wz), one - two * (xx + zz), two * (yz + wx), 0.0],
            [two * (xz + wy), two * (yz - wx), one - two * (xx + yy), 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=F32,
    )


def quat_to_euler(q: np.ndarray) -> tuple:
    """(x=pitch, y=yaw, z=roll) Tait-Bryan angles of quaternion q."""
    q = np.asarray(q, dtype=F32)
    t0 = F32(2.0) * (q[3] * q[0] + q[1] * q[2])
    t1 = F32(1.0) - F32(2.0) * (q[0] * q[0] + q[1] * q[1])
    x = F32(np.arctan2(t0, t1))
    t2 = F32(2.0) * (q[3] * q[1] - q[2] * q[0])
    t2 = F32(np.clip(t2, -1.0, 1.0))
    y = F32(np.arcsin(t2))
    t3 = F32(2.0) * (q[3] * q[2] + q[0] * q[1])
    t4 = F32(1.0) - F32(2.0) * (q[1] * q[1] + q[2] * q[2])
    z = F32(np.arctan2(t3, t4))
    return x, y, z


def rotate_vec3(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate a 3-vector by quaternion q (v @ mat_from_quat(q))."""
    m = mat_from_quat(q)
    v4 = np.array([v[0], v[1], v[2], 0.0], dtype=F32)
    return (v4 @ m).astype(F32)
