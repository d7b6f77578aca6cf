"""Row-major SIMD-math analog of the reference's zmath library.

The reference renderer does all host-side camera/transform math with zmath
(``zrenderer/libs/zmath/zmath.zig``), a DirectXMath-style library with these
conventions, which we preserve exactly:

* **Row-major matrices, row-vector convention**: points transform as
  ``v' = v @ M`` and transforms compose left-to-right
  (``mul(A, B)`` applies A first). See ``zmath.zig:1957-2010``.
* **Right-handed view space** with the camera looking down -Z
  (``lookAtRh``/``lookToLh``, ``zmath.zig:2111-2130``).
* **D3D-style [0, 1] clip depth** (``perspectiveFovRh``, ``zmath.zig:2157-2175``):
  for a view-space point, ``w_clip = -z_view``.
* **Quaternions as (x, y, z, w)**; ``qmul(q0, q1)`` returns the Hamilton
  product ``q1 * q0`` (DirectXMath ``XMQuaternionMultiply`` order,
  ``zmath.zig:2598-2615``), i.e. the rotation that applies q0 first.

Everything is float32 NumPy — this layer is host math (camera matrices,
asset-pipeline transforms). Device-side math lives in
``zrenderer_tpu_torch.ops``.

The port's copy of the whole of ``zrenderer_tpu/math/zmath.py``, definition
for definition, so the port runs its cameras, the shadow pass's light
frustum and the glTF converter without the JAX package;
``tests/test_torch_zmath.py`` holds the two modules equal.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32

# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------


def f32x4(x: float, y: float, z: float, w: float) -> np.ndarray:
    """A 4-wide float32 vector (zmath ``f32x4``)."""
    return np.array([x, y, z, w], dtype=F32)


def vec3(x: float, y: float, z: float) -> np.ndarray:
    """A 3-component point/direction as an f32x4 with w = 0."""
    return np.array([x, y, z, 0.0], dtype=F32)


def splat(value: float) -> np.ndarray:
    return np.full(4, value, dtype=F32)


def load_vec3(mem, w: float = 0.0) -> np.ndarray:
    """zmath ``load(mem, Vec, 3)``: read 3 floats, set the 4th lane."""
    m = np.asarray(mem, dtype=F32).reshape(-1)
    return np.array([m[0], m[1], m[2], w], dtype=F32)


def load_mat(mem) -> np.ndarray:
    """zmath ``loadMat``: 16 consecutive floats -> 4x4 row-major matrix."""
    return np.asarray(mem, dtype=F32).reshape(-1)[:16].reshape(4, 4).copy()


def store_mat(m: np.ndarray) -> np.ndarray:
    """zmath ``storeMat``/``matToArray``: 4x4 -> flat 16 floats (row-major)."""
    return np.asarray(m, dtype=F32).reshape(16).copy()


def identity() -> np.ndarray:
    return np.eye(4, dtype=F32)


# ---------------------------------------------------------------------------
# Vector ops
# ---------------------------------------------------------------------------


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


def length3(a: np.ndarray) -> F32:
    return F32(np.sqrt(dot3(a, a), dtype=F32))


def normalize3(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=F32)
    n = length3(a)
    out = a.copy()
    out[:3] = a[:3] / n
    out[3] = a[3] / n  # zmath normalize3 divides the whole register
    return out


# ---------------------------------------------------------------------------
# Matrix ops (row-vector convention)
# ---------------------------------------------------------------------------


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """zmath ``mul``: Mat@Mat, Vec@Mat (row vector), Mat*scalar.

    ``mul(A, B)`` composes so that A is applied first: ``v @ A @ B``.
    """
    a = np.asarray(a, dtype=F32)
    b = np.asarray(b, dtype=F32)
    if a.ndim == 1 and b.ndim == 2:
        return (a @ b).astype(F32)
    if a.ndim == 2 and b.ndim == 1:
        return (a @ b).astype(F32)
    return (a @ b).astype(F32)


def transpose(m: np.ndarray) -> np.ndarray:
    return np.asarray(m, dtype=F32).T.copy()


def translation(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[3, 0] = x
    m[3, 1] = y
    m[3, 2] = z
    return m


def translation_v(v) -> np.ndarray:
    v = np.asarray(v, dtype=F32)
    return translation(v[0], v[1], v[2])


def scaling(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[0, 0] = x
    m[1, 1] = y
    m[2, 2] = z
    return m


def scaling_v(v) -> np.ndarray:
    v = np.asarray(v, dtype=F32)
    return scaling(v[0], v[1], v[2])


def rotation_x(angle: float) -> np.ndarray:
    s, c = F32(np.sin(F32(angle))), F32(np.cos(F32(angle)))
    return np.array(
        [[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]], dtype=F32
    )


def rotation_y(angle: float) -> np.ndarray:
    s, c = F32(np.sin(F32(angle))), F32(np.cos(F32(angle)))
    return np.array(
        [[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]], dtype=F32
    )


def rotation_z(angle: float) -> np.ndarray:
    s, c = F32(np.sin(F32(angle))), F32(np.cos(F32(angle)))
    return np.array(
        [[c, s, 0, 0], [-s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=F32
    )


# ---------------------------------------------------------------------------
# View matrices (zmath.zig:2111-2141)
# ---------------------------------------------------------------------------


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


def look_to_rh(eyepos, eyedir, updir) -> np.ndarray:
    return look_to_lh(eyepos, -np.asarray(eyedir, dtype=F32), updir)


def look_at_lh(eyepos, focuspos, updir) -> np.ndarray:
    return look_to_lh(
        eyepos, np.asarray(focuspos, dtype=F32) - np.asarray(eyepos, dtype=F32), updir
    )


def look_at_rh(eyepos, focuspos, updir) -> np.ndarray:
    """Matches zmath.lookAtRh (zmath.zig:2128-2130): lookToLh(eye, eye-focus)."""
    return look_to_lh(
        eyepos, np.asarray(eyepos, dtype=F32) - np.asarray(focuspos, dtype=F32), updir
    )


# ---------------------------------------------------------------------------
# Projection matrices (zmath.zig:2143-2205) — D3D [0,1] depth
# ---------------------------------------------------------------------------


def perspective_fov_lh(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    assert near > 0.0 and far > 0.0 and far > near
    h = F32(np.cos(F32(0.5 * fovy)) / np.sin(F32(0.5 * fovy)))
    w = F32(h / F32(aspect))
    r = F32(far / (far - near))
    return np.array(
        [[w, 0, 0, 0], [0, h, 0, 0], [0, 0, r, 1], [0, 0, -r * near, 0]], dtype=F32
    )


def perspective_fov_rh(fovy: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Matches zmath.perspectiveFovRh (zmath.zig:2159-2175).

    Row-vector convention: for view-space v = (x, y, z, 1),
    ``clip = v @ M`` gives ``w_clip = -z`` and ``z_ndc in [0, 1]`` with
    z_ndc = 0 at z = -near and 1 at z = -far.
    """
    assert near > 0.0 and far > 0.0 and far > near
    h = F32(np.cos(F32(0.5 * fovy)) / np.sin(F32(0.5 * fovy)))
    w = F32(h / F32(aspect))
    r = F32(far / (near - far))
    return np.array(
        [[w, 0, 0, 0], [0, h, 0, 0], [0, 0, r, -1], [0, 0, r * near, 0]], dtype=F32
    )


def orthographic_lh(w: float, h: float, near: float, far: float) -> np.ndarray:
    r = F32(1.0 / (far - near))
    return np.array(
        [[2.0 / w, 0, 0, 0], [0, 2.0 / h, 0, 0], [0, 0, r, 0], [0, 0, -r * near, 1]],
        dtype=F32,
    )


def orthographic_rh(w: float, h: float, near: float, far: float) -> np.ndarray:
    r = F32(1.0 / (near - far))
    return np.array(
        [[2.0 / w, 0, 0, 0], [0, 2.0 / h, 0, 0], [0, 0, r, 0], [0, 0, r * near, 1]],
        dtype=F32,
    )


def orthographic_off_center_lh(
    left: float, right: float, bottom: float, top: float, near: float, far: float
) -> np.ndarray:
    """Off-center LH ortho with [0,1] depth (row-vector convention)."""
    rw = F32(1.0 / (right - left))
    rh = F32(1.0 / (top - bottom))
    rz = F32(1.0 / (far - near))
    return np.array(
        [
            [2.0 * rw, 0, 0, 0],
            [0, 2.0 * rh, 0, 0],
            [0, 0, rz, 0],
            [-(right + left) * rw, -(top + bottom) * rh, -rz * near, 1],
        ],
        dtype=F32,
    )


# ---------------------------------------------------------------------------
# Quaternions — (x, y, z, w), zmath.zig:2598+, 2449+, 2786+
# ---------------------------------------------------------------------------


def qmul(q0: np.ndarray, q1: np.ndarray) -> np.ndarray:
    """zmath.qmul: Hamilton product q1 * q0 (applies q0's rotation first).

    Verified against the zmath unit test (zmath.zig:2615-2621):
    qmul((2,3,4,1), (3,2,1,4)) == (16, 4, 22, -12).
    """
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


def quat_identity() -> np.ndarray:
    return f32x4(0.0, 0.0, 0.0, 1.0)


def mat_from_quat(q: np.ndarray) -> np.ndarray:
    """Rotation matrix for quaternion q, row-vector convention (v' = v @ M).

    Matches zmath.matFromQuat (zmath.zig:2449-2492) /
    DirectXMath XMMatrixRotationQuaternion.
    """
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


quat_to_mat = mat_from_quat


def quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Quaternion from a rotation matrix (row-vector convention).

    Inverse of mat_from_quat; matches zmath.quatFromMat / matToQuat
    (zmath.zig:2509-2597) up to sign (q and -q encode the same rotation).
    """
    m = np.asarray(m, dtype=F32)
    t = m[0, 0] + m[1, 1] + m[2, 2]
    if t > 0.0:
        s = np.sqrt(t + 1.0, dtype=F32)
        w = F32(0.5) * s
        s = F32(0.5) / s
        x = (m[1, 2] - m[2, 1]) * s
        y = (m[2, 0] - m[0, 2]) * s
        z = (m[0, 1] - m[1, 0]) * s
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = np.sqrt(F32(1.0) + m[0, 0] - m[1, 1] - m[2, 2], dtype=F32)
        x = F32(0.5) * s
        s = F32(0.5) / s
        y = (m[0, 1] + m[1, 0]) * s
        z = (m[0, 2] + m[2, 0]) * s
        w = (m[1, 2] - m[2, 1]) * s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(F32(1.0) + m[1, 1] - m[0, 0] - m[2, 2], dtype=F32)
        y = F32(0.5) * s
        s = F32(0.5) / s
        x = (m[0, 1] + m[1, 0]) * s
        z = (m[1, 2] + m[2, 1]) * s
        w = (m[2, 0] - m[0, 2]) * s
    else:
        s = np.sqrt(F32(1.0) + m[2, 2] - m[0, 0] - m[1, 1], dtype=F32)
        z = F32(0.5) * s
        s = F32(0.5) / s
        x = (m[0, 2] + m[2, 0]) * s
        y = (m[1, 2] + m[2, 1]) * s
        w = (m[0, 1] - m[1, 0]) * s
    return np.array([x, y, z, w], dtype=F32)


mat_to_quat = quat_from_mat


def quat_from_norm_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=F32)
    half = F32(0.5 * angle)
    s, c = F32(np.sin(half)), F32(np.cos(half))
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, c], dtype=F32)


def quat_from_roll_pitch_yaw(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """Matches zmath.quatFromRollPitchYaw (zmath.zig:2786-2800):
    intrinsic rotations applied in roll(Z) -> pitch(X) -> yaw(Y) order for
    row-vector matrices, i.e. q = qmul(qmul(q_roll, q_pitch), q_yaw)."""
    qx = quat_from_norm_axis_angle((1.0, 0.0, 0.0), pitch)
    qy = quat_from_norm_axis_angle((0.0, 1.0, 0.0), yaw)
    qz = quat_from_norm_axis_angle((0.0, 0.0, 1.0), roll)
    return qmul(qmul(qz, qx), qy)


def quat_to_euler(q: np.ndarray) -> tuple:
    """The converter's quadToEulerAngles (gltf_converter.zig:210-223):
    extracts (x=pitch, y=yaw, z=roll) Tait-Bryan angles."""
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
    """Rotate a 3-vector by quaternion q (same convention as mat_from_quat:
    rotate_vec3(q, v) == v @ mat_from_quat(q))."""
    m = mat_from_quat(q)
    v4 = np.array([v[0], v[1], v[2], 0.0], dtype=F32)
    return (v4 @ m).astype(F32)


def trs_matrix(translation_xyz=None, rotation_quat=None, scale_xyz=None) -> np.ndarray:
    """Compose a glTF node transform as a row-vector matrix: v' = v @ S @ R @ T.

    This is the row-vector equivalent of glTF's column-vector M = T*R*S.
    DELIBERATE DEVIATION from the reference converter, which composes
    ``mul(mul(mul(I, T), R), S)`` (= v @ T @ R @ S) and also builds the
    rotation quat with a copy-paste typo (``rotation[2]`` where ``[3]`` is
    meant, gltf_converter.zig:405). Its test scene only uses pure
    translations, so the observed image is identical; see docs/QUIRKS.md
    items 3-4 and SURVEY.md §8.
    """
    m = identity()
    if scale_xyz is not None:
        m = mul(m, scaling_v(scale_xyz))
    if rotation_quat is not None:
        m = mul(m, mat_from_quat(rotation_quat))
    if translation_xyz is not None:
        m = mul(m, translation_v(translation_xyz))
    return m


# ===========================================================================
# Full zmath API breadth.
#
# Everything below completes the library to the reference's full public
# surface (zmath.zig exports ~130 functions; the renderer itself uses the
# subset above). All ops are lane-width agnostic: they accept Python floats
# or NumPy arrays of any shape (the analog of zmath's F32x4/F32x8/F32x16
# genericity) and compute in float32. Formulas cite their zmath source; the
# SIMD shuffle choreography is not reproduced — NumPy broadcasting is the
# idiomatic equivalent.
# ===========================================================================

_PI = F32(np.pi)
_TAU = F32(2.0 * np.pi)
_HALF_PI = F32(0.5 * np.pi)


def _f32(v) -> np.ndarray:
    return np.asarray(v, dtype=F32)


# ---------------------------------------------------------------------------
# Wide constructors (zmath.zig:258-303)
# ---------------------------------------------------------------------------


def f32x8(*vals) -> np.ndarray:
    assert len(vals) == 8
    return np.array(vals, dtype=F32)


def f32x16(*vals) -> np.ndarray:
    assert len(vals) == 16
    return np.array(vals, dtype=F32)


def f32x4s(value: float) -> np.ndarray:
    return np.full(4, value, dtype=F32)


def f32x8s(value: float) -> np.ndarray:
    return np.full(8, value, dtype=F32)


def f32x16s(value: float) -> np.ndarray:
    return np.full(16, value, dtype=F32)


def u32x4(x: int, y: int, z: int, w: int) -> np.ndarray:
    return np.array([x, y, z, w], dtype=np.uint32)


def boolx4(x: bool, y: bool, z: bool, w: bool) -> np.ndarray:
    return np.array([x, y, z, w], dtype=bool)


def splat_int(shape_like, value: int) -> np.ndarray:
    """zmath.splatInt: fill lanes with a u32 bit pattern, viewed as f32."""
    n = np.shape(_f32(shape_like))
    return np.full(n if n else (), value, dtype=np.uint32).view(F32)


def vec3_to_array(v) -> np.ndarray:
    """zmath.vec3ToArray (zmath.zig:371-378): first three lanes."""
    return _f32(v)[:3].copy()


# ---------------------------------------------------------------------------
# Predicates (zmath.zig:381-541)
# ---------------------------------------------------------------------------


def all_true(mask, length: int = 0) -> bool:
    """zmath.all: every lane true (or the first ``length`` lanes if > 0)."""
    m = np.asarray(mask, dtype=bool).reshape(-1)
    return bool(m.all()) if length == 0 else bool(m[:length].all())


def any_true(mask, length: int = 0) -> bool:
    m = np.asarray(mask, dtype=bool).reshape(-1)
    return bool(m.any()) if length == 0 else bool(m[:length].any())


def is_near_equal(v0, v1, epsilon) -> np.ndarray:
    """zmath.isNearEqual (zmath.zig:428-448): |v0 - v1| <= eps, lanewise."""
    return np.abs(_f32(v0) - _f32(v1)) <= _f32(epsilon)


def is_nan(v) -> np.ndarray:
    """zmath.isNan (zmath.zig:473-489): v != v, lanewise."""
    return np.isnan(_f32(v))


def is_inf(v) -> np.ndarray:
    return np.isinf(_f32(v))


def is_in_bounds(v, bounds) -> np.ndarray:
    """zmath.isInBounds (zmath.zig:510-541): -bounds <= v <= bounds."""
    v = _f32(v)
    b = _f32(bounds)
    return (v <= b) & (v >= -b)


def approx_eq_abs(v0, v1, eps: float) -> bool:
    """zmath.approxEqAbs (zmath.zig:3826): all lanes within eps (exact
    equality covers matching infinities; NaN lanes match NaN lanes)."""
    a, b = _f32(v0), _f32(v1)
    a, b = np.broadcast_arrays(np.atleast_1d(a), np.atleast_1d(b))
    both_nan = np.isnan(a) & np.isnan(b)
    exact = a == b
    with np.errstate(invalid="ignore"):
        close = np.abs(a - b) <= F32(eps)
    return bool(np.all(both_nan | exact | close))


# ---------------------------------------------------------------------------
# Bitwise ops on f32 lanes (zmath.zig:543-651)
# ---------------------------------------------------------------------------


def _as_u32(v) -> np.ndarray:
    a = np.atleast_1d(_f32(v)).copy()
    return a.view(np.uint32)


def and_int(v0, v1) -> np.ndarray:
    return (_as_u32(v0) & _as_u32(v1)).view(F32)


def and_not_int(v0, v1) -> np.ndarray:
    """zmath.andNotInt: ~v0 & v1 (andnps operand order)."""
    return (~_as_u32(v0) & _as_u32(v1)).view(F32)


def or_int(v0, v1) -> np.ndarray:
    return (_as_u32(v0) | _as_u32(v1)).view(F32)


def nor_int(v0, v1) -> np.ndarray:
    return (~(_as_u32(v0) | _as_u32(v1))).view(F32)


def xor_int(v0, v1) -> np.ndarray:
    return (_as_u32(v0) ^ _as_u32(v1)).view(F32)


# ---------------------------------------------------------------------------
# Min/max/clamp/saturate (zmath.zig:653-778, 1150-1247)
# ---------------------------------------------------------------------------


def min_fast(v0, v1) -> np.ndarray:
    """zmath.minFast: select(v0 < v1, v0, v1) — the raw minps semantics
    (second operand wins on NaN in the first)."""
    a, b = _f32(v0), _f32(v1)
    return np.where(a < b, a, b)


def max_fast(v0, v1) -> np.ndarray:
    a, b = _f32(v0), _f32(v1)
    return np.where(a > b, a, b)


def vmin(v0, v1) -> np.ndarray:
    """zmath.min: IEEE-style min that prefers the non-NaN operand
    (@minimum semantics: NaN only if both are NaN)."""
    return np.fmin(_f32(v0), _f32(v1))


def vmax(v0, v1) -> np.ndarray:
    return np.fmax(_f32(v0), _f32(v1))


def clamp(v, lo, hi) -> np.ndarray:
    """zmath.clamp: min(vmax, max(vmin, v)) with NaN-suppressing min/max."""
    return vmin(hi, vmax(lo, v))


def clamp_fast(v, lo, hi) -> np.ndarray:
    return min_fast(hi, max_fast(lo, v))


def saturate(v) -> np.ndarray:
    """zmath.saturate: clamp to [0, 1]; NaN -> 0 (matches the zmath tests)."""
    return vmin(F32(1.0), vmax(F32(0.0), v))


def saturate_fast(v) -> np.ndarray:
    return min_fast(F32(1.0), max_fast(F32(0.0), v))


# ---------------------------------------------------------------------------
# Rounding, interpolation, misc lanewise (zmath.zig:779-1331)
# ---------------------------------------------------------------------------


def vround(v) -> np.ndarray:
    """zmath.round: round-half-to-even (vroundps $0)."""
    return np.rint(_f32(v)).astype(F32)


def trunc(v) -> np.ndarray:
    return np.trunc(_f32(v)).astype(F32)


def floor(v) -> np.ndarray:
    return np.floor(_f32(v)).astype(F32)


def ceil(v) -> np.ndarray:
    return np.ceil(_f32(v)).astype(F32)


def vsqrt(v) -> np.ndarray:
    return np.sqrt(_f32(v), dtype=F32)


def vabs(v) -> np.ndarray:
    return np.abs(_f32(v))


def select(mask, v0, v1) -> np.ndarray:
    """zmath.select: lanewise mask ? v0 : v1."""
    return np.where(np.asarray(mask, dtype=bool), _f32(v0), _f32(v1))


def lerp(v0, v1, t: float) -> np.ndarray:
    a, b = _f32(v0), _f32(v1)
    return a + (b - a) * F32(t)


def lerp_v(v0, v1, t) -> np.ndarray:
    a, b = _f32(v0), _f32(v1)
    return a + (b - a) * _f32(t)


_SWIZZLE_LANES = {"x": 0, "y": 1, "z": 2, "w": 3}


def swizzle(v, x: str, y: str, z: str, w: str) -> np.ndarray:
    """zmath.swizzle(v, .x, .y, .z, .w) with component names as strings."""
    v = _f32(v)
    idx = [_SWIZZLE_LANES[c] for c in (x, y, z, w)]
    return v[idx].copy()


def mod(v0, v1) -> np.ndarray:
    """zmath.mod: v0 - v1 * trunc(v0 / v1) (C fmod semantics)."""
    a, b = _f32(v0), _f32(v1)
    return a - b * trunc(a / b)


def mod_angle(v) -> np.ndarray:
    """zmath.modAngle: wrap to [-pi, pi] via round-half-even."""
    v = _f32(v)
    return (v - _TAU * vround(v * F32(1.0 / _TAU))).astype(F32)


mod_angle32 = mod_angle  # scalar alias (zmath.zig:3058)


def mul_add(v0, v1, v2) -> np.ndarray:
    """zmath.mulAdd: v0 * v1 + v2 (FMA when available; plain here, which is
    what zmath itself does on targets without HW fma)."""
    return (_f32(v0) * _f32(v1) + _f32(v2)).astype(F32)


# ---------------------------------------------------------------------------
# Transcendentals — the exact DirectXMath minimax polynomials used by zmath
# (sin/cos 11/10-degree: zmath.zig:1325-1457; asin/acos 7-degree:
# :1504-1566; atan 17-degree: :1568-1631; atan2 special-case table: :1632).
# Max error ~1e-7 over the wrapped range, like the SIMD originals.
# ---------------------------------------------------------------------------


def sin(v) -> np.ndarray:
    x = mod_angle(v)
    sign = np.signbit(x)
    c = np.where(sign, -_PI, _PI).astype(F32)
    rflx = (c - x).astype(F32)
    x = np.where(np.abs(x) <= _HALF_PI, x, rflx)
    x2 = (x * x).astype(F32)
    r = mul_add(F32(-2.3889859e-08), x2, F32(2.7525562e-06))
    r = mul_add(r, x2, F32(-0.00019840874))
    r = mul_add(r, x2, F32(0.0083333310))
    r = mul_add(r, x2, F32(-0.16666667))
    r = mul_add(r, x2, F32(1.0))
    return (x * r).astype(F32)


def cos(v) -> np.ndarray:
    x = mod_angle(v)
    sign = np.signbit(x)
    c = np.where(sign, -_PI, _PI).astype(F32)
    rflx = (c - x).astype(F32)
    comp = np.abs(x) <= _HALF_PI
    x = np.where(comp, x, rflx)
    csign = np.where(comp, F32(1.0), F32(-1.0)).astype(F32)
    x2 = (x * x).astype(F32)
    r = mul_add(F32(-2.6051615e-07), x2, F32(2.4760495e-05))
    r = mul_add(r, x2, F32(-0.0013888378))
    r = mul_add(r, x2, F32(0.041666638))
    r = mul_add(r, x2, F32(-0.5))
    r = mul_add(r, x2, F32(1.0))
    return (csign * r).astype(F32)


def sincos(v) -> tuple:
    """zmath.sincos: both at once (shared range reduction)."""
    return sin(v), cos(v)


def asin(v) -> np.ndarray:
    v = _f32(v)
    x = np.abs(v)
    root = vsqrt(max_fast(F32(0.0), (F32(1.0) - x).astype(F32)))
    t0 = mul_add(F32(-0.0012624911), x, F32(0.0066700901))
    t0 = mul_add(t0, x, F32(-0.0170881256))
    t0 = mul_add(t0, x, F32(0.0308918810))
    t0 = mul_add(t0, x, F32(-0.0501743046))
    t0 = mul_add(t0, x, F32(0.0889789874))
    t0 = mul_add(t0, x, F32(-0.2145988016))
    t0 = (root * mul_add(t0, x, F32(1.5707963050))).astype(F32)
    t1 = (_PI - t0).astype(F32)
    return (_HALF_PI - np.where(v >= 0.0, t0, t1)).astype(F32)


def acos(v) -> np.ndarray:
    v = _f32(v)
    x = np.abs(v)
    root = vsqrt(max_fast(F32(0.0), (F32(1.0) - x).astype(F32)))
    t0 = mul_add(F32(-0.0012624911), x, F32(0.0066700901))
    t0 = mul_add(t0, x, F32(-0.0170881256))
    t0 = mul_add(t0, x, F32(0.0308918810))
    t0 = mul_add(t0, x, F32(-0.0501743046))
    t0 = mul_add(t0, x, F32(0.0889789874))
    t0 = mul_add(t0, x, F32(-0.2145988016))
    t0 = (root * mul_add(t0, x, F32(1.5707963050))).astype(F32)
    t1 = (_PI - t0).astype(F32)
    return np.where(v >= 0.0, t0, t1).astype(F32)


def atan(v) -> np.ndarray:
    v = _f32(v)
    vabs_ = np.abs(v)
    with np.errstate(divide="ignore"):
        vinv = (F32(1.0) / v).astype(F32)
    comp = vabs_ <= F32(1.0)
    sign = np.where(v > 1.0, F32(1.0), F32(-1.0))
    sign = np.where(comp, F32(0.0), sign).astype(F32)
    x = np.where(comp, v, vinv).astype(F32)
    x2 = (x * x).astype(F32)
    r = mul_add(F32(0.0028662257), x2, F32(-0.0161657367))
    r = mul_add(r, x2, F32(0.0429096138))
    r = mul_add(r, x2, F32(-0.0752896400))
    r = mul_add(r, x2, F32(0.1065626393))
    r = mul_add(r, x2, F32(-0.1420889944))
    r = mul_add(r, x2, F32(0.1999355085))
    r = mul_add(r, x2, F32(-0.3333314528))
    r = (x * mul_add(r, x2, F32(1.0))).astype(F32)
    r1 = (sign * _HALF_PI - r).astype(F32)
    return np.where(sign == 0.0, r, r1).astype(F32)


def atan2(vy, vx) -> np.ndarray:
    """zmath.atan2 with the full DirectXMath special-case table
    (zmath.zig:1655-1668): signed zeros, axes, and infinities."""
    y, x = np.atleast_1d(_f32(vy)), np.atleast_1d(_f32(vx))
    y, x = np.broadcast_arrays(y, x)
    y_sign = np.where(np.signbit(y), F32(-1.0), F32(1.0)).astype(F32)
    x_pos = ~np.signbit(x)

    with np.errstate(divide="ignore", invalid="ignore"):
        base = atan(y / x)
    result = np.where(x_pos, base, base + y_sign * _PI).astype(F32)

    # Special cases override the generic path.
    y_zero, x_zero = y == 0.0, x == 0.0
    y_inf, x_inf = np.isinf(y), np.isinf(x)
    result = np.where(y_zero & x_pos, y_sign * F32(0.0), result)
    result = np.where(y_zero & ~x_pos, y_sign * _PI, result)
    result = np.where(~y_zero & x_zero, y_sign * _HALF_PI, result)
    result = np.where(x_inf & ~y_inf & x_pos, y_sign * F32(0.0), result)
    result = np.where(x_inf & ~y_inf & ~x_pos, y_sign * _PI, result)
    result = np.where(y_inf & ~x_inf, y_sign * _HALF_PI, result)
    result = np.where(y_inf & x_inf & x_pos, y_sign * F32(0.25 * np.pi), result)
    result = np.where(y_inf & x_inf & ~x_pos, y_sign * F32(0.75 * np.pi), result)
    out = result.astype(F32)
    return out if out.shape != (1,) or np.shape(vy) or np.shape(vx) else out[0]


# ---------------------------------------------------------------------------
# 2D/4D vector ops completing dot3/cross3/length3 (zmath.zig:1756-1931)
# ---------------------------------------------------------------------------


def dot2(a, b) -> F32:
    a, b = _f32(a), _f32(b)
    return F32(a[0] * b[0] + a[1] * b[1])


def dot4(a, b) -> F32:
    a, b = _f32(a), _f32(b)
    return F32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3])


def length_sq2(a) -> F32:
    return dot2(a, a)


def length_sq3(a) -> F32:
    return dot3(a, a)


def length_sq4(a) -> F32:
    return dot4(a, a)


def length2(a) -> F32:
    return F32(np.sqrt(dot2(a, a), dtype=F32))


def length4(a) -> F32:
    return F32(np.sqrt(dot4(a, a), dtype=F32))


def normalize2(a) -> np.ndarray:
    a = _f32(a)
    return (a / length2(a)).astype(F32)


def normalize4(a) -> np.ndarray:
    a = _f32(a)
    return (a / length4(a)).astype(F32)


def line_point_distance(linept0, linept1, pt) -> F32:
    """zmath.linePointDistance (zmath.zig:2829-2834)."""
    p0, p1, p = _f32(linept0), _f32(linept1), _f32(pt)
    ptvec = p - p0
    linevec = p1 - p0
    scale = dot3(ptvec, linevec) / length_sq3(linevec)
    return length3((ptvec - linevec * scale).astype(F32))


# ---------------------------------------------------------------------------
# Matrix breadth: determinant/inverse, axis-angle, Euler, 4x3/3x4 IO
# (zmath.zig:2203-2377, 2378-2448, 2502-2596)
# ---------------------------------------------------------------------------


def determinant(m) -> F32:
    """4x4 determinant by cofactor expansion (zmath.zig:2203-2245).
    Returns a scalar (zmath splats it across a register)."""
    m = _f32(m)
    # 2x2 sub-determinants of the lower two rows.
    c, d = m[2], m[3]
    s0 = c[0] * d[1] - c[1] * d[0]
    s1 = c[0] * d[2] - c[2] * d[0]
    s2 = c[0] * d[3] - c[3] * d[0]
    s3 = c[1] * d[2] - c[2] * d[1]
    s4 = c[1] * d[3] - c[3] * d[1]
    s5 = c[2] * d[3] - c[3] * d[2]
    a, b = m[0], m[1]
    det = (
        a[0] * (b[1] * s5 - b[2] * s4 + b[3] * s3)
        - a[1] * (b[0] * s5 - b[2] * s2 + b[3] * s1)
        + a[2] * (b[0] * s4 - b[1] * s2 + b[3] * s0)
        - a[3] * (b[0] * s3 - b[1] * s1 + b[2] * s0)
    )
    return F32(det)


def inverse_det(m, return_det: bool = False):
    """zmath.inverseDet (zmath.zig:2259-2377): 4x4 inverse via the adjugate,
    all-zero matrix when singular (matches XMMatrixInverse)."""
    m = _f32(m)
    det = determinant(m)
    if det == 0.0 or not np.isfinite(det):
        inv = np.zeros((4, 4), dtype=F32)
        return (inv, det) if return_det else inv
    # Adjugate: cofactor matrix transposed, computed in f64 for the
    # intermediate products then rounded once (the SIMD version's FMA
    # grouping differs lane-by-lane anyway; the contract is the inverse).
    a = m.astype(np.float64)
    adj = np.empty((4, 4), dtype=np.float64)
    for i in range(4):
        for j in range(4):
            sub = np.delete(np.delete(a, i, axis=0), j, axis=1)
            cof = ((-1.0) ** (i + j)) * np.linalg.det(sub)
            adj[j, i] = cof
    inv = (adj / float(det)).astype(F32)
    return (inv, det) if return_det else inv


def inverse(a) -> np.ndarray:
    """zmath.inverse: 4x4 matrix -> inverseDet; quaternion -> conj/|q|^2."""
    a = _f32(a)
    if a.ndim == 2:
        return inverse_det(a)
    return inverse_quat(a)


def mat_from_norm_axis_angle(axis, angle: float) -> np.ndarray:
    """Rodrigues rotation for a normalized axis (zmath.zig:2378-2414),
    row-vector convention (matches rotation_x/y/z)."""
    s, c = F32(np.sin(F32(angle))), F32(np.cos(F32(angle)))
    t = F32(1.0) - c
    x, y, z = (F32(v) for v in _f32(axis)[:3])
    return np.array(
        [
            [t * x * x + c, t * x * y + s * z, t * x * z - s * y, 0.0],
            [t * x * y - s * z, t * y * y + c, t * y * z + s * x, 0.0],
            [t * x * z + s * y, t * y * z - s * x, t * z * z + c, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=F32,
    )


def mat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = _f32(axis)
    assert not np.all(axis[:3] == 0.0)
    assert not np.any(np.isinf(axis[:3]))
    return mat_from_norm_axis_angle(normalize3(axis), angle)


def mat_from_roll_pitch_yaw(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """zmath.matFromRollPitchYaw: roll(Z), then pitch(X), then yaw(Y)
    (verified by the zmath test: == mul(Rz, mul(Rx, Ry)))."""
    return mul(mul(rotation_z(roll), rotation_x(pitch)), rotation_y(yaw))


def mat_from_roll_pitch_yaw_v(angles) -> np.ndarray:
    a = _f32(angles)
    return mat_from_roll_pitch_yaw(a[0], a[1], a[2])


def load_mat43(mem) -> np.ndarray:
    """zmath.loadMat43: 12 floats = 4 rows of xyz; w column = 0,0,0,1."""
    a = _f32(mem).reshape(-1)[:12].reshape(4, 3)
    m = identity()
    m[:, :3] = a
    return m


def store_mat43(m) -> np.ndarray:
    return _f32(m)[:, :3].reshape(12).copy()


def load_mat34(mem) -> np.ndarray:
    """zmath.loadMat34: 12 floats = 3 full rows; last row = 0,0,0,1."""
    a = _f32(mem).reshape(-1)[:12].reshape(3, 4)
    m = identity()
    m[:3, :] = a
    return m


def store_mat34(m) -> np.ndarray:
    return _f32(m)[:3, :].reshape(12).copy()


mat_to_array = store_mat
mat43_to_array = store_mat43
mat34_to_array = store_mat34


# ---------------------------------------------------------------------------
# Quaternion breadth (zmath.zig:2627-2828)
# ---------------------------------------------------------------------------


def conjugate(q) -> np.ndarray:
    return (_f32(q) * np.array([-1.0, -1.0, -1.0, 1.0], dtype=F32)).astype(F32)


def inverse_quat(q) -> np.ndarray:
    """zmath.inverseQuat: conj(q) / |q|^2, zero for degenerate q."""
    q = _f32(q)
    l = length_sq4(q)
    if l <= np.finfo(np.float32).eps:
        return np.zeros(4, dtype=F32)
    return (conjugate(q) / l).astype(F32)


def quat_to_axis_angle(q) -> tuple:
    """zmath.quatToAxisAngle: (axis=xyz lanes unnormalized, angle=2 acos(w))."""
    q = _f32(q)
    return q.copy(), F32(2.0 * np.arccos(np.clip(q[3], -1.0, 1.0), dtype=F32))


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = _f32(axis)
    assert not np.all(axis[:3] == 0.0)
    assert not np.any(np.isinf(axis[:3]))
    return quat_from_norm_axis_angle(normalize3(axis)[:3], angle)


def slerp(q0, q1, t: float) -> np.ndarray:
    """zmath.slerp (zmath.zig:2755-2784): shortest-arc spherical lerp with
    the DirectXMath near-parallel linear fallback (cos > 1 - 1e-5)."""
    q0, q1 = _f32(q0), _f32(q1)
    cos_omega = dot4(q0, q1)
    sign = F32(-1.0) if cos_omega < 0.0 else F32(1.0)
    cos_omega = cos_omega * sign
    if cos_omega < F32(1.0 - 0.00001):
        sin_omega = F32(np.sqrt(F32(1.0) - cos_omega * cos_omega, dtype=F32))
        omega = F32(np.arctan2(sin_omega, cos_omega, dtype=F32))
        s0 = F32(np.sin(F32((1.0 - t) * omega), dtype=F32) / sin_omega)
        s1 = F32(np.sin(F32(t * omega), dtype=F32) / sin_omega)
    else:
        s0, s1 = F32(1.0 - t), F32(t)
    return (q0 * s0 + sign * q1 * s1).astype(F32)


def slerp_v(q0, q1, t) -> np.ndarray:
    return slerp(q0, q1, float(np.reshape(_f32(t), (-1,))[0]))


# ---------------------------------------------------------------------------
# Complex SoA helpers + FFT (zmath.zig:3069-3660; based on xdsp.h
# capability: split-complex radix FFT over 4..512 samples).
#
# The API contract matches zmath: build a unity (twiddle) table once with
# fft_init_unity_table(n), then fft/ifft split re/im arrays in place
# semantics (returned here, functional style). Forward is unnormalized;
# inverse scales by 1/N (implemented, like xdsp, as a forward transform of
# (re/N, -im/N) returning the conjugate-symmetric result's real layout).
# The implementation is an original iterative radix-2 DIT in NumPy — the
# SIMD radix-4 butterfly choreography is x86-specific and not reproduced.
# ---------------------------------------------------------------------------


def cmul_soa(re0, im0, re1, im1) -> tuple:
    """zmath.cmulSoa: lanewise complex multiply on split re/im arrays."""
    re0, im0 = _f32(re0), _f32(im0)
    re1, im1 = _f32(re1), _f32(im1)
    return (
        (re0 * re1 - im0 * im1).astype(F32),
        (re1 * im0 + re0 * im1).astype(F32),
    )


def fft_init_unity_table(n: int) -> np.ndarray:
    """Twiddle table for an n-point FFT: (log2(n)-1, n/2) interleaved as
    (cos, -sin) pairs flattened to one f32 array per stage. n in [32, 512]
    in zmath (smaller sizes use hardcoded kernels; here any pow2 >= 4)."""
    assert n >= 4 and (n & (n - 1)) == 0
    stages = []
    length = n
    while length >= 2:
        k = np.arange(length // 2, dtype=np.float64)
        ang = 2.0 * np.pi * k / length
        stages.append(np.stack([np.cos(ang), -np.sin(ang)], axis=0).astype(F32))
        length //= 2
    # Ragged stage list packed into one array: offsets are implicit from n.
    return np.concatenate([s.reshape(-1) for s in stages])


def _fft_core(re: np.ndarray, im: np.ndarray, table: np.ndarray) -> tuple:
    n = re.shape[0]
    # Bit-reversal permutation.
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    bits = int(n).bit_length() - 1
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    re, im = re[rev].copy(), im[rev].copy()
    # Iterative DIT: stage s merges blocks of size `half` into `length`.
    offset = 0
    stage_tw = []
    length = n
    while length >= 2:
        stage_tw.append(table[offset : offset + length].reshape(2, length // 2))
        offset += length
        length //= 2
    for s, length in enumerate(2 ** np.arange(1, bits + 1)):
        half = int(length) // 2
        tw = stage_tw[bits - 1 - s]  # table stage with matching length
        wr, wi = tw[0], tw[1]
        blocks = re.reshape(-1, int(length))
        blocks_im = im.reshape(-1, int(length))
        even_r, odd_r = blocks[:, :half], blocks[:, half:]
        even_i, odd_i = blocks_im[:, :half], blocks_im[:, half:]
        tr = odd_r * wr - odd_i * wi
        ti = odd_r * wi + odd_i * wr
        blocks[:, :half], blocks[:, half:] = even_r + tr, even_r - tr
        blocks_im[:, :half], blocks_im[:, half:] = even_i + ti, even_i - ti
        re, im = blocks.reshape(-1), blocks_im.reshape(-1)
    return re.astype(F32), im.astype(F32)


def fft(re, im, unity_table) -> tuple:
    """Forward DFT of split-complex (re, im); returns (re, im)."""
    re, im = _f32(re).reshape(-1), _f32(im).reshape(-1)
    n = re.shape[0]
    assert n >= 4 and (n & (n - 1)) == 0 and n <= 512
    assert im.shape[0] == n
    return _fft_core(re, im, _f32(unity_table))


def ifft(re, im, unity_table) -> tuple:
    """Inverse DFT with 1/N scaling (zmath.ifft: forward pass over
    (re/N, -im/N), then the result's imaginary part is negated)."""
    re, im = _f32(re).reshape(-1), _f32(im).reshape(-1)
    n = re.shape[0]
    rr, ri = _fft_core(
        (re * F32(1.0 / n)).astype(F32),
        (im * F32(-1.0 / n)).astype(F32),
        _f32(unity_table),
    )
    return rr, (-ri).astype(F32)
