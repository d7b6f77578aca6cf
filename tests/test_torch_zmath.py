"""The port's ``math/zmath.py`` against the reference's: the same
definitions, and the same bits from every public function on seeded
inputs (vectors, matrices, quaternions, angles, the DirectXMath-style
transcendentals, the load/store forms and the FFT).
"""

import ast
import inspect

import numpy as np
import pytest

from zrenderer_tpu.math import zmath as ref_zm
from zrenderer_tpu_torch.math import zmath as zm

F32 = np.float32


def _module_defs(mod):
    """name -> AST dump (docstrings dropped) of each top-level definition,
    and of each top-level assignment."""
    tree = ast.parse(inspect.getsource(mod))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            out[ast.unparse(node.targets[0])] = ast.dump(node)
    return out


def test_zmath_definitions_match_reference():
    """Definition for definition, the port's module is the reference's."""
    ours, ref = _module_defs(zm), _module_defs(ref_zm)
    assert sorted(ours) == sorted(ref)
    assert [k for k in ref if ours[k] != ref[k]] == []
    assert len([k for k in ref if not k.startswith("_")]) >= 120


def _rng(name):
    """A generator seeded from the function's name."""
    return np.random.default_rng(sum(map(ord, name)))


def _vec(rng, n=4, scale=2.0):
    return (rng.standard_normal(n) * scale).astype(F32)


def _unit(rng, n=3):
    v = rng.standard_normal(n)
    return (v / np.linalg.norm(v)).astype(F32)


def _quat(rng):
    return _unit(rng, 4)


def _mat(rng):
    return rng.standard_normal((4, 4)).astype(F32)


def _angle(rng):
    return float(F32(rng.uniform(-7.0, 7.0)))


def _special(rng):
    v = _vec(rng, 8)
    v[1], v[3], v[6] = np.nan, np.inf, -np.inf
    return v


# name -> function of a seeded Generator giving one argument tuple (several
# tuples where a function has distinct branches).
CASES = {
    "f32x4": lambda r: [tuple(map(float, _vec(r)))],
    "vec3": lambda r: [tuple(map(float, _vec(r, 3)))],
    "splat": lambda r: [(float(_vec(r, 1)[0]),)],
    "load_vec3": lambda r: [(_vec(r, 3),), (_vec(r, 5), 1.0)],
    "load_mat": lambda r: [(_vec(r, 20),)],
    "store_mat": lambda r: [(_mat(r),)],
    "identity": lambda r: [()],
    "dot3": lambda r: [(_vec(r), _vec(r))],
    "cross3": lambda r: [(_vec(r), _vec(r)), (_vec(r, 3), _vec(r, 3))],
    "length3": lambda r: [(_vec(r),)],
    "normalize3": lambda r: [(_vec(r),), (np.zeros(4, F32),)],
    "mul": lambda r: [(_mat(r), _mat(r)), (_vec(r), _mat(r)),
                      (_mat(r), _vec(r))],
    "transpose": lambda r: [(_mat(r),)],
    "translation": lambda r: [tuple(map(float, _vec(r, 3)))],
    "translation_v": lambda r: [(_vec(r),)],
    "scaling": lambda r: [tuple(map(float, _vec(r, 3)))],
    "scaling_v": lambda r: [(_vec(r),)],
    "rotation_x": lambda r: [(_angle(r),)],
    "rotation_y": lambda r: [(_angle(r),)],
    "rotation_z": lambda r: [(_angle(r),)],
    "look_to_lh": lambda r: [(_vec(r), _unit(r, 4), F32([0, 1, 0, 0]))],
    "look_to_rh": lambda r: [(_vec(r), _unit(r, 4), F32([0, 1, 0, 0]))],
    "look_at_lh": lambda r: [(_vec(r), _vec(r), F32([0, 1, 0, 0]))],
    "look_at_rh": lambda r: [(_vec(r), _vec(r), F32([0, 1, 0, 0]))],
    "perspective_fov_lh": lambda r: [(0.7, 1.777, 0.1, 300.0),
                                     (1.2, 0.5, 0.01, 50.0)],
    "perspective_fov_rh": lambda r: [(0.7, 1.777, 0.1, 300.0),
                                     (1.2, 0.5, 0.01, 50.0)],
    "orthographic_lh": lambda r: [(12.0, 7.0, 0.5, 80.0)],
    "orthographic_rh": lambda r: [(12.0, 7.0, 0.5, 80.0)],
    "orthographic_off_center_lh": lambda r: [(-3.0, 5.0, -2.0, 4.5, 0.1,
                                              40.0)],
    "qmul": lambda r: [(_quat(r), _quat(r))],
    "quat_identity": lambda r: [()],
    "mat_from_quat": lambda r: [(_quat(r),)],
    "quat_to_mat": lambda r: [(_quat(r),)],
    "quat_from_mat": lambda r: [(ref_zm.mat_from_quat(_quat(r)),)
                                for _ in range(6)]
    + [(ref_zm.rotation_x(3.1),), (ref_zm.rotation_y(3.1),),
       (ref_zm.rotation_z(3.1),)],
    "mat_to_quat": lambda r: [(ref_zm.mat_from_quat(_quat(r)),)],
    "quat_from_norm_axis_angle": lambda r: [(_unit(r), _angle(r))],
    "quat_from_roll_pitch_yaw": lambda r: [(_angle(r), _angle(r),
                                            _angle(r))],
    "quat_to_euler": lambda r: [(_quat(r),), (F32([0.5, 0.5, 0.5, 0.5]),),
                                (F32([0.7071068, 0, 0, 0.7071068]),)],
    "rotate_vec3": lambda r: [(_quat(r), _vec(r, 3))],
    "trs_matrix": lambda r: [(_vec(r, 3), _quat(r), _vec(r, 3)), (),
                             (list(map(float, _vec(r, 3))),)],
    "f32x8": lambda r: [tuple(map(float, _vec(r, 8)))],
    "f32x16": lambda r: [tuple(map(float, _vec(r, 16)))],
    "f32x4s": lambda r: [(float(_vec(r, 1)[0]),)],
    "f32x8s": lambda r: [(float(_vec(r, 1)[0]),)],
    "f32x16s": lambda r: [(float(_vec(r, 1)[0]),)],
    "u32x4": lambda r: [tuple(int(x) for x in r.integers(0, 2**32, 4))],
    "boolx4": lambda r: [tuple(bool(x) for x in r.integers(0, 2, 4))],
    "splat_int": lambda r: [(_vec(r), 0x7F800000), (_vec(r, 8), 0xFFFFFFFF)],
    "vec3_to_array": lambda r: [(_vec(r),)],
    "all_true": lambda r: [(F32([1, 1, 0, 1]),), (F32([1, 1, 0, 1]), 2)],
    "any_true": lambda r: [(F32([0, 0, 0, 1]),), (F32([0, 0, 0, 1]), 3)],
    "is_near_equal": lambda r: [(_vec(r), _vec(r), F32(1.0))],
    "is_nan": lambda r: [(_special(r),)],
    "is_inf": lambda r: [(_special(r),)],
    "is_in_bounds": lambda r: [(_vec(r, 8), _vec(r, 8))],
    "approx_eq_abs": lambda r: [(_special(r), _special(r), 0.5),
                                (_vec(r), _vec(r), 10.0)],
    "and_int": lambda r: [(_vec(r), _vec(r))],
    "and_not_int": lambda r: [(_vec(r), _vec(r))],
    "or_int": lambda r: [(_vec(r), _vec(r))],
    "nor_int": lambda r: [(_vec(r), _vec(r))],
    "xor_int": lambda r: [(_vec(r), _vec(r))],
    "min_fast": lambda r: [(_special(r), _vec(r, 8))],
    "max_fast": lambda r: [(_special(r), _vec(r, 8))],
    "vmin": lambda r: [(_special(r), _vec(r, 8))],
    "vmax": lambda r: [(_special(r), _vec(r, 8))],
    "clamp": lambda r: [(_vec(r, 8), F32(-0.5), F32(0.7))],
    "clamp_fast": lambda r: [(_vec(r, 8), F32(-0.5), F32(0.7))],
    "saturate": lambda r: [(_special(r),)],
    "saturate_fast": lambda r: [(_special(r),)],
    "vround": lambda r: [(_vec(r, 8, 5.0),), (F32([0.5, 1.5, 2.5, -0.5]),)],
    "trunc": lambda r: [(_vec(r, 8, 5.0),)],
    "floor": lambda r: [(_vec(r, 8, 5.0),)],
    "ceil": lambda r: [(_vec(r, 8, 5.0),)],
    "vsqrt": lambda r: [(np.abs(_vec(r, 8)),)],
    "vabs": lambda r: [(_special(r),)],
    "select": lambda r: [(r.integers(0, 2, 8).astype(bool), _vec(r, 8),
                          _vec(r, 8))],
    "lerp": lambda r: [(_vec(r), _vec(r), 0.3)],
    "lerp_v": lambda r: [(_vec(r), _vec(r), _vec(r))],
    "swizzle": lambda r: [(_vec(r), "w", "x", "z", "y")],
    "mod": lambda r: [(_vec(r, 8, 9.0), _vec(r, 8))],
    "mod_angle": lambda r: [(_vec(r, 16, 20.0),)],
    "mod_angle32": lambda r: [(_vec(r, 16, 20.0),)],
    "mul_add": lambda r: [(_vec(r), _vec(r), _vec(r))],
    "sin": lambda r: [(_vec(r, 64, 10.0),)],
    "cos": lambda r: [(_vec(r, 64, 10.0),)],
    "sincos": lambda r: [(_vec(r, 64, 10.0),)],
    "asin": lambda r: [(r.uniform(-1, 1, 64).astype(F32),)],
    "acos": lambda r: [(r.uniform(-1, 1, 64).astype(F32),)],
    "atan": lambda r: [(_vec(r, 64, 10.0),)],
    "atan2": lambda r: [(_vec(r, 64), _vec(r, 64)),
                        (F32([0, 0, -0.0, 1, np.inf, -np.inf, np.inf, 0]),
                         F32([0, -1, 1, np.inf, np.inf, -np.inf, 2, -0.0]))],
    "dot2": lambda r: [(_vec(r), _vec(r))],
    "dot4": lambda r: [(_vec(r), _vec(r))],
    "length_sq2": lambda r: [(_vec(r),)],
    "length_sq3": lambda r: [(_vec(r),)],
    "length_sq4": lambda r: [(_vec(r),)],
    "length2": lambda r: [(_vec(r),)],
    "length4": lambda r: [(_vec(r),)],
    "normalize2": lambda r: [(_vec(r),)],
    "normalize4": lambda r: [(_vec(r),)],
    "line_point_distance": lambda r: [(_vec(r), _vec(r), _vec(r))],
    "determinant": lambda r: [(_mat(r),)],
    "inverse_det": lambda r: [(_mat(r),), (_mat(r), True),
                              (np.zeros((4, 4), F32), True)],
    "inverse": lambda r: [(_mat(r),)],
    "mat_from_norm_axis_angle": lambda r: [(_unit(r), _angle(r))],
    "mat_from_axis_angle": lambda r: [(_vec(r), _angle(r))],
    "mat_from_roll_pitch_yaw": lambda r: [(_angle(r), _angle(r),
                                           _angle(r))],
    "mat_from_roll_pitch_yaw_v": lambda r: [(_vec(r, 3, 3.0),)],
    "load_mat43": lambda r: [(_vec(r, 12),)],
    "store_mat43": lambda r: [(_mat(r),)],
    "load_mat34": lambda r: [(_vec(r, 12),)],
    "store_mat34": lambda r: [(_mat(r),)],
    "mat_to_array": lambda r: [(_mat(r),)],
    "mat43_to_array": lambda r: [(_mat(r),)],
    "mat34_to_array": lambda r: [(_mat(r),)],
    "conjugate": lambda r: [(_quat(r),)],
    "inverse_quat": lambda r: [(_vec(r),), (np.zeros(4, F32),)],
    "quat_to_axis_angle": lambda r: [(_quat(r),)],
    "quat_from_axis_angle": lambda r: [(_vec(r), _angle(r))],
    "slerp": lambda r: [(_quat(r), _quat(r), 0.3),
                        (F32([0, 0, 0, 1]), F32([0, 0, 0.001, 1]), 0.5)],
    "slerp_v": lambda r: [(_quat(r), _quat(r), _vec(r))],
    "cmul_soa": lambda r: [(_vec(r, 8), _vec(r, 8), _vec(r, 8),
                            _vec(r, 8))],
    "fft_init_unity_table": lambda r: [(4,), (32,), (512,)],
    "fft": lambda r: [(_vec(r, n), _vec(r, n),
                       ref_zm.fft_init_unity_table(n)) for n in (4, 64, 512)],
    "ifft": lambda r: [(_vec(r, n), _vec(r, n),
                        ref_zm.fft_init_unity_table(n)) for n in (8, 128)],
}


def _same_bits(a, b):
    """Equal values of equal types, NaNs and signed zeros included."""
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_bits(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(a, np.generic):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, float):
        return type(b) is float and (np.float64(a).tobytes()
                                     == np.float64(b).tobytes())
    return type(a) is type(b) and a == b


def test_every_public_function_has_a_case():
    public = [n for n, v in vars(ref_zm).items()
              if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", None) == ref_zm.__name__]
    assert sorted(set(public) - set(CASES)) == []


@pytest.mark.parametrize("name", sorted(CASES))
def test_zmath_function_matches_reference(name):
    """Port and reference give the same bits on the same seeded inputs."""
    ours, ref = getattr(zm, name), getattr(ref_zm, name)
    with np.errstate(all="ignore"):
        for args in CASES[name](_rng(name)):
            got = ours(*[np.copy(a) if isinstance(a, np.ndarray) else a
                         for a in args])
            want = ref(*args)
            assert _same_bits(got, want), (name, args, got, want)
