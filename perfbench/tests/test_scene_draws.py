"""A scene of several draws, each with its own transform, runs through
the whole harness as the one-draw scenes do: the port's scene gets a mesh
and a node a draw, and the plain reference moves each draw's triangles by
its own matrices (and, shadowed, fits the light to the moved bounds), so
``correct`` holds.  A later scene kind of many nodes needs no change to
either; a builder's ``prepare`` runs once the scene is loaded."""

import time

import numpy as np
import pytest

from perfbench import harness, scenes


def _two_draws(params, seed):
    a = scenes.module("lattice").build({"triangles": 360}, seed)
    b = scenes.module("soup").build({"triangles": 240, "extent": 3.0},
                                    seed + 1)
    c, s = np.cos(0.7), np.sin(0.7)
    turn = np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0],
                     [0, 0, 0, 1]], np.float32)
    move = np.eye(4, dtype=np.float32)
    move[3, :3] = (6.0, 1.5, -2.0)
    scale = np.diag([0.5, 0.75, 0.5, 1.0]).astype(np.float32)
    a.draws[0].transform = turn
    b.draws[0].transform = (scale @ move).astype(np.float32)
    a.draws.append(b.draws[0])
    a.center = np.array([2.0, 0.5, -1.0], np.float32)
    a.eye = a.eye * np.float32(1.3) + a.center
    return a


@pytest.mark.parametrize("name", ["flat.lattice1m.orbit",
                                  "shadowed.lattice1m.orbit"])
def test_two_transformed_draws_are_correct(name, small_cell, monkeypatch):
    monkeypatch.setattr(scenes, "make_scene", _two_draws)
    cell = small_cell(name, frames_per_turn=24)
    cell.limits = {k: 0 for k in cell.limits}
    out = harness.run_cell(cell, 77, 1.5, False, "cpu", time.perf_counter(),
                           log=lambda m: None)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1


def test_both_draws_are_in_view():
    from perfbench.reference import common, flat
    from perfbench.reference.precision import F32

    arrays = _two_draws(None, 77)
    orbit = scenes.Orbit(arrays, {"frames_per_turn": 24}, 77)
    inputs = common.Inputs(arrays, {"width": 160, "height": 96}, "cpu")
    rows, _ = flat.camera_rows(inputs, orbit.camera(0), F32)
    first = arrays.draws[0].indices.size // 3
    alive = rows.alive[:inputs.rows_in]
    assert alive[:first].sum() > 10 and alive[first:].sum() > 10


def test_scene_prepare_runs_after_load_scene(small_cell, monkeypatch):
    import types

    seen = []

    def prepare(renderer, arrays):
        seen.append((renderer.flat.num_triangles, arrays.num_triangles))

    lattice = scenes.module("lattice")
    kind = types.SimpleNamespace(build=lattice.build, prepare=prepare)
    monkeypatch.setattr(scenes, "module", lambda name: kind)
    cell = small_cell("flat.lattice1m.orbit", frames_per_turn=24)
    out = harness.run_cell(cell, 5, 0.5, False, "cpu", time.perf_counter(),
                           log=lambda m: None)
    assert out["correct"], out["check"]
    assert seen and seen[0][0] == seen[0][1] > 0
