"""The benchmark's frozen scene generators equal the port's at small
sizes, and every seed gives the same sizes."""

import numpy as np
import pytest

from perfbench import scenes


def _port_arrays(scene, mesh_data):
    mesh = mesh_data.meshes[scene.nodes[0].mesh_indices[0]]
    return (mesh_data.vertices_of(mesh), mesh_data.indices_of(mesh),
            scene.cameras[0])


@pytest.mark.parametrize("n,seed", [(600, 0), (2400, 7), (12000, 2**31 + 5)])
def test_lattice_equals_make_stress_scene(n, seed):
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene

    verts, idx, cam = _port_arrays(*make_stress_scene(n, seed))
    mine = scenes.make_scene({"kind": "lattice", "triangles": n}, seed)
    assert len(mine.draws) == 1
    np.testing.assert_array_equal(mine.draws[0].vertices, verts)
    np.testing.assert_array_equal(mine.draws[0].indices, idx)
    np.testing.assert_array_equal(mine.draws[0].transform, np.eye(4))
    np.testing.assert_array_equal(mine.eye, cam.position)
    assert (mine.yfov, mine.znear, mine.zfar) == (cam.yfov, cam.znear,
                                                  cam.zfar)


@pytest.mark.parametrize("n,seed,extent", [(500, 1, 6.0), (3000, 99, 4.0)])
def test_soup_equals_make_triangle_soup(n, seed, extent):
    from zrenderer_tpu_torch.scene.procedural import make_triangle_soup

    verts, idx, cam = _port_arrays(*make_triangle_soup(n, seed,
                                                       extent=extent))
    mine = scenes.make_scene({"kind": "soup", "triangles": n,
                              "extent": extent}, seed)
    np.testing.assert_array_equal(mine.draws[0].vertices, verts)
    np.testing.assert_array_equal(mine.draws[0].indices, idx)
    np.testing.assert_array_equal(mine.eye, cam.position)


@pytest.mark.parametrize("kind", ["lattice", "soup"])
def test_every_seed_gives_the_same_sizes(kind):
    params = {"kind": kind, "triangles": 1200, "extent": 6.0}
    a = scenes.make_scene(params, 1)
    b = scenes.make_scene(params, 3_000_000_017)
    assert [d.vertices.shape for d in a.draws] == \
        [d.vertices.shape for d in b.draws]
    assert [d.indices.shape for d in a.draws] == \
        [d.indices.shape for d in b.draws]


def test_orbit_turns_about_the_centre():
    s = scenes.make_scene({"kind": "lattice", "triangles": 1200}, 3)
    orbit = scenes.Orbit(s, {"frames_per_turn": 4}, 3)
    cams = [orbit.camera(i) for i in range(5)]
    radius = np.hypot(s.eye[0], s.eye[2])
    for c in cams:
        assert np.isclose(np.hypot(c.position[0], c.position[2]), radius,
                          rtol=1e-6)
        assert np.isclose(c.position[1], s.eye[1], rtol=1e-6)
        np.testing.assert_allclose(
            c.forward, -c.position / np.linalg.norm(c.position), rtol=1e-6)
    np.testing.assert_array_equal(cams[0].position, cams[4].position)
    assert scenes.Orbit(s, {"frames_per_turn": 4}, 4).azimuth0 \
        != orbit.azimuth0


def test_scene_kinds_are_files_found_by_name():
    assert scenes.module("soup").build is not None
    for bad in ("../run", "scenes.lattice", ""):
        with pytest.raises(ValueError):
            scenes.module(bad)
    with pytest.raises(ModuleNotFoundError):
        scenes.make_scene({"kind": "no_such_kind"}, 1)


def test_orbit_turns_about_the_scene_centre():
    s = scenes.make_scene({"kind": "lattice", "triangles": 1200}, 3)
    s.center = np.array([4.0, -1.0, 2.0], np.float32)
    s.eye = s.eye + s.center
    orbit = scenes.Orbit(s, {"frames_per_turn": 6}, 3)
    for i in range(6):
        c = orbit.camera(i)
        off = c.position - s.center
        np.testing.assert_allclose(np.hypot(off[0], off[2]), orbit.radius,
                                   rtol=1e-6)
        np.testing.assert_allclose(c.forward, -off / np.linalg.norm(off),
                                   rtol=1e-5)
