"""The check catches a broken timed path.  A whole run of a cell, on the
CPU at a small size with the program's plain raster versions, skipping
only the harness's look for a card, comes out ``correct`` when the
program is sound and not ``correct`` under each fault a frame loop can
have: a frame that returns the state unchanged (the first frame again),
half of the triangles left out, a 128x128 block of the frame altered
where the frame is produced, the same block in every second frame only.
(One chip: no exchange between chips to leave out.)  The limits are the
cell's, scaled to the frame's area."""

import time

import pytest

from perfbench import harness

CELLS = ["flat.lattice1m.orbit", "shadowed.lattice1m.orbit",
         "flat.soup1m.orbit"]


def _run(cell, seed=2024):
    return harness.run_cell(cell, seed, 1.5, False, "cpu",
                            time.perf_counter(), log=lambda m: None)


def _stale_frames(monkeypatch):
    from zrenderer_tpu_torch.engine.renderer import Renderer

    real = Renderer.render
    first = {}

    def render(self, *a, **k):
        out = real(self, *a, **k)
        return first.setdefault(id(self), out)

    monkeypatch.setattr(Renderer, "render", render)


def _half_the_triangles(monkeypatch):
    from zrenderer_tpu_torch.ops import geometry

    real = geometry.geometry_pipeline_cols

    def cols(ccols, *a, **k):
        ccols = ccols.clone()
        ccols[16:32, 1::2] = ccols[0:16, 1::2]  # odd triangles degenerate
        ccols[32:48, 1::2] = ccols[0:16, 1::2]
        return real(ccols, *a, **k)

    monkeypatch.setattr(geometry, "geometry_pipeline_cols", cols)


def _altered_block(monkeypatch):
    from zrenderer_tpu_torch.engine.renderer import Renderer

    real = Renderer.render

    def render(self, *a, **k):
        color, depth = real(self, *a, **k)
        color = color.clone()
        color[:128, :128, 0] += 8
        return color, depth

    monkeypatch.setattr(Renderer, "render", render)


def _every_other_frame(monkeypatch):
    """A block altered in every second frame, as a race between frames in
    flight would leave some frames and not others."""
    from zrenderer_tpu_torch.engine.renderer import Renderer

    real = Renderer.render
    calls = {}

    def render(self, *a, **k):
        color, depth = real(self, *a, **k)
        calls[id(self)] = calls.get(id(self), 0) + 1
        if calls[id(self)] % 2:
            return color, depth
        color = color.clone()
        color[:128, :128, 1] += 8
        return color, depth

    monkeypatch.setattr(Renderer, "render", render)


FAULTS = {"stale_frame": _stale_frames,
          "half_the_triangles": _half_the_triangles,
          "altered_block": _altered_block,
          "every_other_frame": _every_other_frame}


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name, small_cell):
    out = _run(small_cell(name, frames_per_turn=24))
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, small_cell, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(small_cell(name, frames_per_turn=24))
    assert not out["correct"], out["check"]
