"""Tests of the benchmark harness.  ``python -m pytest perfbench/tests``
runs them on the CPU; tests marked ``chip`` need a CUDA card and skip
without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return "cuda:0"


def _small_cell(name: str, width: int = 160, height: int = 96,
                triangles: int = 600, frames_per_turn: int = 360):
    from perfbench.harness import load_cell

    cell = load_cell(ROOT, name)
    full = cell.config["render"]["width"] * cell.config["render"]["height"]
    # The limits count pixels of the cell's frames: scaled to the area.
    cell.limits = {k: int(v * width * height / full)
                   for k, v in cell.limits.items()}
    cell.config["render"].update(width=width, height=height)
    if "shadow_size" in cell.config["render"]:
        cell.config["render"]["shadow_size"] = 128
    cell.traffic["scene"]["triangles"] = triangles
    cell.traffic["orbit"]["frames_per_turn"] = frames_per_turn
    cell.traffic["warmup_frames"] = 2
    cell.traffic["profile_frames"] = 2
    return cell


@pytest.fixture
def small_cell():
    """``small_cell(name, ...)``: the cell ``name`` of BENCHMARK.json at a
    size a CPU test holds."""
    return _small_cell
