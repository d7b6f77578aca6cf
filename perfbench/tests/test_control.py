"""The control of the check fails it: the plain reference computed in
TF32 (the step below the float32 the configurations state) put in the
program's place reads above every limit's lower reading on one number or
more.  At a size the CPU holds here; at each cell's own size on a card
(``chip``), where its readings set the limits' upper ends
(``perfbench/tools/control.py`` prints them)."""

import json
from pathlib import Path

import pytest

from perfbench.reference.compare import judge
from perfbench.tools.control import control_numbers

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_small(name, small_cell):
    cell = small_cell(name, width=320, height=180, triangles=3000)
    for seed in (1, 2):
        tf32 = control_numbers(cell, seed, "cpu", "tf32")
        f32 = control_numbers(cell, seed, "cpu", "f32")
        assert all(v == 0 for v in f32.values())
        assert not judge(tf32, cell.limits)


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(name, cuda_device):
    from perfbench.harness import load_cell

    cell = load_cell(ROOT, name)
    for seed in (101, 202, 303):
        assert not judge(control_numbers(cell, seed, cuda_device, "tf32"),
                         cell.limits)
