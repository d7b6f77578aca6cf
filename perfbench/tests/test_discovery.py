"""BENCHMARK.json names every configuration, traffic mix, limit file,
reference and per-layer reader the harness loads, and each is found by
its name alone."""

import json
import re

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "perfbench/run.py"]
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in moves for m in SPEC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    from perfbench import harness

    c = harness.load_cell(ROOT, cell)
    assert c.config["render"]["width"] > 0
    from perfbench import scenes

    assert callable(scenes.module(c.traffic["scene"]["kind"]).build)
    from perfbench.reference.compare import NUMBERS

    assert c.limits and set(c.limits) <= set(NUMBERS)
    harness.reference_module(c.config["render"]["pipeline"])
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    assert [m["name"] for m in c.per_layer] == [
        m["name"] for m in SPEC["per_layer"] if m["moves"] in e2e
        and cell in m.get("workloads", [cell])]
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)


def test_config_files_are_distinct_and_under_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(SPEC["paths"][0] + "/")
        assert (ROOT / f).is_file()


def test_unknown_cell_is_refused():
    from perfbench import harness

    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "no.such.cell")


def test_port_kernels_read_from_sources():
    from perfbench import harness

    every, rast = harness.port_kernels(ROOT / "zrenderer_tpu_torch")
    assert "raster_records_kernel" in rast
    assert "light_tiled_kernel" in every - rast
    assert harness.kernel_id(
        "void raster_records_kernel<true>(RecordLists, int)") \
        == "raster_records_kernel"


def test_grouped_metric_reads_its_quantity():
    from perfbench import harness

    plain = harness.metric_reader("raster.kernel_ms")
    grouped = harness.metric_reader("raster.kernel_ms.device_paced")
    assert grouped.__file__ == plain.__file__
    ctx = {"raster_kernels": {"k"}, "frames": 2,
           "device_events": [("k", 0.0, 500.0), ("j", 0.0, 9.0)]}
    assert grouped.read(ctx) == plain.read(ctx) == 0.25
