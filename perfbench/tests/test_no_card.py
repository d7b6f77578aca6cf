"""Without a card the benchmark fails and prints no result: it never
falls back to the CPU.  Without the program beside it, it fails too."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "flat.lattice1m.orbit", "--seed", "3000000019",
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_unknown_workload_fails():
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "no.such.cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
