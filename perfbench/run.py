"""The benchmark of zrenderer_tpu_torch on NVIDIA GPUs.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each compared number beside its limit (also the last lines of
standard error).  Exits non-zero with no result line when CUDA or the
devices the cell asks for are missing, or when the process holds JAX or
the JAX package once the window has closed.  Build and kernel caches stay
in ``build/`` inside the checkout.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up runs from here to the first frame

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "zrenderer_tpu")


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _caches()
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: int(w["chips"]) for w in spec["workloads"]}
    if args.workload not in chips:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = harness.load_cell(ROOT, args.workload)

    t_torch = time.perf_counter()
    import torch

    t_query = time.perf_counter()
    if not torch.cuda.is_available():
        _log("torch.cuda.is_available() is False: the benchmark measures "
             "the CUDA port and does not fall back to the CPU")
        return 3
    if torch.cuda.device_count() < chips[args.workload]:
        _log(f"{args.workload} needs {chips[args.workload]} devices, "
             f"found {torch.cuda.device_count()}")
        return 3
    _log(f"start to torch {t_torch - T_PROCESS:.2f} s, import torch "
         f"{t_query - t_torch:.2f} s, device query "
         f"{time.perf_counter() - t_query:.2f} s")

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T_PROCESS,
                              log=_log)
    found = forbidden_modules()
    if found:
        _log(f"the process holds {found}: the benchmark may load neither "
             "JAX nor the JAX package")
        return 4
    for name, c in result["check"].items():
        _log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
