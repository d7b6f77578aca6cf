"""Run cells of the benchmark several times, one process a run, as the
benchmark's checks do, and summarise each metric's median and spread
(the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)``, as a share of the median).

    python3 perfbench/tools/sets.py --workload <cell> --seeds 1 2 3 \
        --seconds 51 [--trace 0|1] [--out out/sets.jsonl]

Each run's result line, exit code, seconds and the end of its standard
error go to ``--out``, one JSON object a line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values) -> tuple:
    """(median, (q3 - q1) / median)."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "result": result, "stderr": proc.stderr[-3000:]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True, nargs="+")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=20)
    parser.add_argument("--trace", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    for workload in args.workload:
        runs = []
        for seed in args.seeds:
            run = run_once(workload, seed, args.seconds, args.trace)
            runs.append(run)
            res = run["result"] or {}
            brief = {k: v["value"] for k, v in res.get("metrics", {}).items()}
            check = {k: v["value"] for k, v in res.get("check", {}).items()}
            print(json.dumps({"workload": workload, "seed": seed,
                              "rc": run["rc"], "s": round(run["seconds"], 1),
                              "correct": res.get("correct"),
                              "frames": res.get("attempted"),
                              "metrics": brief, "check": check}),
                  flush=True)
            if run["rc"] != 0:
                print(run["stderr"][-1500:], flush=True)
            if args.out:
                (ROOT / args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(ROOT / args.out, "a") as f:
                    f.write(json.dumps(run) + "\n")
        names = sorted({k for r in runs if r["result"]
                        for k in r["result"]["metrics"]})
        for name in names:
            vals = [r["result"]["metrics"][name]["value"] for r in runs
                    if r["result"] and name in r["result"]["metrics"]]
            med, spr = spread(vals)
            print(f"{workload} {name}: median {med!r} spread {spr:.4%} "
                  f"over {len(vals)} runs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
