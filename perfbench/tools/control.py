"""The control of the check: the plain reference computed in TF32 put in
the program's place, against the reference in float32, on frames of the
cell's own orbit at its own size.  The compared numbers it prints for
each seed are the upper readings the limits are set below.

    python3 perfbench/tools/control.py --workload <cell> --seeds 1 2 3 \
        [--precision tf32] [--out out/control.jsonl]

Runs on the device it is given (default ``cuda:0``); needs no program.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def control_numbers(cell, seed: int, device, precision: str = "tf32",
                    frames: int | None = None) -> dict:
    """The numbers of the worst of ``frames`` orbit frames drawn from the
    seed: the reference in ``precision`` against the reference in
    float32."""
    from perfbench import scenes
    from perfbench.harness import reference_module
    from perfbench.reference import common, compare
    from perfbench.reference.precision import PRECISIONS

    arrays = scenes.make_scene(cell.traffic["scene"], seed)
    orbit = scenes.Orbit(arrays, cell.traffic["orbit"], seed)
    ref = reference_module(cell.config["render"]["pipeline"])
    inputs = common.Inputs(arrays, cell.config["render"], device)
    rng = random.Random(seed)
    count = frames or int(cell.traffic["check_frames"])
    per_frame = []
    for _ in range(count):
        cam = orbit.camera(rng.randrange(orbit.frames_per_turn))
        c, d = ref.render(inputs, cam, cell.config, PRECISIONS[precision])
        rc, rd = ref.render(inputs, cam, cell.config, PRECISIONS["f32"])
        per_frame.append(compare.frame_numbers(c, d, rc, rd,
                                               cell.config["check"]))
    return compare.worst(per_frame)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--precision", default="tf32")
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import load_cell

    cell = load_cell(ROOT, args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(cell, seed, args.device, args.precision)
        row = {"workload": args.workload, "seed": seed,
               "precision": args.precision, **numbers,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        out = ROOT / args.out
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
