"""Does a torch.profiler trace keep every kernel record after many kernel
launches made outside any trace?  Needs one CUDA card.

    python -m zrenderer_tpu_torch.tools.profiler_probe

Traces five launches of the K3 kernel on the 20K-triangle lattice at
1080p, then for each count in UNTRACED makes that many small torch
launches outside a trace and traces the five launches again.  Prints, per
trace, the kernel records it holds beside the runtime launch calls it
holds, and the card's name and power limit.  ``chip_smoke.py`` orders its
phases by what this shows.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import torch

UNTRACED = (20_000, 200_000, 1_000_000)  # added up: 1.22M launches
REPS = 5


def _trace(fn):
    """(kernel records, runtime launch calls) of one traced ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X"]
    kernels = sum(e.get("cat") == "kernel" for e in timed)
    calls = sum(e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "") for e in timed)
    return kernels, calls


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import Renderer
    from zrenderer_tpu_torch.ops import geometry as tg
    from zrenderer_tpu_torch.ops import raster
    from zrenderer_tpu_torch.scene.procedural import make_stress_scene

    dev = torch.device("cuda")
    r = Renderer(RenderConfig(width=1920, height=1080), device="cuda")
    r.load_scene(*make_stress_scene(20000))
    b = r._buffers()
    mats = torch.from_numpy(r.camera_matrices()).to(dev)
    ti, tf = tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"],
                                       mats, 1920, 1080)
    prep = raster.prepare_raster_inputs(ti, tf)

    def launches():
        for _ in range(REPS):
            raster.raster_hier_kernel(*prep, 1920, 1088)

    launches()
    torch.cuda.synchronize()
    print(f"untraced launches 0: trace holds {_trace(launches)} (kernel "
          f"records, launch calls) of {REPS} K3 launches", flush=True)
    x = torch.zeros(16, device=dev)
    total = 0
    for n in UNTRACED:
        for _ in range(n):
            x.add_(1)
        torch.cuda.synchronize()
        total += n
        for attempt in (1, 2):
            print(f"untraced launches {total} (trace {attempt}): trace holds "
                  f"{_trace(launches)} (kernel records, launch calls) of "
                  f"{REPS} K3 launches", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
