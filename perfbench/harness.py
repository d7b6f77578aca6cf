"""One run of one cell: set-up, the timed interactive loop, the traced
stretch, the check against the plain reference, the result line.

The cell, its configuration, its traffic mix and its per-layer metrics
are found by the names in ``BENCHMARK.json``:

* ``configs[].file``: the configuration (``render``: the RenderConfig
  fields; ``environment``: ``set_environment``'s light, or absent;
  ``check``: the comparison's tolerances); its ``render.pipeline`` names
  the plain reference ``perfbench/reference/<pipeline>.py``;
* ``perfbench/traffic/<traffic>.json``: the scene, the orbit and the frame
  counts; its ``scene.kind`` names the scene builder
  ``perfbench/scenes/<kind>.py`` (``perfbench/scenes/__init__.py``);
* ``perfbench/limits/<cell>.json``: the limit of each compared number;
* ``perfbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float | None``.

A metric named ``<quantity>.<group>`` (``fps.device_paced``) reports the
quantity in the cells that the group's bound suits: without a reader of
its own it is read as the quantity is.

The system under test is ``zrenderer_tpu_torch`` alone; the reference
imports nothing of it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import re
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from perfbench import scenes

BENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and everything it
    names; ``KeyError`` for a cell the file does not define."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    end_to_end = [m for m in spec["end_to_end"] if here(m)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if here(m) and m["moves"] in moved]
    return Cell(name, config, traffic, limits, end_to_end, per_layer)


def load_module(path: Path):
    """Import a file of the benchmark by its path (metric names hold
    dots)."""
    mod_name = "perfbench_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The reader ``perfbench/metrics/<name>.py``; for a metric
    ``<quantity>.<group>`` without a file of its own, the quantity's."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    return load_module(path)


def reference_module(pipeline: str):
    return load_module(BENCH / "reference" / f"{pipeline}.py")


# -- the program's kernels, by name -------------------------------------------

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:@[^\n]*\n)*def\s+(\w+)")


def port_kernels(package_dir: Path):
    """(every kernel of the port, its raster kernels): the ``__global__``
    functions of ``csrc/*.cu`` (raster: ``csrc/raster_*.cu``) and the
    ``@triton.jit`` functions of the package, read now, so that a kernel a
    later change adds is counted without an edit here."""
    every, rast = set(), set()
    for cu in sorted((package_dir / "csrc").glob("*.cu")):
        names = set(_GLOBAL.findall(cu.read_text()))
        every |= names
        if cu.name.startswith("raster_"):
            rast |= names
    for py in package_dir.rglob("*.py"):
        text = py.read_text(errors="replace")
        if "triton" in text:
            names = set(_TRITON.findall(text))
            every |= names
            rast |= names
    return every, rast


def kernel_id(trace_name: str) -> str:
    """The function name of a device event of the trace: the identifier
    before its template or argument list, namespaces dropped."""
    name = trace_name.strip()
    if name.startswith("void "):
        name = name[5:]
    name = re.split(r"[(<]", name, maxsplit=1)[0]
    return name.split("::")[-1].strip()


# -- the traced stretch --------------------------------------------------------

def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def read_trace(path: str) -> dict:
    """Device events (name, start us, duration us), the host's spans
    (ztracy zones and the harness's), the busy time and the window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    device = [(e["name"], float(e["ts"]), float(e["dur"]))
              for e in timed
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = [(e["name"], float(e["ts"]), float(e["dur"]))
             for e in timed if e.get("cat") == "user_annotation"]
    starts = [ts for name, ts, _ in spans if name == "render"]
    t0 = min(starts) if starts else min(float(e["ts"]) for e in timed)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    return {"device": device, "spans": spans, "t0": t0, "t1": t1,
            "busy_us": _union_us([(ts, d) for _, ts, d in device]),
            "window_us": t1 - t0}


def idle_gaps(trace: dict, top: int = 10):
    """The longest stretches with no device operation, each labelled by
    the innermost host span open at its start."""
    merged = []
    for _, ts, dur in sorted(trace["device"], key=lambda e: e[1]):
        if merged and ts <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ts + dur)
        else:
            merged.append([ts, ts + dur])
    gaps = []
    prev = trace["t0"]
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inside = [(dur, name) for name, ts, dur in trace["spans"]
                  if ts <= a < ts + dur]
        out.append([min(inside)[1] if inside else "harness", (b - a) * 1e-6])
    return out


def top_device_ops(trace: dict, top: int = 10):
    by_name = {}
    for name, _, dur in trace["device"]:
        key = kernel_id(name) or name
        by_name[key] = by_name.get(key, 0.0) + dur
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[name[:120], us * 1e-6] for name, us in ranked]


# -- the run -------------------------------------------------------------------

@dataclass
class Sample:
    """The frames of the window that the reference recomputes, kept as
    the loop produced them: one drawn from the seed in each of ``k - 1``
    equal stretches of the window's ``seconds`` (by the time the frame is
    enqueued), and the window's last frame, the one still in flight when
    the window closes.  A drawn frame is copied on the frame's stream: the
    program's outputs may be views of larger buffers, which a held
    reference would keep alive and count in the program's memory."""

    k: int
    seconds: float
    rng: random.Random
    picks: dict = field(default_factory=dict)
    seen: dict = field(default_factory=dict)
    last: tuple | None = None

    def offer(self, index: int, t: float, color, depth):
        stretch = min(int(t / self.seconds * (self.k - 1)), self.k - 2)
        self.seen[stretch] = self.seen.get(stretch, 0) + 1
        if self.rng.randrange(self.seen[stretch]) == 0:
            self.picks[stretch] = (index, color.clone(), depth.clone())
        self.last = (index, color, depth)

    def frames(self) -> list:
        out = [self.picks[s] for s in sorted(self.picks)]
        if self.last is not None and self.last[0] != out[-1][0]:
            out.append(self.last)
        return out


def _port_scene(arrays: scenes.SceneArrays, cam0):
    """The port's ``Scene`` and ``MeshData``: a mesh and a node a draw."""
    from zrenderer_tpu_torch.scene.mesh import MeshData
    from zrenderer_tpu_torch.scene.scene import Node, Scene

    mesh_data = MeshData()
    scene = Scene()
    for k, draw in enumerate(arrays.draws):
        mesh_data.append_mesh(draw.vertices, draw.indices)
        scene.nodes.append(Node(mesh_indices=[k], transform_index=k,
                                name=f"draw{k}"))
        scene.transforms.append(np.asarray(draw.transform, np.float32))
    scene.cameras.append(cam0)
    return scene, mesh_data


def _port_camera(cam: scenes.OrbitCamera):
    from zrenderer_tpu_torch.scene.scene import Camera

    return Camera(position=cam.position, forward=cam.forward, yfov=cam.yfov,
                  znear=cam.znear, zfar=cam.zfar, name="orbit")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, log=print) -> dict:
    """Run one cell on ``device``; returns the result line's object.
    ``t_process``: the process start on ``time.perf_counter``'s clock."""
    import torch

    import zrenderer_tpu_torch
    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import Renderer
    from zrenderer_tpu_torch.profiling import ztracy

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    phases = [("imports", time.perf_counter())]
    if cuda:
        from zrenderer_tpu_torch.ops import _build
        build = _build.build_library()
        _build.load_library()
        torch.cuda.init()
        if build.seconds:
            log(f"built the kernel library in {build.seconds:.1f} s")
    phases.append(("library and CUDA", time.perf_counter()))

    traffic = cell.traffic
    arrays = scenes.make_scene(traffic["scene"], seed)
    orbit = scenes.Orbit(arrays, traffic["orbit"], seed)
    turn = orbit.frames_per_turn
    cams = [_port_camera(orbit.camera(i)) for i in range(turn)]
    scene, mesh_data = _port_scene(arrays, cams[0])
    phases.append(("scene", time.perf_counter()))
    renderer = Renderer(RenderConfig(**cell.config["render"]), device=dev)
    renderer.load_scene(scene, mesh_data)
    if cell.config.get("environment") is not None:
        renderer.set_environment(**cell.config["environment"])
    prepare = getattr(scenes.module(traffic["scene"]["kind"]), "prepare",
                      None)
    if prepare is not None:
        prepare(renderer, arrays)
    phases.append(("load_scene", time.perf_counter()))
    warm = int(traffic["warmup_frames"])
    for k in range(warm):
        renderer.render(camera=cams[(k * turn) // warm])
        renderer.present()
    renderer.finish_gpu_commands()
    phases.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{name} {t - prev:.2f} s" for (name, t), (_, prev)
        in zip(phases, [("start", t_process)] + phases)))
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the window: the app's per-frame loop, closed by a drain; at least
    # as many frames as the check keeps (thousands run on a card).
    sample = Sample(int(traffic["check_frames"]), seconds,
                    random.Random(seed))
    enqueue_s = []
    marks = []
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    n = 0
    while True:
        t0 = time.perf_counter()
        color, depth = renderer.render(camera=cams[n % turn])
        t1 = time.perf_counter()
        renderer.present()
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        sample.offer(n, t0 - t_start, color, depth)
        enqueue_s.append(t1 - t0)
        n += 1
        if time.perf_counter() - t_start >= seconds and n >= sample.k:
            break
    renderer.finish_gpu_commands()
    t_end = time.perf_counter()
    frames = n
    fps = frames / (t_end - t_start)
    if cuda:
        stamps = [start] + marks
        intervals = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
        window_peak = torch.cuda.max_memory_allocated(dev)
    else:
        stamps = [t_start] + marks
        intervals = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        window_peak = 0

    result_metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))
                   if cuda else 0}

    ref = reference_module(cell.config["render"]["pipeline"])
    if trace:
        profile_frames = int(traffic["profile_frames"])
        with tempfile.TemporaryDirectory() as tmp:
            with ztracy.trace(tmp) as capture:
                for k in range(profile_frames):
                    with torch.profiler.record_function("harness.camera"):
                        cam = cams[(n + k) % turn]
                    color, depth = renderer.render(camera=cam)
                    renderer.present()
                renderer.finish_gpu_commands()
            tr = read_trace(capture.path)
        every, rast = port_kernels(Path(zrenderer_tpu_torch.__file__).parent)
        device_info["busy_s"] = tr["busy_us"] * 1e-6
        device_info["window_s"] = tr["window_us"] * 1e-6
        breakdown = {"device_ops": top_device_ops(tr),
                     "idle_gaps": idle_gaps(tr)}
        ctx = {"frames": profile_frames, "trace": tr,
               "device_events": [(kernel_id(nm), ts, d)
                                 for nm, ts, d in tr["device"]],
               "port_kernels": every, "raster_kernels": rast,
               "enqueue_ms": [s * 1e3 for s in enqueue_s],
               "fps_unprofiled": fps, "window_peak_bytes": window_peak,
               "device_kind": device_info["kind"],
               "raster_work": None, "peaks": json.loads(
                   (BENCH / "peaks.json").read_text())}
        work_cams = [(n + k) % turn for k in (0, profile_frames - 1)]
    frames_checked = [(i, c.cpu(), d.cpu()) for i, c, d in sample.frames()]

    # -- free the program's state, then the plain reference.
    del renderer, color, depth, sample, scene, mesh_data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from perfbench.reference import common
    from perfbench.reference import compare
    from perfbench.reference.precision import F32

    inputs = common.Inputs(arrays, cell.config["render"], dev)
    t_ref = time.perf_counter()
    per_frame = []
    for i, c, d in frames_checked:
        rc, rd = ref.render(inputs, orbit.camera(i), cell.config, F32)
        per_frame.append(compare.frame_numbers(c, d, rc.cpu(), rd.cpu(),
                                               cell.config["check"]))
        del rc, rd
    numbers = compare.worst(per_frame)
    correct = compare.judge(numbers, cell.limits)
    log(f"reference: {len(frames_checked)} frames in "
        f"{time.perf_counter() - t_ref:.1f} s")

    if trace:
        works = [ref.raster_work(inputs, orbit.camera(i), cell.config)
                 for i in work_cams]
        ctx["raster_work"] = {k: sum(w[k] for w in works) / len(works)
                              for k in works[0]}
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"fps": fps, "frame_ms_p95": float(np.percentile(intervals, 95.0)),
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            name = m["name"]
            value = values.get(name, values.get(name.rsplit(".", 1)[0]))
            result_metrics[name] = {"value": value, "unit": m["unit"]}

    out = {"correct": bool(correct), "attempted": frames,
           "failed": sum(not compare.judge(f, cell.limits) for f in per_frame),
           "metrics": result_metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = {k: {"value": numbers[k], "limit": limit}
                    for k, limit in cell.limits.items()}
    return out
