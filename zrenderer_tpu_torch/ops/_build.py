"""Build and load the CUDA kernels (``zrenderer_tpu_torch/csrc``): the flat
raster kernels K1-K6, the G-buffer kernels K2g, K3g, K4g, K5g, K6g, the
depth-only kernels K2d, K3d, K4d, K6d, the band kernels K3b, K9, K9g,
K9d, the tiled light kernel K7, the overlay kernels K8 (layered raster)
and K8b (atlas composite), and the raster experiments K10g8, K10g8g,
K10g8d (``raster_group8.cu``), K10vec, K10vecg (``raster_vec.cu``),
K10vis, K10trans (``raster_vis.cu``) and K10hbm2, K10scan
(``raster_twoclass.cu``).

``nvcc`` compiles each ``.cu`` file for ``sm_90a`` and links them into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
lands in ``build/zrenderer_tpu_torch/<hash>/`` beside the package, keyed by
a hash of the sources and flags: the first call in a fresh checkout
builds (seconds), later calls and processes reuse the library.  Nothing is
built or loaded at import time.

There is no fallback: without ``nvcc`` or with a failing build,
``load_library`` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "zrenderer_tpu_torch"
SOURCES = ("raster_small.cu", "raster_hier.cu", "raster_binned.cu",
           "light_tiled.cu", "overlay.cu", "raster_group8.cu",
           "raster_vec.cu", "raster_vis.cu", "raster_twoclass.cu")
HEADERS = ("raster_common.cuh", "raster_keyed.cuh")
LIB_NAME = "libzr_raster.so"
TOOLKIT_NVCC = Path("/usr/local/cuda/bin/nvcc")  # when nvcc is not on PATH

# No fast-math: IEEE division, and -fmad=false backs up the explicit
# __fmul_rn/__fadd_rn pinning of every interpolation (RASTER_SPEC §5).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    log: str  # nvcc/ptxas output of this build ("" when reused)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and TOOLKIT_NVCC.exists():
        nvcc = str(TOOLKIT_NVCC)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA raster kernels build only on a host "
            "with the CUDA toolkit"
        )
    return nvcc


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> BuildInfo:
    """Build the library unless this source hash was built already."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return BuildInfo(lib, 0.0, "")
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    logs = []
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = []
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for name, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp_lib, lib)  # atomic: readers see a whole library
    return BuildInfo(lib, time.perf_counter() - t0, "\n".join(logs))


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    lib = ctypes.CDLL(str(build_library().path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zr_raster_small.argtypes = [p, p, i, p, i, p, p, p, p, p, i, i, p]
    lib.zr_raster_small.restype = i
    lib.zr_raster_hier.argtypes = [p, i, p, p, p, i, p, p, p, p, i, i, p]
    lib.zr_raster_hier.restype = i
    lib.zr_raster_hier_keyed.argtypes = [p, i, p, p, p, i, p, p, p, p, i, i,
                                         p]
    lib.zr_raster_hier_keyed.restype = i
    lib.zr_raster_records.argtypes = [p, p, p, p, p, p, p, i, p, p, p, i, i, i,
                                      p, p, p, i, i, p]
    lib.zr_raster_records.restype = i
    lib.zr_raster_records_keyed.argtypes = [p, p, p, p, i, p, p, p, i, i, i, p,
                                            p, p, i, i, p]
    lib.zr_raster_records_keyed.restype = i
    lib.zr_keyed_smem_bytes.argtypes = []
    lib.zr_keyed_smem_bytes.restype = i
    lib.zr_keyed_hier_smem_bytes.argtypes = []
    lib.zr_keyed_hier_smem_bytes.restype = i
    lib.zr_raster_lists.argtypes = [p, p, p, i, p, p, p, i, i, i, p, p, p, i,
                                    i, p]
    lib.zr_raster_lists.restype = i
    lib.zr_gbuffer_small.argtypes = [p, p, i, p, i, p, p, p, p, i, i, p]
    lib.zr_gbuffer_small.restype = i
    lib.zr_gbuffer_hier.argtypes = [p, i, p, p, p, i, p, p, p, i, i, p]
    lib.zr_gbuffer_hier.restype = i
    lib.zr_gbuffer_hbm.argtypes = [p, i, p, p, p, i, p, p, p, i, i, p]
    lib.zr_gbuffer_hbm.restype = i
    lib.zr_gbuffer_records_keyed.argtypes = [p, p, p, p, i, p, p, p, i, i, i,
                                             p, p, i, i, p]
    lib.zr_gbuffer_records_keyed.restype = i
    lib.zr_gbuffer_lists.argtypes = [p, p, p, i, p, p, p, i, i, i, p, p, i, i,
                                     p]
    lib.zr_gbuffer_lists.restype = i
    lib.zr_depth_small.argtypes = [p, p, i, p, i, p, p, p, p, i, i, p]
    lib.zr_depth_small.restype = i
    lib.zr_small_blocks_per_tile.argtypes = []
    lib.zr_small_blocks_per_tile.restype = i
    lib.zr_raster_small_blocks.argtypes = [i, p, p, i, p, i, p, p, p, p, p,
                                           i, i, p]
    lib.zr_raster_small_blocks.restype = i
    lib.zr_depth_small_blocks.argtypes = [i, p, p, i, p, i, p, p, p, p, i, i,
                                          p]
    lib.zr_depth_small_blocks.restype = i
    lib.zr_depth_hier.argtypes = [p, i, p, p, p, i, p, p, p, i, i, p]
    lib.zr_depth_hier.restype = i
    lib.zr_depth_records_keyed.argtypes = [p, p, p, p, i, p, p, p, i, i, i, p,
                                           p, i, i, p]
    lib.zr_depth_records_keyed.restype = i
    lib.zr_depth_lists.argtypes = [p, p, p, i, p, p, p, i, i, i, p, p, i, i, p]
    lib.zr_depth_lists.restype = i
    lib.zr_raster_hier_band_keyed.argtypes = [p, i, p, p, p, i, p, p, p, p,
                                              i, i, i, p]
    lib.zr_raster_hier_band_keyed.restype = i
    lib.zr_raster_records_band.argtypes = [p, p, p, p, i, p, p, p, i, i, i, p,
                                           p, p, i, i, i, i, p]
    lib.zr_raster_records_band.restype = i
    lib.zr_gbuffer_records_band.argtypes = [p, p, p, p, i, p, p, p, p, i, i,
                                            i, p]
    lib.zr_gbuffer_records_band.restype = i
    lib.zr_raster_records_dist.argtypes = [p, p, p, p, i, p, p, p, i, i, i, p,
                                           p, p, i, i, i, i, p]
    lib.zr_raster_records_dist.restype = i
    lib.zr_light_tiled.argtypes = [p, i, p, p, p, i, p, i, p, i, i, p]
    lib.zr_light_tiled.restype = i
    lib.zr_overlay_raster.argtypes = [p, p, i, i, p, p, p, p, p, i, i, p]
    lib.zr_overlay_raster.restype = i
    lib.zr_overlay_composite.argtypes = [p, p, p, p, p, i, p, i, i, p, i, i,
                                         p]
    lib.zr_overlay_composite.restype = i
    lib.zr_raster_group8.argtypes = [p, p, p, i, p, i, p, p, p, i, p, p, p,
                                     p, i, i, p]
    lib.zr_raster_group8.restype = i
    lib.zr_gbuffer_group8.argtypes = [p, p, p, i, p, i, p, p, p, i, p, p, p,
                                      i, i, p]
    lib.zr_gbuffer_group8.restype = i
    lib.zr_depth_group8.argtypes = [p, p, p, i, p, i, p, p, p, i, p, p, p,
                                    i, i, p]
    lib.zr_depth_group8.restype = i
    lib.zr_raster_vec.argtypes = [p, i, p, p, i, p, p, p, p, i, i, p]
    lib.zr_raster_vec.restype = i
    lib.zr_gbuffer_vec.argtypes = [p, i, p, p, i, p, p, p, i, i, p]
    lib.zr_gbuffer_vec.restype = i
    lib.zr_raster_vis.argtypes = [p, i, p, i, p, p, i, i, p, p, p, p, i, i,
                                  p]
    lib.zr_raster_vis.restype = i
    lib.zr_raster_trans.argtypes = [p, i, p, p, p, i, p, p, p, p, i, i, p]
    lib.zr_raster_trans.restype = i
    lib.zr_raster_hbm2.argtypes = [p, i, p, p, p, i, p, p, p, i, p, p, p, p,
                                   i, i, p]
    lib.zr_raster_hbm2.restype = i
    lib.zr_raster_scan.argtypes = [p, i, p, p, p, i, p, p, p, i, p, p, p, p,
                                   i, i, p]
    lib.zr_raster_scan.restype = i
    lib.zr_error_string.argtypes = [i]
    lib.zr_error_string.restype = ctypes.c_char_p
    return lib
