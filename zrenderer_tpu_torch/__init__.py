"""zrenderer-tpu on PyTorch: the flat frame path with hand-written CUDA
raster kernels for Hopper (sm_90a).

A second package beside ``zrenderer_tpu`` (the JAX/Pallas reference) that
mirrors its layout: ``engine/`` (scene upload, config, pools, stats, the
staging ring, the Renderer), ``ops/`` (column geometry, raster prepares,
dispatch and kernel wrappers), ``csrc/`` (the CUDA sources), ``app/``, and
the host modules it needs from the reference, copied so that it runs
without it: ``scene/`` (loaders, procedural scenes), ``math/zmath.py``,
``utils/png.py`` and ``raster_ref/raster_cpu.py`` (the NumPy oracle).
It imports ``torch`` and never ``jax`` or ``zrenderer_tpu``; only the tests
import both packages, to hold one against the other.
"""

__version__ = "0.1.0"
