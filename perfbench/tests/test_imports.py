"""Nothing the benchmark loads brings in JAX or the JAX package, and the
plain reference loads nothing of the program under test.  Top-level
module names are compared whole: ``zrenderer_tpu_torch`` begins with
``zrenderer_tpu`` and is not it."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_level_modules(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=str(ROOT), body=body)],
        capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = _top_level_modules(
        "import perfbench.harness, perfbench.run\n"
        "from perfbench import harness\n"
        "for m in harness.load_cell(harness.BENCH.parent,"
        " 'flat.lattice1m.orbit').per_layer:\n"
        "    harness.metric_reader(m['name'])\n"
        "import zrenderer_tpu_torch.engine.renderer\n"
        "import zrenderer_tpu_torch.profiling.ztracy\n"
        "import perfbench.tools.control, perfbench.tools.sets\n")
    assert not mods & {"jax", "jaxlib", "flax", "zrenderer_tpu"}
    assert "zrenderer_tpu_torch" in mods  # the prefix is not the JAX package


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(
        "import numpy as np\n"
        "from perfbench import scenes\n"
        "from perfbench.reference import common, compare, flat, shadowed\n"
        "from perfbench.reference.precision import F32\n"
        "a = scenes.make_scene({'kind': 'lattice', 'triangles': 120}, 5)\n"
        "cfg = {'render': {'width': 64, 'height': 32, 'shadow_size': 128},\n"
        "       'environment': {'light_dir': [-0.5, -1.0, -0.35]}}\n"
        "inp = common.Inputs(a, cfg['render'], 'cpu')\n"
        "cam = scenes.Orbit(a, {'frames_per_turn': 8}, 5).camera(3)\n"
        "flat.render(inp, cam, cfg, F32)\n"
        "shadowed.render(inp, cam, cfg, F32)\n"
        "flat.raster_work(inp, cam, cfg)\n")
    assert not mods & {"jax", "jaxlib", "flax", "zrenderer_tpu",
                       "zrenderer_tpu_torch"}


def test_forbidden_names_compare_whole_top_level_names():
    sys.path.insert(0, str(ROOT))
    from perfbench import run

    saved = dict(sys.modules)
    try:
        sys.modules.pop("jax", None)
        sys.modules["zrenderer_tpu_torch_probe"] = sys
        assert "zrenderer_tpu" not in run.forbidden_modules()
        sys.modules["zrenderer_tpu.engine"] = sys
        assert run.forbidden_modules() == ["zrenderer_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
