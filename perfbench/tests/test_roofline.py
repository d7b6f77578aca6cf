"""The raster roofline's count on a hand-counted scene: two triangles
of a 16x8 frame, one covering pixel centres row by row, one culled."""

import numpy as np
import torch

from perfbench.reference import common
from perfbench.reference import geometry as geo
from perfbench.reference.precision import F32


def _rows(corners_ndc, width=16, height=8):
    """Set-up rows of triangles given in NDC (z 0.5, w 1) through the
    identity matrix."""
    t = len(corners_ndc)
    obj = torch.zeros((3, geo.CHANNELS, t), dtype=torch.float32)
    for k, tri in enumerate(corners_ndc):
        for c, (x, y) in enumerate(tri):
            obj[c, 0:4, k] = torch.tensor([x, y, 0.5, 1.0])
    return geo.geometry(obj, t, torch.eye(4)[:, :, None], width, height, F32)


def test_half_frame_triangle_and_a_back_face():
    # Pixel (i, j) has its centre at NDC x = (j + 0.5) / 8 - 1,
    # y = 1 - (i + 0.5) / 4.  The first triangle is the lower-left half of
    # the frame, corners at NDC (-1, 1), (-1, -1), (1, -1), clockwise on
    # screen (front facing): centre (j + 0.5, i + 0.5) is inside iff
    # (j + 0.5) / 16 < (i + 0.5) / 8, that is j < 2 i + 0.5, so row i
    # holds 2 i + 1 pixels (the top-left rule decides no centre here):
    # 1 + 3 + 5 + ... + 15 = 64.  The second winds the other way: culled.
    rows = _rows([[(-1, 1), (-1, -1), (1, -1)],
                  [(-1, 1), (1, -1), (-1, -1)]])
    assert rows.alive[:2].tolist() == [True, False]  # then 12 fan rows
    assert not rows.alive[2:].any()
    work = common.pass_work(rows, 16, 8, 8)
    assert work["visible"] == 1
    assert work["pairs"] == 64
    assert work["ops"] == 64 * common.OPS_PER_PAIR
    assert work["bytes"] == 3 * 16 + 16 * 8 * 8


def test_roofline_reader_takes_the_larger_term():
    from perfbench import harness

    reader = harness.load_module(
        harness.BENCH / "metrics" / "raster_roofline.py")
    ctx = {"peaks": {"card": {"bytes_per_s": 1e9, "ops_per_s": 1e9}},
           "device_kind": "card", "raster_kernels": {"k"}, "frames": 2,
           "raster_work": {"bytes": 1e6, "ops": 3e6},
           "device_events": [("k", 0.0, 3000.0), ("k", 5000.0, 3000.0),
                             ("other", 9000.0, 1e6)]}
    # kernel 3 ms a frame; least time max(1 ms, 3 ms) = 3 ms: 100%.
    assert np.isclose(reader.read(ctx), 100.0)
    ctx["raster_work"] = {"bytes": 1.5e6, "ops": 0.0}
    assert np.isclose(reader.read(ctx), 50.0)
    ctx["device_kind"] = "unknown card"
    assert reader.read(ctx) is None
