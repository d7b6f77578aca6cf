"""Plain reference of the flat pipeline (BASELINE config 0): the
geometry stage at the camera, the raster, the vertex colour resolved to
RGBA8 and the depth plane (RASTER_SPEC §1-§4)."""

from __future__ import annotations

from perfbench.reference import common
from perfbench.reference import geometry as geo
from perfbench.reference import raster
from perfbench.reference.precision import F32


def camera_rows(inputs: common.Inputs, cam, prec, normals: bool = False):
    vp = common.camera_view_proj(cam, inputs.width, inputs.height)
    matrix = inputs.per_row(common.draw_matrices(inputs.node_to_world, vp))
    normal_matrix = (inputs.per_row(inputs.normal_matrices()) if normals
                     else None)
    return geo.geometry(inputs.obj, inputs.rows_in, matrix, inputs.width,
                        inputs.height, prec, normal_matrix), vp


def render(inputs: common.Inputs, cam, config: dict, prec):
    """(rgba u8 (H, W, 4), depth f32 (H, W)) of one frame."""
    rows, _ = camera_rows(inputs, cam, prec)
    row, z = raster.winners(rows, inputs.width, inputs.height, prec)
    den, num = raster.latch(rows, row, prec)
    return raster.rgba8(den, num), z


def raster_work(inputs: common.Inputs, cam, config: dict) -> dict:
    """One frame's least raster work: the camera pass, colour and depth
    written once (8 bytes a pixel)."""
    rows, _ = camera_rows(inputs, cam, F32)
    return common.pass_work(rows, inputs.width, inputs.height, 8)
