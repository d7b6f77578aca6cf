"""Plain K3b, K9 (both span forms), K9g and K9d
(zrenderer_tpu_torch/ops/raster.py) against the reference's band kernels
in interpret mode (``rasterize_setup_pallas_band``,
``rasterize_setup_pallas_binned_band``,
``rasterize_gbuffer_pallas_binned_band``,
``rasterize_setup_pallas_binned_band_dist``), called outside shard_map
with both bands of a 128x64 frame and the same gathered setup rows (two
triangle shards).

Kept apart from test_torch_bands.py so the interpret runs land on their
own test worker.  Contract, as test_torch_binned_interpret.py's
(docs/RASTER_SPEC.md §5): coverage exact, u8 within 1 LSB, depth within
2e-6 (XLA:CPU contracts the interpret kernels' f32 chains; eager torch
does not); the G-buffer's constant planes exact, its interpolated planes
within 2e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bands import _indexed_args, _t
from test_torch_raster import _u8
from zrenderer_tpu.ops import raster_pallas as rp
from zrenderer_tpu_torch.engine.upload import flatten_scene
from zrenderer_tpu_torch.ops import geometry as tg
from zrenderer_tpu_torch.ops import raster as tr
from zrenderer_tpu_torch.parallel import tiles
from zrenderer_tpu_torch.scene.procedural import make_triangle_soup

torch.set_num_threads(1)

W, H, N = 128, 64, 2
BAND_H = H // N


def _gathered(materials: bool = False):
    """Two shards of a 256-triangle soup with near-plane crossings (fan
    rows), gathered in canonical order; with ``materials`` a random
    per-triangle table and normal matrices."""
    scene, md = make_triangle_soup(256, seed=7, extent=2.0,
                                   behind_camera_fraction=0.1)
    v = md.vertex_data.reshape(-1, 16)
    for t in range(40, 60):
        v[3 * t, 2] += 15.0
    flat = flatten_scene(scene, md, pad=True, tri_align=64)
    vp = tg.view_proj_from_camera(scene.active_camera, W, H)
    mats = np.einsum("nij,jk->nik", flat.node_to_world, vp).astype(np.float32)
    kw = {}
    if materials:
        rng = np.random.default_rng(2)
        kw = dict(material_table=_t(rng.random(
            (len(flat.tri_vidx), tg.MATERIAL_COLS), dtype=np.float32)),
            normal_matrices=_t(rng.standard_normal(
                (len(mats), 3, 3)).astype(np.float32)))
    locals_, ti, tf, s = tiles.setups_in_turn(
        N, *map(_t, _indexed_args(flat, mats)), W, H, **kw)
    return locals_, ti, tf, s


def _jit(fn, **static):
    """``fn`` compiled once for both bands: ``row0`` a traced scalar, as
    inside shard_map."""
    return jax.jit(lambda *a, row0: fn(*a, row0=row0, interpret=True,
                                       **static))


def _close(color, depth, ref_c, ref_d):
    ref_c, ref_d = np.asarray(ref_c), np.asarray(ref_d)
    assert color.shape == ref_c.shape == (BAND_H, W)
    np.testing.assert_array_equal(depth < 1.0, ref_d < 1.0)
    np.testing.assert_allclose(depth, ref_d, rtol=0, atol=2e-6)
    assert np.abs(_u8(color).astype(np.int32)
                  - _u8(ref_c.view(np.int32)).astype(np.int32)).max() <= 1


@pytest.mark.parametrize("kind", ["k3b", "k9", "k9_global"])
def test_plain_band_kernels_match_pallas_interpret(kind):
    _, ti, tf, s = _gathered()
    jti, jtf = jnp.asarray(ti.numpy()), jnp.asarray(tf.numpy())
    kw = dict(cap=4, pair_budget=60, n_head=N * s, band_local=kind == "k9")
    if kind == "k3b":
        pallas = _jit(rp.rasterize_setup_pallas_band, width=W, band_h=BAND_H)
    else:
        pallas = _jit(rp.rasterize_setup_pallas_binned_band, width=W,
                      full_height=H, band_h=BAND_H, **kw)
    covered = 0
    for b in range(N):
        row0 = b * BAND_H
        if kind == "k3b":
            color, depth = tr.rasterize_setup_band(ti, tf, W, BAND_H, row0)
        else:
            color, depth = tr.rasterize_setup_binned_band(
                ti, tf, W, H, BAND_H, row0, **kw)
        ref = pallas(jti, jtf, row0=jnp.int32(row0))
        _close(color.numpy(), depth.numpy(), *ref)
        covered += int((depth < 1.0).sum())
    assert covered > 0.2 * W * H


def test_plain_k9g_matches_pallas_interpret():
    _, ti, tf, s = _gathered(materials=True)
    jti, jtf = jnp.asarray(ti.numpy()), jnp.asarray(tf.numpy())
    kw = dict(cap=4, pair_budget=60, n_head=N * s)
    pallas = _jit(rp.rasterize_gbuffer_pallas_binned_band, width=W,
                  full_height=H, band_h=BAND_H, **kw)
    for b in range(N):
        row0 = b * BAND_H
        ours = tr.rasterize_gbuffer_binned_band(ti, tf, W, H, BAND_H, row0,
                                                **kw)
        ref = pallas(jti, jtf, row0=jnp.int32(row0))
        assert len(ours) == len(ref) == tr.GBUFFER_PLANES
        _close(ours[0].numpy(), ours[1].numpy(), ref[0], ref[1])
        covered = ours[1].numpy() < 1.0
        assert covered.mean() > 0.2
        for a, r in zip(ours[2:7], ref[2:7]):  # u, v, normal
            np.testing.assert_allclose(a.numpy()[covered],
                                       np.asarray(r)[covered],
                                       rtol=2e-6, atol=1e-7)
        for a, r in zip(ours[7:], ref[7:]):  # the constants
            np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_plain_k9d_matches_pallas_interpret():
    """Each band owner's K9d over the slabs of both shards, stacked as the
    all-to-all delivers them; a 16-record slab (256 after rounding)."""
    slab = 16
    locals_, ti, tf, s = _gathered()
    jti, jtf = jnp.asarray(ti.numpy()), jnp.asarray(tf.numpy())
    ours = tiles.dist_exchange(tiles.InTurnExchange(N), locals_, W, H, s,
                               slab_records=slab)
    refs = [rp.prepare_binned_dist_local(
        jnp.asarray(t.numpy()), jnp.asarray(f.numpy()), W, H, n_bands=N,
        shard_index=r, shard_head=s, slab_records=slab)
        for r, (t, f) in enumerate(locals_)]
    pallas = _jit(rp.rasterize_setup_pallas_binned_band_dist, width=W,
                  full_height=H, band_h=BAND_H, slab_records=slab)
    for b in range(N):
        row0 = b * BAND_H
        color, depth = tr.rasterize_setup_binned_band_dist(
            ti, tf, *ours[b], W, H, BAND_H, row0)
        ref = pallas(jti, jtf, jnp.concatenate([x[3][b] for x in refs]),
                     jnp.stack([x[0][b] for x in refs]),
                     jnp.stack([x[1][b] for x in refs]),
                     jnp.stack([x[2][b] for x in refs]),
                     row0=jnp.int32(row0))
        assert (depth < 1.0).float().mean() > 0.2
        _close(color.numpy(), depth.numpy(), *ref)
