"""The reference's quarantined raster experiments, ported.

``zrenderer_tpu/ops/experiments/`` keeps alternative raster designs that
are bit-identical to the production kernels and measured slower on the
TPU; they render no production frame.  The port carries them as CUDA
kernels with plain torch versions, each held to the same oracle:

* ``raster_group8`` (K10g8, K10g8g, K10g8d): 8x128 group tiles, per-tile
  sorted triangle lists, then the leftover mega/super/block hierarchy;
* ``raster_vec`` (K10vec, K10vecg): lane-parallel 32-triangle subgroups
  over the block/superblock skip tables;
* ``raster_vis_trans`` (K10vis, K10trans): visibility buffers (depth and
  winning row id) from 8-row groups, gated by a per-tile hit bitmap or by
  the groups' bboxes over 4-row chunks, and the exact colour resolve;
* ``raster_hbm2`` (K10hbm2): two views of the rows, short (bbox within 8
  pixel rows) and tall, each with its own skip tables; short rows on an
  8-row window of the tile, tall rows over the whole tile, depth by
  (z, row id);
* ``raster_scanline`` (K10scan): K10hbm2's tall pass, then the short rows
  as row-sorted wide records in 32-record groups with per-group pass
  counts, each evaluated inside its bbox rows and columns.

No Renderer path or ``binning`` selects them, as in the reference: their
entry points (``rasterize_setup_group8``, ``rasterize_setup_vec``,
``rasterize_setup_vis``, ``rasterize_setup_trans``,
``rasterize_setup_hbm2``, ``rasterize_setup_scanline`` and the G-buffer
and depth variants) are called directly.
"""
