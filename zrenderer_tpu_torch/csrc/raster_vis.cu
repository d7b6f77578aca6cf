// K10vis and K10trans: the visibility-buffer and transposed-group raster
// experiments.  Both write the f32 depth and the i32 winning row id (-1
// where no row passed); the colour is resolved outside the kernel
// (resolve_flat_vis in
// zrenderer_tpu_torch/ops/experiments/raster_vis_trans.py).
//
// K10vis replaces rasterize_setup_pallas_vis
// (zrenderer_tpu/ops/experiments/raster_vis_trans.py :393, body
// _hbm_vis_bits_kernel :212).  Inputs: prepare_raster_inputs' rows (live
// rows compacted to the front, padded to RASTER_BLOCK), the superblock
// table and the hit bitmap of prepare_group_bits: one row of nwords int32
// words per tile, bit g of word w set when 8-row group 32w + g's union
// bbox meets the tile.
// What it computes, per 32x128 tile (one CUDA block of 256 threads, each
// owning one column and 16 rows, as raster_common.cuh): the superblocks
// whose bbox meets the tile; each of their blocks whose 16 group bits
// ((word[b / 2] >> 16 * (b % 2)) & 0xFFFF, read by broadcast loads) are
// not all clear; each set bit's 8 rows in order over all 4096 pixels, with
// no per-row bbox test, under the strict-less test z >= 0 && z < zb,
// keeping z and the row id (TileState with VIS).  A row that is dead
// (bias INT32_MAX) covers nothing; a row whose bbox clamps to empty below
// the frame draws in the padding rows, as the reference's does.
//
// K10trans replaces rasterize_setup_pallas_trans (:654, body
// _trans_vis_kernel :526).  Inputs: prepare_trans_inputs' records (the 20
// setup ints and the z-plane coefficients bitcast at lanes 20-22, 24 lanes
// a row), the union bbox of each 8-row group, and the block and superblock
// tables.  Per tile: the superblocks and blocks whose bbox meets it, then
// each group whose bbox does; the group's tile rows are evaluated in
// TRANS_R = 4 row chunks from lo = max(imin - row0, 0), the last chunks
// clamped to start at TILE_H - 4, which covers the rows
// [min(lo, TILE_H - 4), min(lo + 4 * nch, TILE_H)), nch = (hi - lo) / 4 + 1.
// At each such pixel the group's winner is its first row with the least z
// among the covered rows with z >= 0 (the others parked at 2.0): the
// reference's cross-sublane min with the lower id on exact ties.  It is
// merged into the tile by strict less.  The TPU kernel evaluates the 8
// rows as (8, 128) sublane vectors for the Mosaic layout; here each thread
// loops the 8 rows over its pixels of the span.
//
// What bounds them on the H100: the per-pixel edge work, 30 ops (three
// edge functions, the coverage test, the z plane, the depth test and the
// latch) per (pixel, row) evaluated, over far more pairs than K5: K10vis
// runs all 8 rows of a hit group at all 4096 pixels of the tile, K10trans
// the group's span rounded up to 4-row chunks.  The outputs are two 1080p
// planes (16.7 MB).  Setup rows are read by broadcast loads (__ldg); a
// hit group's 8 rows are re-read for each of its evaluations.
// ptxas (sm_90a, -O3 -fmad=false): K10vis 58 registers, K10trans 128
// (the group's z and row id beside the tile's, 16 pixels each), no
// spills, no shared memory.

#include "raster_common.cuh"

namespace zr {
namespace vis {

constexpr int GROUP = 8;                          // rows per hit bit / group
constexpr int GROUPS_PER_BLOCK = RASTER_BLOCK / GROUP;  // 16: half a word
constexpr int TRANS_R = 4;                        // tile rows per chunk
constexpr int REC_LANES = 24;                     // trans record stride
constexpr int TRANS_ZA = NI32;                    // z-plane lanes
constexpr float BIG_Z = 2.0f;

using VisState = TileState<false, false, false, TILE_H, NI32, NF32, true>;
static_assert(GROUPS_PER_BLOCK == 16, "a block reads half a bitmap word");

__global__ void __launch_bounds__(THREADS)
    raster_vis_kernel(const int* __restrict__ supers, int num_supers,
                      const int* __restrict__ bits, int nwords,
                      const int* __restrict__ ti,
                      const float* __restrict__ tf, int num_blocks,
                      float* __restrict__ depth, int* __restrict__ idx,
                      int width) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  VisState st;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  const int* row_bits = bits + (size_t)tile * nwords;
  for (int s = 0; s < num_supers; ++s) {
    const int* sb = supers + (size_t)s * 8;
    if (!tile_overlap(__ldg(sb), __ldg(sb + 1), __ldg(sb + 2), __ldg(sb + 3),
                      st.row0, st.col0))
      continue;
    const int b_end = min((s + 1) * SUPER_BLOCK, num_blocks);
    for (int b = s * SUPER_BLOCK; b < b_end; ++b) {
      uint32_t half =
          ((uint32_t)__ldg(row_bits + b / 2) >> (16 * (b % 2))) & 0xFFFFu;
      for (; half != 0; half &= half - 1) {
        const int t0 = b * RASTER_BLOCK + (__ffs(half) - 1) * GROUP;
#pragma unroll 1
        for (int u = 0; u < GROUP; ++u) st.eval(ti, tf, t0 + u);
      }
    }
  }
  st.store_vis(depth, idx, width);
}

__global__ void __launch_bounds__(THREADS)
    raster_trans_kernel(const int* __restrict__ supers, int num_supers,
                        const int* __restrict__ blocks,
                        const int* __restrict__ rec,
                        const int* __restrict__ gbounds, int num_blocks,
                        float* __restrict__ depth, int* __restrict__ idx,
                        int width) {
  constexpr int NPIX = VisState::NPIX;
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  VisState st;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  const int row0 = st.row0, col0 = st.col0;
  const int trow0 = (int)(threadIdx.x / TILE_W);  // tile row of pixel 0
  for (int s = 0; s < num_supers; ++s) {
    const int* sb = supers + (size_t)s * 8;
    if (!tile_overlap(__ldg(sb), __ldg(sb + 1), __ldg(sb + 2), __ldg(sb + 3),
                      row0, col0))
      continue;
    const int b_end = min((s + 1) * SUPER_BLOCK, num_blocks);
    for (int b = s * SUPER_BLOCK; b < b_end; ++b) {
      const int* bb = blocks + (size_t)b * 8;
      if (!tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2),
                        __ldg(bb + 3), row0, col0))
        continue;
      for (int q = 0; q < GROUPS_PER_BLOCK; ++q) {
        const int g = b * GROUPS_PER_BLOCK + q;
        const int* gb = gbounds + (size_t)g * 4;
        const int imin = __ldg(gb + 2), imax = __ldg(gb + 3);
        if (!tile_overlap(__ldg(gb), __ldg(gb + 1), imin, imax, row0, col0))
          continue;
        const int lo = max(imin - row0, 0);
        const int hi = min(imax - row0, TILE_H - 1);
        const int nch = (hi - lo) / TRANS_R + 1;  // hi >= lo: the bbox meets
        const int r_lo = min(lo, TILE_H - TRANS_R);
        const int r_hi = min(lo + TRANS_R * nch, TILE_H);
        float zg[NPIX];
        int ig[NPIX];
#pragma unroll
        for (int k = 0; k < NPIX; ++k) {
          zg[k] = BIG_Z;
          ig[k] = 0;
        }
#pragma unroll 1
        for (int u = 0; u < GROUP; ++u) {
          const int t = g * GROUP + u;
          const int* r = rec + (size_t)t * REC_LANES;
          const int x0 = __ldg(r + I_X0), y0 = __ldg(r + I_Y0);
          const int x1 = __ldg(r + I_X1), y1 = __ldg(r + I_Y1);
          const int x2 = __ldg(r + I_X2), y2 = __ldg(r + I_Y2);
          const int dx0 = __ldg(r + I_DX0), dy0 = __ldg(r + I_DY0);
          const int dx1 = __ldg(r + I_DX1), dy1 = __ldg(r + I_DY1);
          const int dx2 = __ldg(r + I_DX2), dy2 = __ldg(r + I_DY2);
          const int b0 = __ldg(r + I_BIAS0), b1 = __ldg(r + I_BIAS1);
          const int b2 = __ldg(r + I_BIAS2);
          const float za0 = __int_as_float(__ldg(r + TRANS_ZA));
          const float za1 = __int_as_float(__ldg(r + TRANS_ZA + 1));
          const float za2 = __int_as_float(__ldg(r + TRANS_ZA + 2));
#pragma unroll
          for (int k = 0; k < NPIX; ++k) {
            const int row = trow0 + k * ROW_STEP;
            if (row < r_lo || row >= r_hi) continue;
            const int e0 = edge_fn(dx0, dy0, x1, y1, st.px, st.py(k));
            const int e1 = edge_fn(dx1, dy1, x2, y2, st.px, st.py(k));
            const int e2 = edge_fn(dx2, dy2, x0, y0, st.px, st.py(k));
            if (e0 < b0 || e1 < b1 || e2 < b2) continue;
            const float zz = interp3(__int2float_rn(e0), __int2float_rn(e1),
                                     __int2float_rn(e2), za0, za1, za2);
            if (zz >= 0.0f && zz < zg[k]) {  // first row of the least z
              zg[k] = zz;
              ig[k] = t;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < NPIX; ++k) {
          const int row = trow0 + k * ROW_STEP;
          if (row >= r_lo && row < r_hi) st.depth_test(k, zg[k], ig[k]);
        }
      }
    }
  }
  st.store_vis(depth, idx, width);
}

}  // namespace vis
}  // namespace zr

// K10vis: depth and row id planes.
extern "C" int zr_raster_vis(const int* supers, int num_supers,
                             const int* bits, int nwords, const int* ti,
                             const float* tf, int num_blocks, float* depth,
                             int* idx, int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::vis::raster_vis_kernel<<<num_tiles, zr::THREADS, 0,
                               (cudaStream_t)stream>>>(
      supers, num_supers, bits, nwords, ti, tf, num_blocks, depth, idx,
      width);
  return (int)cudaGetLastError();
}

// K10trans: depth and row id planes.
extern "C" int zr_raster_trans(const int* supers, int num_supers,
                               const int* blocks, const int* rec,
                               const int* gbounds, int num_blocks,
                               float* depth, int* idx, int height, int width,
                               void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::vis::raster_trans_kernel<<<num_tiles, zr::THREADS, 0,
                                 (cudaStream_t)stream>>>(
      supers, num_supers, blocks, rec, gbounds, num_blocks, depth, idx,
      width);
  return (int)cudaGetLastError();
}
