// K10hbm2 and K10scan: the two-class raster experiments.  Both split the
// setup rows into a short class (live rows whose bbox spans at most 8
// pixel rows) and a tall class, each a view of the same padded,
// uncompacted rows with the other class killed (empty bbox, valid 0), each
// with its own block and superblock bbox tables; the row ids are the
// uncompacted row indices.  Both test depth by (z, row id) against the
// clear values (1.0, INT32_MAX), so a pixel whose least z is exactly 1.0
// is latched (K5's strict less leaves it clear) and the two passes may run
// in either order.  Epilogue as K5's: one divide per pixel into packed
// RGBA8 + f32 depth.
//
// K10hbm2 replaces rasterize_setup_pallas_hbm2
// (zrenderer_tpu/ops/experiments/raster_hbm2.py :254, body _hbm2_kernel
// :62).  Inputs: prepare_raster_inputs_2class
// (zrenderer_tpu_torch/ops/experiments/raster_hbm2.py).  Per 32x128 tile
// (one CUDA block of 256 threads, each owning one column and 16 rows, as
// raster_common.cuh): first the short view's hierarchy, each row whose
// bbox meets the tile evaluated on the 8 tile rows from
// clamp(imin - row0, 0, 24), all 128 columns; then the tall view's, each
// hit row over the whole tile (TileState::scan_hierarchy).
//
// K10scan replaces rasterize_setup_pallas_scanline
// (zrenderer_tpu/ops/experiments/raster_scanline.py :487, body
// _scanline_kernel :196).  Inputs: prepare_scanline_inputs
// (zrenderer_tpu_torch/ops/experiments/raster_scanline.py): the short
// rows as 32-lane wide records, sorted by first row inside each 128-row
// block, with per-32-record group pass counts in lanes 4-7 of the short
// block table.  Per tile: the tall pass as K10hbm2's; then the short
// view's superblocks and blocks whose bbox meets the tile, each of the
// block's four groups with a pass count P > 0, each record of the group
// at the pixels of rows imin + dh, 0 <= dh <= min(h, P - 1), and columns
// [jmin, jmax], with the edge functions in the record's form A + S*dh -
// D*x (int32 wrap, equal to edge_fn), and its z stored plus 0.0f.  The
// reference evaluates a group as (32, 128) vectors, takes each same-row
// run's (z, id) minimum with a sublane roll-min and scatters it with a
// one-hot matmul, whose sum turns a winner's -0.0 into +0.0; here each
// thread walks the records over its own pixels, which gives the same
// per-pixel (z, id) minimum.
//
// What bounds them on the H100: by count, the per-pixel edge work, 26 ops
// a (pixel, row) evaluation, over the tall (tile, row) pairs x 4096 pixels
// plus the short rows' share: K10hbm2 1024 pixels a short (tile, row)
// pair, K10scan a short row's own fragments in the tile.  In practice the
// walk: each view keeps every padded row in place (1.09M rows for the
// 1M lattice's 0.5M live ones), so a hit block costs 128 row tests in
// each view, and each thread loops over all 16 of its pixels for a short
// row, skipping those outside the window.  Setup rows and wide records
// are read by broadcast loads; the outputs are two 1080p planes (16.7 MB).
// The simple design: TileState's registers and walk, one eval_row for both
// record forms (raster_common.cuh).
// ptxas (sm_90a, -O3 -fmad=false): K10hbm2 171 registers, K10scan 173, no
// spills, no shared memory.

#include "raster_common.cuh"

namespace zr {
namespace twoclass {

constexpr int GROUP = 32;                           // records per group
constexpr int GROUPS_PER_BLOCK = RASTER_BLOCK / GROUP;  // 4: lanes 4-7
constexpr int WIDE_LANES = 32;
// Wide-record lanes (raster_scanline.py WL_*): the int32 lanes 0-11 in
// raster_common.cuh; f32 from 12, the 15 coefficients from WL_ZA0 at the
// F_ZA0..F_CB0 + 2 offsets of a setup row.
constexpr int WL_IMIN = 12, WL_H = 13, WL_JMINF = 14, WL_JMAXF = 15,
              WL_IDF = 16, WL_ZA0 = 17;

using State = TileState<true>;
static_assert(GROUPS_PER_BLOCK == 4, "pass counts sit in lanes 4-7");

__global__ void __launch_bounds__(THREADS)
    raster_hbm2_kernel(const int* __restrict__ supers_s, int num_supers_s,
                       const int* __restrict__ blocks_s,
                       const int* __restrict__ ti_s,
                       const int* __restrict__ supers_t, int num_supers_t,
                       const int* __restrict__ blocks_t,
                       const int* __restrict__ ti_t,
                       const float* __restrict__ tf, int* __restrict__ color,
                       float* __restrict__ depth, int width) {
  const int tiles_x = width / TILE_W;
  State st;
  st.init((blockIdx.x / tiles_x) * TILE_H, (blockIdx.x % tiles_x) * TILE_W);
  st.scan_hierarchy<true>(supers_s, num_supers_s, blocks_s, ti_s, tf);
  st.scan_hierarchy(supers_t, num_supers_t, blocks_t, ti_t, tf);
  st.store(color, depth, width);
}

__global__ void __launch_bounds__(THREADS)
    raster_scan_kernel(const int* __restrict__ supers_s, int num_supers_s,
                       const int* __restrict__ blocks8_s,
                       const float* __restrict__ wide,
                       const int* __restrict__ supers_t, int num_supers_t,
                       const int* __restrict__ blocks_t,
                       const int* __restrict__ ti_t,
                       const float* __restrict__ tf, int* __restrict__ color,
                       float* __restrict__ depth, int width) {
  const int tiles_x = width / TILE_W;
  State st;
  st.init((blockIdx.x / tiles_x) * TILE_H, (blockIdx.x % tiles_x) * TILE_W);
  const int row0 = st.row0, col0 = st.col0;
  st.scan_hierarchy(supers_t, num_supers_t, blocks_t, ti_t, tf);
  for (int s = 0; s < num_supers_s; ++s) {
    const int* sb = supers_s + (size_t)s * 8;
    if (!tile_overlap(__ldg(sb), __ldg(sb + 1), __ldg(sb + 2), __ldg(sb + 3),
                      row0, col0))
      continue;
    for (int b = s * SUPER_BLOCK; b < (s + 1) * SUPER_BLOCK; ++b) {
      const int* bb = blocks8_s + (size_t)b * 8;
      if (!tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2),
                        __ldg(bb + 3), row0, col0))
        continue;
      for (int q = 0; q < GROUPS_PER_BLOCK; ++q) {
        const int passes = __ldg(bb + 4 + q);
        if (passes <= 0) continue;
        for (int u = 0; u < GROUP; ++u) {
          const float* w =
              wide + (size_t)(b * RASTER_BLOCK + q * GROUP + u) * WIDE_LANES;
          const int imin = (int)__ldg(w + WL_IMIN);
          const int r_lo = max(imin, row0);
          const int r_hi = min(imin + min((int)__ldg(w + WL_H), passes - 1),
                               row0 + TILE_H - 1);
          const int c_lo = max((int)__ldg(w + WL_JMINF), col0);
          const int c_hi = min((int)__ldg(w + WL_JMAXF), col0 + TILE_W - 1);
          if (r_lo > r_hi || c_lo > c_hi) continue;  // block-uniform
          st.eval_row<true, true>(reinterpret_cast<const int*>(w),
                                  w + WL_ZA0, (int)__ldg(w + WL_IDF) - 1,
                                  r_lo, r_hi, c_lo, c_hi, imin);
        }
      }
    }
  }
  st.store(color, depth, width);
}

}  // namespace twoclass
}  // namespace zr

// K10hbm2: packed RGBA8 (u32 bits) and f32 depth planes.
extern "C" int zr_raster_hbm2(const int* supers_s, int num_supers_s,
                              const int* blocks_s, const int* ti_s,
                              const int* supers_t, int num_supers_t,
                              const int* blocks_t, const int* ti_t,
                              const float* tf, int* color, float* depth,
                              int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::twoclass::raster_hbm2_kernel<<<num_tiles, zr::THREADS, 0,
                                     (cudaStream_t)stream>>>(
      supers_s, num_supers_s, blocks_s, ti_s, supers_t, num_supers_t,
      blocks_t, ti_t, tf, color, depth, width);
  return (int)cudaGetLastError();
}

// K10scan: packed RGBA8 (u32 bits) and f32 depth planes.
extern "C" int zr_raster_scan(const int* supers_s, int num_supers_s,
                              const int* blocks8_s, const float* wide,
                              const int* supers_t, int num_supers_t,
                              const int* blocks_t, const int* ti_t,
                              const float* tf, int* color, float* depth,
                              int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::twoclass::raster_scan_kernel<<<num_tiles, zr::THREADS, 0,
                                     (cudaStream_t)stream>>>(
      supers_s, num_supers_s, blocks8_s, wide, supers_t, num_supers_t,
      blocks_t, ti_t, tf, color, depth, width);
  return (int)cudaGetLastError();
}
