// K10hbm2 and K10scan: the two-class raster experiments.  Both split the
// setup rows into a short class (live rows whose bbox spans at most 8
// pixel rows) and a tall class, each a view of the same padded,
// uncompacted rows with the other class killed (empty bbox, valid 0), each
// with its own block and superblock bbox tables; the row ids are the
// uncompacted row indices, and a row is live in exactly one view.  Both
// test depth by (z, row id) against the clear values (1.0, INT32_MAX), so
// a pixel whose least z is exactly 1.0 is latched (K5's strict less leaves
// it clear) and the two passes may run in either order.  Epilogue as K5's:
// one divide per pixel into packed RGBA8 + f32 depth.
//
// K10hbm2 replaces rasterize_setup_pallas_hbm2
// (zrenderer_tpu/ops/experiments/raster_hbm2.py :254, body _hbm2_kernel
// :62).  Inputs: prepare_raster_inputs_2class
// (zrenderer_tpu_torch/ops/experiments/raster_hbm2.py).  Per 32x128 tile:
// each short row whose bbox meets the tile on the 8 tile rows from
// clamp(imin - row0, 0, 24), all 128 columns; each tall row whose bbox
// meets the tile over the whole tile.
//
// K10scan replaces rasterize_setup_pallas_scanline
// (zrenderer_tpu/ops/experiments/raster_scanline.py :487, body
// _scanline_kernel :196).  Inputs: prepare_scanline_inputs
// (zrenderer_tpu_torch/ops/experiments/raster_scanline.py): the short
// rows as 32-lane wide records, sorted by first row inside each 128-row
// block, with per-32-record group pass counts in lanes 4-7 of the short
// block table.  Per tile: the tall rows as K10hbm2's; each record of a
// short block whose bbox meets the tile, in a group with a pass count P >
// 0, at the pixels of rows imin + dh, 0 <= dh <= min(h, P - 1), and
// columns [jmin, jmax], with the edge functions in the record's form A +
// S*dh - D*x (int32 wrap, equal to edge_fn), and a short winner's z stored
// plus 0.0f (the reference's one-hot sum turns its -0.0 into +0.0).
//
// Both run the keyed hierarchy body (raster_keyed.cuh, as K5 in
// raster_hier.cu), with the planes of the register body they ran before
// bit for bit.  What bound that body on the H100 (K10hbm2 28.85 ms,
// K10scan 23.93 ms a call on lattice1M at 1920x1088, 171 and 173
// registers): one CUDA block a tile walked each view's superblock ->
// block -> row tables one dependent load at a time over 1.09M padded rows
// (0.5M live), then evaluated each hit row at every pixel of its extent
// (4096 for a tall row, 1024 for a K10hbm2 short row, a thread's 16
// pixels tested against a K10scan record's rectangle).  Here:
// * one kernel writes both views' hit words once a call
//   (twoclass_hit_words_kernel, grid (tiles, 2));
// * a tile's hit blocks of the short view, then of the tall view, are cut
//   into `items` work items of about equal counts (the sum of the two
//   counts), one CUDA block each; an item tests a hit block's 128 rows
//   (or records) by 128 threads at once and compacts the hits into one
//   pending list for both classes;
// * each pending row or record is evaluated over its window only: a
//   row's vertices' pixel bbox in the tile, within the kernel's extent (a
//   tall row: the tile; a K10hbm2 short row: its 8 tile rows), a K10scan
//   record's rectangle in the tile (inside its bbox, so inside the
//   vertices' bbox).  Inside the geometry's rows the window holds every
//   pixel the row covers; in the padding rows below it, each kernel's own
//   extent, as before;
// * one key plane for both classes: K4's key (order bits of z, tag), the
//   tag the row id (K10hbm2) or the row id over the class (K10scan: id <<
//   1 | short, the same order as the id, since ids are distinct), the
//   clear key (1.0, INT32_MAX) so that z == 1.0 latches; items merge by
//   atomicMin into the output's key plane and one resolve re-evaluates
//   the winner from the tall view's row (kill_rows keeps the edge columns,
//   so it serves the short rows too; raster_common.cuh resolve_winner),
//   K10scan adding 0.0f to a short winner's z.
// Bound on the H100: the bytes the body needs (the tables, the admitted
// rows and records, the winners' rows, the two planes), or the window
// pixels' edge work.

#include <type_traits>

#include "raster_keyed.cuh"

namespace zr {
namespace twoclass {

constexpr int SHORT_ROWS = 8;  // a short row's span, and K10hbm2's window
constexpr int GROUP = 32;      // K10scan records per pass-count group
constexpr int GROUPS_PER_BLOCK = RASTER_BLOCK / GROUP;  // 4: lanes 4-7
constexpr int WIDE_LANES = 32;
// Wide-record lanes (raster_scanline.py WL_*): int32 bits in lanes 0-11
// (edge k's value A at (row imin, column 0), its per-column step D = 8*dy,
// per-row step S = 8*dx, its coverage bias), f32 from 12 (first row, row
// span h, -1 for a row that is not short, columns, id + 1), then the z
// coefficients.
constexpr int WL_A0 = 0, WL_D0 = 3, WL_S0 = 6, WL_B0 = 9, WL_IMIN = 12,
              WL_H = 13, WL_JMINF = 14, WL_JMAXF = 15, WL_IDF = 16,
              WL_ZA0 = 17;
// A pending entry's class bit: a short row (K10hbm2) or record slot
// (K10scan); without it a tall row.  Row ids and slots stay below it.
constexpr int SHORT_ENTRY = 1 << 30;
static_assert(GROUPS_PER_BLOCK == 4, "pass counts sit in lanes 4-7");

// K10hbm2's keys: K4's (raster_keyed.cuh FlatKeys), the row id as tag.
struct Hbm2Keys : FlatKeys {
  static __device__ __forceinline__ uint32_t tag(int t, bool) {
    return (uint32_t)t;
  }
};

// K10scan's: the row id over the class bit.  The store resolves the
// winner (tag >> 1) and adds 0.0f to a short one's z.
struct ScanKeys : FlatKeys {
  static __device__ __forceinline__ uint32_t tag(int t, bool short_row) {
    return ((uint32_t)t << 1) | (short_row ? 1u : 0u);
  }
  static __device__ __forceinline__ void store(
      unsigned long long k, int row, int col, const int* __restrict__ ti,
      const float* __restrict__ tf, int* __restrict__ color,
      float* __restrict__ depth, float* __restrict__ extra, size_t idx,
      size_t frame) {
    const bool won = k != CLEAR;
    const uint32_t tag = (uint32_t)k;
    resolve_winner<true, false, true>(
        ti, tf, won ? (int)(tag >> 1) : INT_MAX32, 1.0f,
        col * SUBPIXEL + HALF, row * SUBPIXEL + HALF, color, depth, extra,
        idx, frame, won && (tag & 1u));
  }
};

template <bool SCAN>
using Keys = std::conditional_t<SCAN, ScanKeys, Hbm2Keys>;

// K10scan's record in slot k of the short view (block k / RASTER_BLOCK,
// group (k % RASTER_BLOCK) / GROUP, whose pass count P lane 4 + group of
// the block table holds): its rectangle in the tile, rows imin .. imin +
// min(h, P - 1) and columns [jmin, jmax].  False where that is empty (h <
// 0: not a short row; P == 0).
__device__ __forceinline__ bool record_window(const float* __restrict__ w,
                                              const int* __restrict__ blocks8,
                                              int k, int row0, int col0,
                                              int& r_lo, int& r_hi, int& c_lo,
                                              int& c_hi) {
  const int passes = __ldg(blocks8 + (size_t)(k / RASTER_BLOCK) * 8 + 4 +
                           (k % RASTER_BLOCK) / GROUP);
  const int imin = (int)__ldg(w + WL_IMIN);
  r_lo = max(imin, row0);
  r_hi = min(imin + min((int)__ldg(w + WL_H), passes - 1), row0 + TILE_H - 1);
  c_lo = max((int)__ldg(w + WL_JMINF), col0);
  c_hi = min((int)__ldg(w + WL_JMAXF), col0 + TILE_W - 1);
  return passes > 0 && r_lo <= r_hi && c_lo <= c_hi;
}

// Batch column j from wide record w over its rectangle [r_lo, r_hi] x
// [c_lo, c_hi]: edge k at the origin A + S*(r_lo - imin) - D*c_lo, its
// steps -D a column and S a row (int32 wrap).  Returns the area.
__device__ __forceinline__ int prepare_wide(KeyedSmem& s, int j,
                                            const float* __restrict__ w,
                                            int r_lo, int r_hi, int c_lo,
                                            int c_hi, int row0, int col0) {
  const int* wi = reinterpret_cast<const int*>(w);
  const uint32_t dh = (uint32_t)(r_lo - (int)__ldg(w + WL_IMIN));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint32_t a = (uint32_t)__ldg(wi + WL_A0 + i);
    const uint32_t d = (uint32_t)__ldg(wi + WL_D0 + i);
    const uint32_t sr = (uint32_t)__ldg(wi + WL_S0 + i);
    s.e[i][j] = (int)(a + sr * dh - d * (uint32_t)c_lo);
    s.cstep[i][j] = (int)(0u - d);
    s.rstep[i][j] = (int)sr;
    s.bias[i][j] = __ldg(wi + WL_B0 + i);
    s.za[i][j] = __ldg(w + WL_ZA0 + i);
  }
  const int wide = c_hi - c_lo + 1;
  stage_origin(s, j, r_lo - row0, c_lo - col0, wide,
               ScanKeys::tag((int)__ldg(w + WL_IDF) - 1, true));
  return wide * (r_hi - r_lo + 1);
}

// Block (tile, view) writes the tile's hit words of the short view
// (blockIdx.y 0) or the tall one (1): raster_keyed.cuh tile_hit_words.
__global__ void __launch_bounds__(THREADS) twoclass_hit_words_kernel(
    const int* __restrict__ supers_s, int num_supers_s,
    const int* __restrict__ blocks_s, int* buf_s,
    const int* __restrict__ supers_t, int num_supers_t,
    const int* __restrict__ blocks_t, int* buf_t, int width, int height) {
  __shared__ int warp_sums[WARPS];
  const int tiles_x = width / TILE_W, tile = (int)blockIdx.x;
  const bool tall = blockIdx.y == 1;
  tile_hit_words(tall ? supers_t : supers_s,
                 tall ? num_supers_t : num_supers_s,
                 tall ? blocks_t : blocks_s, tall ? buf_t : buf_s,
                 tiles_x * (height / TILE_H), tile, (tile / tiles_x) * TILE_H,
                 (tile % tiles_x) * TILE_W, warp_sums);
}

// The views of one call: each view's hit words (buf_*, num_supers_*), the
// short view's block table and rows (K10hbm2: ti_s, NI32 ints a row;
// K10scan: blocks8_s with the pass counts and the wide records), the tall
// view's rows ti_t, and the coefficients tf of both.
struct Views {
  const int* buf_s;
  int num_supers_s;
  const int* blocks_s;
  const void* short_rows;
  const int* buf_t;
  int num_supers_t;
  const int* ti_t;
  const float* tf;
};

// Work item blockIdx.x is item i = blockIdx.x % items of tile blockIdx.x /
// items.  The tile's H = H_s + H_t hit blocks, the short view's first,
// are cut into items shares [i * H / items, (i + 1) * H / items) (an item
// with none returns at once); the item walks its share of each view
// (walk_hit_blocks), tests each hit block's 128 rows or records by 128
// threads at once, pends the hits of both classes in one list
// (keyed_pend, a short one with SHORT_ENTRY) and evaluates KEY_BATCH at a
// time over their windows.  Then out (keyed_out): the tile's planes from
// the item that holds all its hit blocks (one item a tile, or at most one
// hit block: the last item), else into the key plane.
template <bool SCAN>
__device__ __forceinline__ void twoclass_items(
    const Views& v, int items, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  using Mode = Keys<SCAN>;
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSmem& s = *reinterpret_cast<KeyedSmem*>(keyed_smem);
  const int tiles_x = width / TILE_W, tiles = tiles_x * (height / TILE_H);
  const int tile = (int)blockIdx.x / items, idx = (int)blockIdx.x % items;
  const int row0 = (tile / tiles_x) * TILE_H;
  const int col0 = (tile % tiles_x) * TILE_W;
  const HitWords<const int> hs = hit_words(v.buf_s, tiles, v.num_supers_s);
  const HitWords<const int> ht = hit_words(v.buf_t, tiles, v.num_supers_t);
  const int n_s = __ldg(hs.count + tile), n_t = __ldg(ht.count + tile);
  const int total = n_s + n_t;
  const int h0 = idx * total / items, h1 = (idx + 1) * total / items;
  const bool alone = items == 1 || (total <= 1 && idx == items - 1);
  if (h0 == h1 && !alone) return;  // block-uniform
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) s.key[p] = Mode::CLEAR;
  const int* ti_t = v.ti_t;
  const float* tf = v.tf;
  // The first n pending entries as one batch.
  auto flush = [&](int n) {
    int area = 0;
    const int j = threadIdx.x;
    if (j < n) {
      const int entry = s.pending[j];
      const int t = entry & (SHORT_ENTRY - 1);
      const bool short_row = (entry & SHORT_ENTRY) != 0;
      if (SCAN && short_row) {
        const float* w = static_cast<const float*>(v.short_rows) +
                         (size_t)t * WIDE_LANES;
        int r_lo, r_hi, c_lo, c_hi;
        record_window(w, v.blocks_s, t, row0, col0, r_lo, r_hi, c_lo, c_hi);
        area = prepare_wide(s, j, w, r_lo, r_hi, c_lo, c_hi, row0, col0);
      } else {
        // A K10hbm2 short row on its 8 tile rows; the tall view keeps the
        // row's vertices, edges and imin.
        const int* r = ti_t + (size_t)t * NI32;
        const int lo =
            short_row ? min(max(r[I_IMIN] - row0, 0), TILE_H - SHORT_ROWS)
                      : 0;
        area = prepare_record(s, j, r, tf + (size_t)t * NF32 + F_ZA0,
                              Mode::tag(t, short_row), row0, col0, lo,
                              short_row ? SHORT_ROWS : TILE_H);
      }
    }
    eval_batch<Mode>(s, area);
  };
  int pending = 0;  // block-uniform; the walks' barriers order the clear
  if (h0 < n_s) {
    walk_hit_blocks(
        s, hs.words + (size_t)tile * v.num_supers_s,
        hs.before + (size_t)tile * v.num_supers_s, v.num_supers_s, n_s, h0,
        min(h1, n_s), [&](int b) {
          const int k = b * RASTER_BLOCK + (int)threadIdx.x;
          bool hit = false;
          if (threadIdx.x < RASTER_BLOCK) {
            if constexpr (SCAN) {
              int r_lo, r_hi, c_lo, c_hi;
              hit = record_window(static_cast<const float*>(v.short_rows) +
                                      (size_t)k * WIDE_LANES,
                                  v.blocks_s, k, row0, col0, r_lo, r_hi,
                                  c_lo, c_hi);
            } else {
              const int* r = static_cast<const int*>(v.short_rows) +
                             (size_t)k * NI32;
              hit = tile_overlap(__ldg(r + I_JMIN), __ldg(r + I_JMAX),
                                 __ldg(r + I_IMIN), __ldg(r + I_IMAX), row0,
                                 col0);
            }
          }
          keyed_pend(s, hit, k | SHORT_ENTRY, pending, flush);
        });
  }
  if (h1 > n_s) {
    walk_hit_blocks(s, ht.words + (size_t)tile * v.num_supers_t,
                    ht.before + (size_t)tile * v.num_supers_t, v.num_supers_t,
                    n_t, max(h0 - n_s, 0), h1 - n_s, [&](int b) {
                      const int t = b * RASTER_BLOCK + (int)threadIdx.x;
                      bool hit = false;
                      if (threadIdx.x < RASTER_BLOCK) {
                        const int* r = ti_t + (size_t)t * NI32;
                        hit = tile_overlap(__ldg(r + I_JMIN),
                                           __ldg(r + I_JMAX),
                                           __ldg(r + I_IMIN),
                                           __ldg(r + I_IMAX), row0, col0);
                      }
                      keyed_pend(s, hit, t, pending, flush);
                    });
  }
  if (pending > 0) {
    __syncthreads();
    flush(pending);
  }
  __syncthreads();
  keyed_out<Mode>(s, alone, plane, row0, col0, ti_t, tf, color, depth,
                  nullptr, width, height);
}

// The resolve of a tile of several items whose rows lie in two or more hit
// blocks of the two views.
template <bool SCAN>
__device__ __forceinline__ void twoclass_resolve(
    const Views& v, const unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  const int tiles_x = width / TILE_W, tiles = tiles_x * (height / TILE_H);
  const int tile = (int)blockIdx.x;
  if (__ldg(hit_words(v.buf_s, tiles, v.num_supers_s).count + tile) +
          __ldg(hit_words(v.buf_t, tiles, v.num_supers_t).count + tile) <=
      1)
    return;  // resolved in place
  resolve_tile<Keys<SCAN>>(plane, (tile / tiles_x) * TILE_H,
                           (tile % tiles_x) * TILE_W, v.ti_t, v.tf, color,
                           depth, nullptr, width, height);
}

// One entry point per kernel, so each has its own name in a profile.
__global__ void __launch_bounds__(THREADS) raster_hbm2_keyed_kernel(
    Views v, int items, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  twoclass_items<false>(v, items, plane, color, depth, width, height);
}

__global__ void __launch_bounds__(THREADS) raster_hbm2_resolve_kernel(
    Views v, const unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  twoclass_resolve<false>(v, plane, color, depth, width, height);
}

__global__ void __launch_bounds__(THREADS) raster_scan_keyed_kernel(
    Views v, int items, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  twoclass_items<true>(v, items, plane, color, depth, width, height);
}

__global__ void __launch_bounds__(THREADS) raster_scan_resolve_kernel(
    Views v, const unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  twoclass_resolve<true>(v, plane, color, depth, width, height);
}

}  // namespace twoclass
}  // namespace zr

// Both kernels: the views' hit words (buf: tiles * (2 num_supers_s + 1)
// ints, then tiles * (2 num_supers_t + 1)), then tiles * items work items,
// with several items a tile the key plane (height * width keys) set to all
// ones first and the resolve over the tiles after.
template <class Items, class Resolve>
static int launch_twoclass(Items items_kernel, Resolve resolve_kernel,
                           const int* supers_s, int num_supers_s,
                           const int* blocks_s, const void* short_rows,
                           const int* supers_t, int num_supers_t,
                           const int* blocks_t, const int* ti_t,
                           const float* tf, int items, int* buf,
                           unsigned long long* plane, int* color,
                           float* depth, int height, int width,
                           void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = (int)sizeof(zr::KeyedSmem);
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int* buf_t = buf + (size_t)num_tiles * (2 * num_supers_s + 1);
  zr::twoclass::twoclass_hit_words_kernel<<<dim3(num_tiles, 2), zr::THREADS,
                                            0, s>>>(
      supers_s, num_supers_s, blocks_s, buf, supers_t, num_supers_t,
      blocks_t, buf_t, width, height);
  if (items > 1) {
    err = cudaMemsetAsync(plane, 0xff,
                          (size_t)height * width * sizeof(*plane), s);
    if (err != cudaSuccess) return (int)err;
  }
  const zr::twoclass::Views v{buf,   num_supers_s, blocks_s, short_rows,
                              buf_t, num_supers_t, ti_t,     tf};
  items_kernel<<<num_tiles * items, zr::THREADS, smem, s>>>(
      v, items, plane, color, depth, width, height);
  if (items > 1)
    resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(v, plane, color, depth,
                                                     width, height);
  return (int)cudaGetLastError();
}

// K10hbm2: packed RGBA8 (u32 bits) and f32 depth planes.
extern "C" int zr_raster_hbm2(const int* supers_s, int num_supers_s,
                              const int* blocks_s, const int* ti_s,
                              const int* supers_t, int num_supers_t,
                              const int* blocks_t, const int* ti_t,
                              const float* tf, int items, int* buf,
                              unsigned long long* plane, int* color,
                              float* depth, int height, int width,
                              void* stream) {
  return launch_twoclass(zr::twoclass::raster_hbm2_keyed_kernel,
                         zr::twoclass::raster_hbm2_resolve_kernel, supers_s,
                         num_supers_s, blocks_s, ti_s, supers_t,
                         num_supers_t, blocks_t, ti_t, tf, items, buf, plane,
                         color, depth, height, width, stream);
}

// K10scan: packed RGBA8 (u32 bits) and f32 depth planes.
extern "C" int zr_raster_scan(const int* supers_s, int num_supers_s,
                              const int* blocks8_s, const float* wide,
                              const int* supers_t, int num_supers_t,
                              const int* blocks_t, const int* ti_t,
                              const float* tf, int items, int* buf,
                              unsigned long long* plane, int* color,
                              float* depth, int height, int width,
                              void* stream) {
  return launch_twoclass(zr::twoclass::raster_scan_keyed_kernel,
                         zr::twoclass::raster_scan_resolve_kernel, supers_s,
                         num_supers_s, blocks8_s, wide, supers_t,
                         num_supers_t, blocks_t, ti_t, tf, items, buf, plane,
                         color, depth, height, width, stream);
}
