// K1: small-scene binned flat raster; K2d and K2g, its depth-only and
// G-buffer variants.
//
// Replaces rasterize_setup_pallas_small (K1: zrenderer_tpu/ops/
// raster_pallas.py, the _binned_kernel with local_lists=True, body
// _binned_body), rasterize_depth_pallas_small (K2d: the
// _binned_depth_kernel with local_lists=True, _binned_body with
// depth_only) and rasterize_gbuffer_pallas_small (K2g: the
// _binned_gbuffer_kernel with local_lists=True, the same body with the
// G-buffer latches and epilogue).  Inputs are the outputs of
// prepare_binned_small (zrenderer_tpu_torch/ops/raster.py): per-tile
// counts, per-tile lists of head-row ids (n_head entries a tile, the first
// counts[tile] live, ascending), the superblock/block bbox tables and the
// setup rows with every head row's bbox emptied, so the hierarchy only
// holds the clipped-fan rows.
//
// What each computes, per 32x128 tile: every row of the tile's list, then
// the fan-tail rows through superblock -> block -> row bbox skips.  K1:
// the depth test z >= 0 && (z < zb || (z == zb && t < tb)), an order-free
// (z, row id) tie-break equal to sequential strict-less, then one divide
// per pixel into packed RGBA8 + f32 depth.  K2d: z alone under the
// strict-less test z >= 0 && z < zb, list rows in ascending id order, then
// the hierarchy (on an exact tie the first row visited keeps its sign of
// zero); one f32 plane.  K2g: K1's rows keeping z and the winning row id,
// then the 13 G-buffer planes resolved from the winner's row
// (raster_common.cuh TileState::store_gbuffer, epilogue buf * (covered ?
// 1/den : 0)).
//
// K1 and K2d on the H100: sub-tile blocks with staged rows.  Neither is
// short of arithmetic (the 1080p test scene makes 2.15M pixel evaluations
// inside its rows' bboxes, its light view 1.34M): they wait on round trips
// to memory and on the busiest tiles' row loops.  So:
// * SMALL_BLOCKS blocks a tile, each a sub-tile of TILE_H / SMALL_BLOCKS
//   pixel rows x 128 columns reading the whole tile list.  Warp w owns a
//   strip of 128 / warps columns over the sub-tile's rows, a thread 4
//   adjacent pixels of a row (z, and K1's winning row, in registers),
//   stored as one 16-byte vector a plane.
// * One round trip loads the tile's count, its whole list and the
//   hierarchy's superblock bboxes (the block bboxes too where a superblock
//   meets the tile); a second stages the rows by cp.async, STAGE_ROWS at a
//   time with the next chunk in flight: 19 ints (vertices, edges, biases,
//   clamped bbox) and the 3 z coefficients.
// * Each chunk is compacted by a block scan to the admitted rows whose
//   vertices' pixel bbox meets the sub-tile, and each kept row is prepared
//   once: its edge values at the sub-tile's first pixel and their steps a
//   column and a row.  A thread skips a row whose bbox misses its pixels,
//   so a warp skips one that misses its strip.
// * K1 keeps z and the winning row's id, not the colour latches, and
//   resolves each pixel's colour from that row of ti/tf at the end
//   (resolve_winner).
// Admission stays the reference's: a listed row because the list holds
// it, a hierarchy row by its clamped bbox against the whole 32x128 tile
// (tile_overlap), through superblock -> block -> row.  Only then may the
// vertices' pixel bbox, unclamped (raster.vertex_bbox), skip pixels: a
// covered pixel lies in the closed triangle, so in that bbox, and the
// padding rows below the frame get every pixel the whole-tile evaluation
// draws.  Each pixel sees the same rows in the same order (the list
// ascending, then the hierarchy), so both tests keep their bits, -0.0
// against +0.0 included; edge values step in uint32, the bits of edge_fn
// at each pixel.  Bound by bytes (chip_smoke.py small_work): K1's two
// 1920x1088 planes, 16.7 MB written once, and the counts, live list
// entries and admitted rows it reads, 0.0050 ms at 3.35 TB/s; K2d's 4 MB
// plane at 1024x1024 and its reads, 0.0013 ms.  One launch each, 40
// registers, no spill (NVIDIA H100 80GB HBM3, sm_90a).

// K2g keeps the register body (small_scan below, raster_common.cuh
// TileState: one 256-thread block a tile, 16 pixels a thread, 115
// registers): the 13 planes it writes, 109 MB at 1920x1088, bound it
// (0.0327 ms at 3.35 TB/s; 0.0455 ms measured on the 1080p test scene,
// NVIDIA H100 80GB HBM3 at 700 W).

#include <cuda_pipeline.h>

#include "raster_common.cuh"

namespace zr {

constexpr int SMALL_MAX_LIST = 1024;  // raster.SMALL_BIN_MAX_ROWS
// K1's and K2d's hierarchy blocks at most: raster.MAX_RESIDENT_ROWS rows.
constexpr int SMALL_MAX_BLOCKS = 32768 / RASTER_BLOCK;
// K1's and K2d's blocks a tile (zr_small_blocks_per_tile); the sweep
// entries zr_raster_small_blocks and zr_depth_small_blocks take 1, 2, 4 or
// 8.  On the H100 4 was fastest (PERF.md §6).
constexpr int SMALL_BLOCKS = 4;
constexpr int STAGE_ROWS = 64;  // setup rows staged a round trip
// Staged ints a row: vertices, edges, biases and the clamped bbox (a
// hierarchy row's admission).
constexpr int STAGE_I = I_IMAX + 1;
constexpr int PIX_W = 4;  // adjacent pixels a thread
// Pixels a SM should hold, which bounds the registers: 40 a thread at 4
// pixels (6 blocks of 256 threads).
constexpr int SMALL_RESIDENT = 4 * 1536;
static_assert(I_X0 == 0, "staged ints start a setup row");
static_assert(RASTER_BLOCK % STAGE_ROWS == 0, "a block's rows in chunks");

// A sub-tile block of SUB blocks a tile: its pixel rows, warps and
// threads.  Warp w owns the sub-tile's columns [w WC, (w + 1) WC) over
// all its rows, LPR lanes a pixel row (PIX_W adjacent pixels each), so
// that a row whose bbox misses a strip costs that warp nothing; a thread
// owns RPW pixel rows, RPP apart.
template <int SUB>
struct SubTile {
  static_assert(SUB == 1 || SUB == 2 || SUB == 4 || SUB == 8,
                "1, 2, 4 or 8 blocks a tile");
  static constexpr int ROWS = TILE_H / SUB;
  static constexpr int WARPS = ROWS < 8 ? ROWS : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int WC = TILE_W / WARPS;
  static constexpr int LPR = WC / PIX_W;
  static constexpr int RPP = 32 / LPR;
  static constexpr int RPW = ROWS / RPP;
  static_assert(RPP * RPW == ROWS, "the lanes tile the sub-tile");
  static_assert(THREADS >= STAGE_ROWS, "a thread tests a staged row");
};

// The launch bounds' blocks a SM at SUB blocks a tile.
template <int SUB>
constexpr int min_blocks() {
  using T = SubTile<SUB>;
  const int n = SMALL_RESIDENT / (T::THREADS * PIX_W * T::RPW);
  return n > 0 ? n : 1;
}

template <int SUB>
struct SmallSmem {
  int list[SMALL_MAX_LIST];        // the tile's list
  int hit[SMALL_MAX_BLOCKS];       // its hit hierarchy blocks, in order
  int ri[2][STAGE_ROWS][STAGE_I];  // staged rows, double-buffered
  float rf[2][STAGE_ROWS][3];      // and their z coefficients
  // A chunk's kept rows in order, each prepared for the sub-tile: its
  // edge values at the sub-tile's first pixel centre and the bbox, the
  // steps one column right (-8 dy) and its row id, the steps one pixel
  // row down (8 dx), the biases; and its z coefficients.
  int4 prep[STAGE_ROWS][4];
  float4 coef[STAGE_ROWS];
  int scan[SubTile<SUB>::WARPS];
};

// One block's sub-tile state and walk.  K1 (FLAT): the (z, row id) test,
// the colour resolved from the winning row at the end.  K2d: z alone
// under strict-less.
template <bool FLAT, int SUB>
struct SmallBlock {
  using T = SubTile<SUB>;
  using Smem = SmallSmem<SUB>;
  static constexpr int NPIX = PIX_W * T::RPW;  // pixels a thread
  float z[NPIX];
  int key[FLAT ? NPIX : 1];  // K1: the winning row's id
  int row0, col0;  // the sub-tile's first pixel row and column
  int tile_row0;   // the tile's first pixel row
  const int* __restrict__ ti;
  const float* __restrict__ tf;

  __device__ __forceinline__ void init(int tile_row0_, int tile_col0,
                                       int sub, const int* ti_,
                                       const float* tf_) {
    tile_row0 = tile_row0_;
    row0 = tile_row0 + sub * T::ROWS;
    col0 = tile_col0;
    ti = ti_;
    tf = tf_;
#pragma unroll
    for (int k = 0; k < NPIX; ++k) {
      z[k] = 1.0f;
      if constexpr (FLAT) key[k] = INT_MAX32;
    }
  }

  static __device__ __forceinline__ int lane() { return threadIdx.x & 31; }
  // This thread's first pixel column and its pixel row q in the sub-tile.
  static __device__ __forceinline__ int col() {
    return (int)(threadIdx.x >> 5) * T::WC + (lane() % T::LPR) * PIX_W;
  }
  static __device__ __forceinline__ int row(int q) {
    return lane() / T::LPR + q * T::RPP;
  }

  // Staged row r's vertices' pixel bbox in the sub-tile, packed as rows
  // r_lo, r_hi and columns c_lo, c_hi from the sub-tile's origin, a byte
  // each; false where it misses the sub-tile.
  __device__ __forceinline__ bool window(const int* r, uint32_t& box) const {
    const int x0 = r[I_X0], y0 = r[I_Y0], x1 = r[I_X1], y1 = r[I_Y1];
    const int x2 = r[I_X2], y2 = r[I_Y2];
    const int c_lo = max(
        (min(min(x0, x1), x2) + (SUBPIXEL - 1 - HALF)) >> 3, col0);
    const int c_hi = min((max(max(x0, x1), x2) - HALF) >> 3,
                         col0 + TILE_W - 1);
    const int r_lo = max(
        (min(min(y0, y1), y2) + (SUBPIXEL - 1 - HALF)) >> 3, row0);
    const int r_hi = min((max(max(y0, y1), y2) - HALF) >> 3,
                         row0 + T::ROWS - 1);
    box = (uint32_t)(r_lo - row0) | ((uint32_t)(r_hi - row0) << 8) |
          ((uint32_t)(c_lo - col0) << 16) | ((uint32_t)(c_hi - col0) << 24);
    return c_lo <= c_hi && r_lo <= r_hi;
  }

  // Prepared row i of a chunk (raw: its staged STAGE_I ints and 3
  // floats) into s.prep[i]/s.coef[i]: row id t, bbox box.
  __device__ __forceinline__ void prepare(Smem& s, int i, const int* r,
                                          const float* f, int t,
                                          uint32_t box) const {
    const int px = col0 * SUBPIXEL + HALF, py = row0 * SUBPIXEL + HALF;
    const int dx[3] = {r[I_DX0], r[I_DX1], r[I_DX2]};
    const int dy[3] = {r[I_DY0], r[I_DY1], r[I_DY2]};
    const int ex[3] = {r[I_X1], r[I_X2], r[I_X0]};
    const int ey[3] = {r[I_Y1], r[I_Y2], r[I_Y0]};
    int e[3], cs[3], rs[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e[k] = edge_fn(dx[k], dy[k], ex[k], ey[k], px, py);
      cs[k] = (int)(0u - (uint32_t)dy[k] * (uint32_t)SUBPIXEL);
      rs[k] = (int)((uint32_t)dx[k] * (uint32_t)SUBPIXEL);
    }
    s.prep[i][0] = make_int4(e[0], e[1], e[2], (int)box);
    s.prep[i][1] = make_int4(cs[0], cs[1], cs[2], t);
    s.prep[i][2] = make_int4(rs[0], rs[1], rs[2], 0);
    s.prep[i][3] = make_int4(r[I_BIAS0], r[I_BIAS1], r[I_BIAS2], 0);
    s.coef[i] = make_float4(f[0], f[1], f[2], 0.0f);
  }

  // Coverage, depth test and latch (z; K1 the row id too) of prepared row i
  // at this thread's pixels inside its bbox.  A pixel's edge values step
  // from the sub-tile's first pixel in uint32 (the bits of edge_fn there).
  __device__ __forceinline__ void eval(const Smem& s, int i) {
    const int4 o = s.prep[i][0];
    const uint32_t box = (uint32_t)o.w;
    const int r_lo = box & 0xff, r_hi = (box >> 8) & 0xff;
    const int c_lo = (box >> 16) & 0xff, c_hi = box >> 24;
    const int c = col();
    if (c + PIX_W - 1 < c_lo || c > c_hi) return;  // a whole strip's too
    const int4 cs = s.prep[i][1], rs = s.prep[i][2], bias = s.prep[i][3];
    const float4 zc = s.coef[i];
    const int t = cs.w;
#pragma unroll
    for (int q = 0; q < T::RPW; ++q) {
      const int lr = row(q);
      if (lr < r_lo || lr > r_hi) continue;
      int e0 = (int)((uint32_t)o.x + (uint32_t)lr * (uint32_t)rs.x +
                     (uint32_t)c * (uint32_t)cs.x);
      int e1 = (int)((uint32_t)o.y + (uint32_t)lr * (uint32_t)rs.y +
                     (uint32_t)c * (uint32_t)cs.y);
      int e2 = (int)((uint32_t)o.z + (uint32_t)lr * (uint32_t)rs.z +
                     (uint32_t)c * (uint32_t)cs.z);
#pragma unroll
      for (int p = 0; p < PIX_W; ++p) {
        if (p) {
          e0 = (int)((uint32_t)e0 + (uint32_t)cs.x);
          e1 = (int)((uint32_t)e1 + (uint32_t)cs.y);
          e2 = (int)((uint32_t)e2 + (uint32_t)cs.z);
        }
        if (e0 < bias.x || e1 < bias.y || e2 < bias.z) continue;
        const float f0 = __int2float_rn(e0);
        const float f1 = __int2float_rn(e1);
        const float f2 = __int2float_rn(e2);
        const float zz = interp3(f0, f1, f2, zc.x, zc.y, zc.z);
        const int k = q * PIX_W + p;
        if constexpr (FLAT) {
          if (zz >= 0.0f && (zz < z[k] || (zz == z[k] && t < key[k]))) {
            z[k] = zz;
            key[k] = t;
          }
        } else {
          if (zz >= 0.0f && zz < z[k]) z[k] = zz;
        }
      }
    }
  }

  // Row k of a tile's run: the first n_list rows are its list's, then
  // come the hit hierarchy blocks' rows, RASTER_BLOCK a block.
  static __device__ __forceinline__ int run_row(const Smem& s, int n_list,
                                                int k) {
    return k < n_list ? s.list[k]
                      : s.hit[(k - n_list) / RASTER_BLOCK] * RASTER_BLOCK +
                            (k - n_list) % RASTER_BLOCK;
  }

  // Rows [k0, k0 + n) of the run staged into buffer buf: one commit.
  __device__ __forceinline__ void stage(Smem& s, int n_list, int buf, int k0,
                                        int n) const {
    for (int w = threadIdx.x; w < n * STAGE_I; w += T::THREADS) {
      const int j = w / STAGE_I, c = w - j * STAGE_I;
      const size_t t = run_row(s, n_list, k0 + j);
      __pipeline_memcpy_async(&s.ri[buf][j][c], ti + t * NI32 + c, 4);
    }
    for (int w = threadIdx.x; w < n * 3; w += T::THREADS) {
      const int j = w / 3, c = w - j * 3;
      const size_t t = run_row(s, n_list, k0 + j);
      __pipeline_memcpy_async(&s.rf[buf][j][c], tf + t * NF32 + F_ZA0 + c,
                              4);
    }
    __pipeline_commit();
  }

  // The tile's run of n rows in order, STAGE_ROWS staged at a time with
  // the next chunk in flight: its list's first n_list rows, admitted by
  // the list, then its hit hierarchy blocks' rows, each admitted by its
  // clamped bbox against the whole tile.  Each chunk is compacted by a
  // block scan to the admitted rows whose vertices' pixel bbox meets the
  // sub-tile, then evaluated.  Every thread calls it.
  __device__ __forceinline__ void run(Smem& s, int n_list, int n) {
    const int chunks = (n + STAGE_ROWS - 1) / STAGE_ROWS;
    if (chunks > 0) stage(s, n_list, 0, 0, min(n, STAGE_ROWS));
    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = ch * STAGE_ROWS, m = min(n - k0, STAGE_ROWS);
      if (ch + 1 < chunks) {
        stage(s, n_list, (ch + 1) & 1, k0 + STAGE_ROWS,
              min(n - k0 - STAGE_ROWS, STAGE_ROWS));
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const int buf = ch & 1, j = threadIdx.x;
      uint32_t box = 0;
      bool keep = false;
      if (j < m) {
        const int* r = s.ri[buf][j];
        keep = window(r, box) &&
               (k0 + j < n_list ||
                tile_overlap(r[I_JMIN], r[I_JMAX], r[I_IMIN], r[I_IMAX],
                             tile_row0, col0));
      }
      int kept;
      const int pos =
          block_exclusive_scan<T::WARPS>(keep ? 1 : 0, s.scan, kept);
      if (keep)
        prepare(s, pos, s.ri[buf][j], s.rf[buf][j],
                run_row(s, n_list, k0 + j), box);
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kept; ++i) eval(s, i);
      __syncthreads();
    }
  }

  // The hierarchy blocks that the walk reaches in this tile, in order,
  // into s.hit: block b where its superblock's and its own bbox meet the
  // whole tile.  Each warp first tests the superblocks by a ballot; where
  // one meets the tile, each thread tests whole blocks, both levels
  // loaded together.  Returns their count.
  __device__ __forceinline__ int hit_blocks(Smem& s,
                                            const int* __restrict__ supers,
                                            int num_supers,
                                            const int* __restrict__ blocks)
      const {
    bool any = false;
    for (int s0 = 0; s0 < num_supers && !any; s0 += 32) {
      const int* sb = supers + (size_t)(s0 + lane()) * 8;
      any = __any_sync(0xffffffffu,
                       s0 + lane() < num_supers &&
                           tile_overlap(__ldg(sb), __ldg(sb + 1),
                                        __ldg(sb + 2), __ldg(sb + 3),
                                        tile_row0, col0));
    }
    if (!any) return 0;
    const int num_blocks = num_supers * SUPER_BLOCK;
    int hits = 0;
    for (int b0 = 0; b0 < num_blocks; b0 += T::THREADS) {
      const int b = b0 + (int)threadIdx.x;
      bool hit = false;
      if (b < num_blocks) {
        const int* sb = supers + (size_t)(b / SUPER_BLOCK) * 8;
        const int* bb = blocks + (size_t)b * 8;
        hit = tile_overlap(__ldg(sb), __ldg(sb + 1), __ldg(sb + 2),
                           __ldg(sb + 3), tile_row0, col0) &&
              tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2),
                           __ldg(bb + 3), tile_row0, col0);
      }
      int count;
      const int pos = block_exclusive_scan<T::WARPS>(hit ? 1 : 0, s.scan,
                                                     count);
      if (hit) s.hit[hits + pos] = b;
      hits += count;
    }
    return hits;
  }

  // K1's store: each pixel's colour resolved from its winning row of
  // ti/tf (resolve_winner: one IEEE divide, RGBA8 packed, alpha 255; the
  // values a latch would have kept, as they are functions of (row,
  // pixel)), z as the test left it; 16 bytes a plane a pixel row.
  __device__ __forceinline__ void store(int* __restrict__ color,
                                        float* __restrict__ depth,
                                        int width) const {
#pragma unroll
    for (int q = 0; q < T::RPW; ++q) {
      const int lr = row(q), c = col();
      int c4[PIX_W];
      float z4[PIX_W];
#pragma unroll
      for (int p = 0; p < PIX_W; ++p)
        resolve_winner<true, false>(ti, tf, key[q * PIX_W + p],
                                    z[q * PIX_W + p],
                                    (col0 + c + p) * SUBPIXEL + HALF,
                                    (row0 + lr) * SUBPIXEL + HALF, c4, z4,
                                    nullptr, p, 0);
      const size_t idx = (size_t)(row0 + lr) * width + col0 + c;
      *reinterpret_cast<int4*>(color + idx) =
          make_int4(c4[0], c4[1], c4[2], c4[3]);
      *reinterpret_cast<float4*>(depth + idx) =
          make_float4(z4[0], z4[1], z4[2], z4[3]);
    }
  }

  __device__ __forceinline__ void store_depth(float* __restrict__ depth,
                                              int width) const {
#pragma unroll
    for (int q = 0; q < T::RPW; ++q) {
      const size_t idx = (size_t)(row0 + row(q)) * width + col0 + col();
      *reinterpret_cast<float4*>(depth + idx) =
          make_float4(z[q * PIX_W], z[q * PIX_W + 1], z[q * PIX_W + 2],
                      z[q * PIX_W + 3]);
    }
  }
};

// K1's and K2d's body: block b rasterizes sub-tile b % SUB of tile b /
// SUB.  Its first round trip loads the count, the whole list (n_head
// entries, whatever the count) and the superblock bboxes together (the
// block bboxes follow where a superblock meets the tile); then one run
// over the list's rows and the hit blocks'.
template <bool FLAT, int SUB>
__device__ __forceinline__ void small_tile(
    SmallSmem<SUB>& s, SmallBlock<FLAT, SUB>& st,
    const int* __restrict__ counts, const int* __restrict__ lists, int n_head,
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int width) {
  using T = SubTile<SUB>;
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x / SUB;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W,
          blockIdx.x % SUB, ti, tf);
  const int* lst = lists + (size_t)tile * n_head;
  const int n = __ldg(counts + tile);
#pragma unroll 4
  for (int k = threadIdx.x; k < n_head; k += T::THREADS)
    s.list[k] = __ldg(lst + k);
  const int hits = st.hit_blocks(s, supers, num_supers, blocks);
  __syncthreads();
  st.run(s, n, n + hits * RASTER_BLOCK);
}

template <int SUB>
__global__ void __launch_bounds__(SubTile<SUB>::THREADS,
                                  min_blocks<SUB>())
    raster_small_kernel(const int* __restrict__ counts,
                        const int* __restrict__ lists, int n_head,
                        const int* __restrict__ supers, int num_supers,
                        const int* __restrict__ blocks,
                        const int* __restrict__ ti,
                        const float* __restrict__ tf, int* __restrict__ color,
                        float* __restrict__ depth, int width) {
  __shared__ SmallSmem<SUB> s;
  SmallBlock<true, SUB> st;
  small_tile(s, st, counts, lists, n_head, supers, num_supers, blocks, ti, tf,
             width);
  st.store(color, depth, width);
}

template <int SUB>
__global__ void __launch_bounds__(SubTile<SUB>::THREADS,
                                  min_blocks<SUB>())
    depth_small_kernel(const int* __restrict__ counts,
                       const int* __restrict__ lists, int n_head,
                       const int* __restrict__ supers, int num_supers,
                       const int* __restrict__ blocks,
                       const int* __restrict__ ti,
                       const float* __restrict__ tf,
                       float* __restrict__ depth, int width) {
  __shared__ SmallSmem<SUB> s;
  SmallBlock<false, SUB> st;
  small_tile(s, st, counts, lists, n_head, supers, num_supers, blocks, ti, tf,
             width);
  st.store_depth(depth, width);
}

// K2g: the register body, one block a tile.  Phase 1 (the tile's list)
// and phase 2 (the fan-tail hierarchy).
template <class State>
__device__ __forceinline__ void small_scan(
    State& st, const int* __restrict__ counts, const int* __restrict__ lists,
    int n_head, const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int width) {
  __shared__ int s_list[SMALL_MAX_LIST];
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  const int n = counts[tile];
  const int* lst = lists + (size_t)tile * n_head;
  for (int k = threadIdx.x; k < n; k += THREADS) s_list[k] = lst[k];
  __syncthreads();

  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  for (int k = 0; k < n; ++k) st.eval(ti, tf, s_list[k]);
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
}

__global__ void __launch_bounds__(THREADS)
    gbuffer_small_kernel(const int* __restrict__ counts,
                         const int* __restrict__ lists, int n_head,
                         const int* __restrict__ supers, int num_supers,
                         const int* __restrict__ blocks,
                         const int* __restrict__ ti,
                         const float* __restrict__ tf,
                         float* __restrict__ out, int width, int height) {
  TileState st;
  small_scan(st, counts, lists, n_head, supers, num_supers, blocks, ti, tf,
             width);
  st.store_gbuffer<true>(ti, tf, out, width, (size_t)width * height);
}

// K1's and K2d's launches at SUB blocks a tile.
template <int SUB>
cudaError_t launch_small(const int* counts, const int* lists, int n_head,
                         const int* supers, int num_supers,
                         const int* blocks, const int* ti, const float* tf,
                         int* color, float* depth, int num_tiles, int width,
                         cudaStream_t stream) {
  const int grid = num_tiles * SUB;
  if (color != nullptr) {
    raster_small_kernel<SUB><<<grid, SubTile<SUB>::THREADS, 0, stream>>>(
        counts, lists, n_head, supers, num_supers, blocks, ti, tf, color,
        depth, width);
  } else {
    depth_small_kernel<SUB><<<grid, SubTile<SUB>::THREADS, 0, stream>>>(
        counts, lists, n_head, supers, num_supers, blocks, ti, tf, depth,
        width);
  }
  return cudaGetLastError();
}

// K1 (color given) or K2d (color null) at blocks_per_tile blocks a tile:
// 1, 2, 4 or 8.  The planes' rows are stored 16 bytes at a time, so both
// must be 16-byte aligned.
inline int small_blocks(int blocks_per_tile, const int* counts,
                        const int* lists, int n_head, const int* supers,
                        int num_supers, const int* blocks, const int* ti,
                        const float* tf, int* color, float* depth,
                        int height, int width, void* stream) {
  if (n_head > SMALL_MAX_LIST || num_supers * SUPER_BLOCK > SMALL_MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)color | (uintptr_t)depth) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int num_tiles = (height / TILE_H) * (width / TILE_W);
  const auto st = (cudaStream_t)stream;
  switch (blocks_per_tile) {
    case 1:
      return (int)launch_small<1>(counts, lists, n_head, supers, num_supers,
                                  blocks, ti, tf, color, depth, num_tiles,
                                  width, st);
    case 2:
      return (int)launch_small<2>(counts, lists, n_head, supers, num_supers,
                                  blocks, ti, tf, color, depth, num_tiles,
                                  width, st);
    case 4:
      return (int)launch_small<4>(counts, lists, n_head, supers, num_supers,
                                  blocks, ti, tf, color, depth, num_tiles,
                                  width, st);
    case 8:
      return (int)launch_small<8>(counts, lists, n_head, supers, num_supers,
                                  blocks, ti, tf, color, depth, num_tiles,
                                  width, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace zr

extern "C" int zr_raster_small(const int* counts, const int* lists,
                               int n_head, const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, int* color, float* depth,
                               int height, int width, void* stream) {
  return zr::small_blocks(zr::SMALL_BLOCKS, counts, lists, n_head, supers,
                          num_supers, blocks, ti, tf, color, depth, height,
                          width, stream);
}

extern "C" int zr_gbuffer_small(const int* counts, const int* lists,
                                int n_head, const int* supers,
                                int num_supers, const int* blocks,
                                const int* ti, const float* tf, float* out,
                                int height, int width, void* stream) {
  if (n_head > zr::SMALL_MAX_LIST) return (int)cudaErrorInvalidValue;
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::gbuffer_small_kernel<<<num_tiles, zr::THREADS, 0,
                             (cudaStream_t)stream>>>(
      counts, lists, n_head, supers, num_supers, blocks, ti, tf, out, width,
      height);
  return (int)cudaGetLastError();
}

// K2d.
extern "C" int zr_depth_small(const int* counts, const int* lists, int n_head,
                              const int* supers, int num_supers,
                              const int* blocks, const int* ti,
                              const float* tf, float* depth, int height,
                              int width, void* stream) {
  return zr::small_blocks(zr::SMALL_BLOCKS, counts, lists, n_head, supers,
                          num_supers, blocks, ti, tf, nullptr, depth, height,
                          width, stream);
}

// K1's and K2d's blocks a tile.
extern "C" int zr_small_blocks_per_tile() { return zr::SMALL_BLOCKS; }

// K1 and K2d at another count of blocks a tile (the sweep's entries).
extern "C" int zr_raster_small_blocks(int blocks_per_tile, const int* counts,
                                      const int* lists, int n_head,
                                      const int* supers, int num_supers,
                                      const int* blocks, const int* ti,
                                      const float* tf, int* color,
                                      float* depth, int height, int width,
                                      void* stream) {
  if (color == nullptr) return (int)cudaErrorInvalidValue;
  return zr::small_blocks(blocks_per_tile, counts, lists, n_head, supers,
                          num_supers, blocks, ti, tf, color, depth, height,
                          width, stream);
}

extern "C" int zr_depth_small_blocks(int blocks_per_tile, const int* counts,
                                     const int* lists, int n_head,
                                     const int* supers, int num_supers,
                                     const int* blocks, const int* ti,
                                     const float* tf, float* depth,
                                     int height, int width, void* stream) {
  return zr::small_blocks(blocks_per_tile, counts, lists, n_head, supers,
                          num_supers, blocks, ti, tf, nullptr, depth, height,
                          width, stream);
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
