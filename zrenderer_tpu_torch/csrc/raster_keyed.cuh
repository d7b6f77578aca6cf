// The keyed raster body, shared by raster_binned.cu (K4, K4c, K4g, K4d,
// K9, K9d, K6, K6g, K6d: a tile's record spans, K4c's coarse bin too, then
// the leftover rows of the hierarchy), raster_hier.cu (K3, K3b, K3g, K3d,
// K5, K5g: the hierarchy alone), raster_twoclass.cu (K10hbm2, K10scan:
// the hierarchies of two views of the rows, one key plane),
// raster_vis.cu (K10vis, K10trans: the hierarchy with 8-row group
// admission, the depth and row id planes), raster_vec.cu (K10vec, K10vecg:
// the hierarchy with 32-row subgroup admission, each row's window cut to
// its subgroup's hit 8-row chunks, the winner read from its 72-lane
// record) and raster_group8.cu (K10g8, K10g8g, K10g8d: 32x128 key tiles of
// four 8x128 list tiles, the list entries' rows read by id, each window
// cut to its list tile, then the leftover hierarchy's hit blocks).  The
// register body (raster_common.cuh TileState) serves K2g and K9g.
//
// * One 64-bit key a pixel in shared memory (32 KB a tile), lowered by
//   atomicMin.  K4, K4c, K9, K9d, K6, K4g, K6g, K10g8 and K10g8g: (order
//   bits of z, row id), whose minimum is the (z, row id) tie-break.  K3,
//   K3b, K3g, K5, K5g, K10vec and K10vecg: the same key, whose minimum is
//   the strict-less test z >= 0 && z < zb from 1.0 in row order (the first
//   row of the least z wins, and prepare_raster_inputs compacts stably, so
//   a row's id is its submission order).  K4d, K6d, K3d, K10vis, K10trans
//   and K10g8d: (order bits of z, visit index, sign of z), whose minimum is
//   the strict-less test in visit order with the first visited row kept:
//   a span entry's visit index is its index in the span list, a leftover
//   row's is the span's end plus its row id (K3d, K10vis, K10trans: no
//   span, so its row id; K10g8d: the key tile's four spans laid end to
//   end).
//   -0.0 and +0.0 share order bits; z >= 0 filters first (NaN and negative
//   z never compete).  The clear key is z 1.0 over the largest id for K4,
//   K4c, K9, K9d, K6, K4g, K6g, K10g8 and K10g8g, so that a row at z ==
//   1.0 latches as the (z, row id) test lets it; over id 0 (over visit 0)
//   for K3, K3b, K3g, K5, K5g, K10vec and K10vecg (K3d, K4d, K6d, K10vis,
//   K10trans, K10g8d), which no row at z == 1.0 goes below, as the
//   strict-less test never lets 1.0 pass.
// * Work in proportion to each row's window: its vertices' pixel bbox in
//   the tile.  A pixel a row covers lies in the closed triangle (exact int32
//   edge functions inside the guard band), so in that bbox, wherever the
//   bbox columns were clamped: the padding rows get every pixel the
//   whole-tile evaluation drew.  A batch of up to KEY_BATCH rows is
//   flattened into (row, pixel) evaluations that the 256 threads take in
//   turn (a prefix sum over the windows' areas, a binary search a thread),
//   so a row that covers the tile and one of 3 pixels share the block
//   alike.  The edge functions step from the window's origin (int32 wrap,
//   the same bits as edge_fn), then the same bias tests and interp3.
// * The hierarchy walk: superblock -> block -> row bbox skips, as the
//   register body's (keyed_leftovers; raster_hier.cu's and
//   raster_twoclass.cu's kernels read each tile's hit words, written once
//   a call: tile_hit_words, walk_hit_blocks), a hit block's 128 row
//   bboxes tested by 128 threads at once (keyed_block_rows) and the hit
//   rows compacted into batches.  A row is admitted by its clamped bbox
//   (tile_overlap): a row whose bbox clamped to empty is skipped, as
//   before.
// * Several work items of one tile merge their keys by atomicMin into a
//   key plane of the output's size (8 bytes a pixel, set to all ones by a
//   memset), and a second kernel resolves the plane's minimum, which is
//   order-free; a tile of one item resolves its keys in place.
// * A band (K3b, K9, K9d): tiles, windows and edge functions use global rows;
//   the planes and the key plane are the band's, a pixel of global row r
//   stored at row r - row_base (keyed_out, resolve_tile).
// The store re-evaluates the winner from the setup rows through
// raster_common.cuh's resolve_winner, the register bodies' epilogue: K4,
// K4c, K9, K9d, K6, K4g, K6g, K3, K3b, K3g, K5 and K5g their z (-0.0 kept)
// and colour, K4g, K6g, K3g and K5g also the 11 further planes (K4g, K6g,
// K5g and K10g8g buf * (covered ? 1/den : 0), K3g and K10vecg covered ?
// buf * 1/den : 0);
// K4d, K6d, K3d and K10g8d decode z from the key, K10vis and K10trans z
// and the row id.  Nothing moves the tensor cores.
#pragma once

#include <cuda_pipeline.h>

#include "raster_common.cuh"

namespace zr {

constexpr int REC_I = NI32 + 1;  // record ints: the setup row + its row id
constexpr int SUBPIXEL_BITS = 3;
static_assert(1 << SUBPIXEL_BITS == SUBPIXEL, "SUBPIXEL is 8");
constexpr int TILE_PIX = TILE_H * TILE_W;  // keys a tile
constexpr int KEY_BATCH = 128;             // rows flattened together
constexpr int KEY_PENDING = 2 * KEY_BATCH;  // leftover rows awaiting a batch
constexpr int WARPS = THREADS / 32;
constexpr int HIT_WORDS = 32;  // hit words a hierarchy item holds at once
static_assert(KEY_BATCH == RASTER_BLOCK, "a block's rows fit one batch");
static_assert(KEY_BATCH <= THREADS, "one thread prepares a record");
static_assert(HIT_WORDS <= THREADS, "a thread loads a word");

// The (order bits of z, row id) key (the sign cleared, so -0.0 ties +0.0).
// A span record's id is its last int (a row-id entry's row id, staged
// there), a leftover row's its index in the setup rows.  The store
// resolves the pixel at global (row, col), element idx of the planes, from
// its key: the winner re-evaluated from ti/tf by raster_common.cuh's
// resolve_winner, z included (its -0.0 kept), one IEEE divide, RGBA8
// packed; z 1.0 and alpha alone where no row latched.
// PLANES: also the 11 further G-buffer planes from extra, frame floats
// apart.  STRICT_CLEAR (K3, K3b, K3g, K5, K5g): the clear key (1.0, 0), the
// strict-less test's; otherwise (K4, K4c, K9, K9d, K6, K4g, K6g) (1.0,
// INT32_MAX).  MASKED_INV (K4g, K6g, K5g): the epilogue buf * (covered ?
// 1/den : 0); otherwise (K3g) covered ? buf * 1/den : 0.  Without PLANES
// the two epilogues are one: the colour's quantize is the same either
// way.
template <bool PLANES, bool STRICT_CLEAR, bool MASKED_INV>
struct WinnerKeys {
  static constexpr unsigned long long CLEAR =
      (0x3f800000ull << 32) |
      (STRICT_CLEAR ? 0ull : (unsigned long long)INT_MAX32);
  static __device__ __forceinline__ uint32_t span_tag(const int* r, int) {
    return (uint32_t)r[NI32];
  }
  static __device__ __forceinline__ uint32_t row_tag(int t, int) {
    return (uint32_t)t;
  }
  // A list entry naming setup row t, at visit index q (raster_group8.cu).
  static __device__ __forceinline__ uint32_t entry_tag(int t, int) {
    return (uint32_t)t;
  }
  static __device__ __forceinline__ unsigned long long key(uint32_t zbits,
                                                           uint32_t tag) {
    return ((unsigned long long)(zbits & 0x7fffffffu) << 32) | tag;
  }
  static __device__ __forceinline__ void store(
      unsigned long long k, int row, int col, const int* __restrict__ ti,
      const float* __restrict__ tf, int* __restrict__ color,
      float* __restrict__ depth, float* __restrict__ extra, size_t idx,
      size_t frame) {
    resolve_winner<MASKED_INV, PLANES, true>(
        ti, tf, k == CLEAR ? INT_MAX32 : (int)(uint32_t)k, 1.0f,
        col * SUBPIXEL + HALF, row * SUBPIXEL + HALF, color, depth, extra,
        idx, frame);
  }
};
// K10g8 and K10g8g take FlatKeys and GbufKeys too (raster_group8.cu).
using FlatKeys = WinnerKeys<false, false, true>;  // K4, K4c, K9, K9d, K6
using GbufKeys = WinnerKeys<true, false, true>;   // K4g, K6g
using HierFlatKeys = WinnerKeys<false, true, false>;  // K3, K3b, K5
using HierGbufKeys = WinnerKeys<true, true, false>;   // K3g
using HbmGbufKeys = WinnerKeys<true, true, true>;     // K5g

// The depth key (K4d, K6d, K3d, K10g8d; K10vis and K10trans, raster_vis.cu
// VisKeys): the order bits of z over the visit index over the sign of z.
// The visit index of span entry k is k; of leftover row t, the span's end
// plus t (K3d, K10vis, K10trans: t): both below 2^31, so the key holds
// them shifted by one.
struct DepthKeys {
  static constexpr unsigned long long CLEAR = 0x3f800000ull << 32;
  static __device__ __forceinline__ uint32_t span_tag(const int*, int k) {
    return (uint32_t)k;
  }
  static __device__ __forceinline__ uint32_t row_tag(int t, int span_end) {
    return (uint32_t)(span_end + t);
  }
  static __device__ __forceinline__ uint32_t entry_tag(int, int q) {
    return (uint32_t)q;
  }
  static __device__ __forceinline__ unsigned long long key(uint32_t zbits,
                                                           uint32_t tag) {
    return ((unsigned long long)(zbits & 0x7fffffffu) << 32) |
           ((unsigned long long)tag << 1) | (zbits >> 31);
  }
  static __device__ __forceinline__ void store(
      unsigned long long k, int, int, const int* __restrict__,
      const float* __restrict__, int* __restrict__, float* __restrict__ depth,
      float* __restrict__, size_t idx, size_t) {
    const uint32_t bits = (uint32_t)(k >> 32) | ((uint32_t)k << 31);
    depth[idx] = k == CLEAR ? 1.0f : __uint_as_float(bits);
  }
};

// Shared memory of one work item (dynamic; the record kernels add their
// record staging, raster_binned.cu KeyedSpanSmem).
struct KeyedSmem {
  unsigned long long key[TILE_PIX];
  // The batch, one column a row: edge values at the window's origin,
  // their steps a column and a row, biases, z coefficients, the origin's
  // pixel in the tile, the window's width and its reciprocal, the key's tag.
  int e[3][KEY_BATCH], cstep[3][KEY_BATCH], rstep[3][KEY_BATCH];
  int bias[3][KEY_BATCH];
  float za[3][KEY_BATCH];
  int origin[KEY_BATCH], wide[KEY_BATCH];
  float inv_wide[KEY_BATCH];
  uint32_t tag[KEY_BATCH];
  int prefix[KEY_BATCH + 1];  // evaluations before each row
  int pending[KEY_PENDING];
  int scan[WARPS];
  int item[3];  // tile, item index within the tile, items of the tile
  // The hierarchy walk's words of hit blocks, a bit each, HIT_WORDS
  // superblocks' words at a time (walk_hit_blocks).
  unsigned hits[HIT_WORDS];
};

// Batch column j's window: its origin (dr, dc) in the tile, its width w
// and the key's tag (the edge values, steps, biases and z coefficients
// are the caller's to stage).
__device__ __forceinline__ void stage_origin(KeyedSmem& s, int j, int dr,
                                             int dc, int w, uint32_t tag) {
  s.origin[j] = dr * TILE_W + dc;
  s.wide[j] = w;
  s.inv_wide[j] = __fdiv_rn(1.0f, __int2float_rn(w));
  s.tag[j] = tag;
}

// Batch column j from setup row r (NI32 ints) and its z coefficients zc:
// the window (the vertices' pixel bbox in the tile, within tile rows
// [rows_lo, rows_lo + rows_n); the two-class kernels' short rows take 8
// of them), the edge values at its origin and their steps.  Returns the
// window's area (0: empty).
__device__ __forceinline__ int prepare_record(KeyedSmem& s, int j,
                                              const int* r, const float* zc,
                                              uint32_t tag, int row0,
                                              int col0, int rows_lo = 0,
                                              int rows_n = TILE_H) {
  const int x0 = r[I_X0], y0 = r[I_Y0], x1 = r[I_X1], y1 = r[I_Y1];
  const int x2 = r[I_X2], y2 = r[I_Y2];
  const int c_lo =
      max((min(min(x0, x1), x2) + (SUBPIXEL - 1 - HALF)) >> SUBPIXEL_BITS,
          col0);
  const int c_hi =
      min((max(max(x0, x1), x2) - HALF) >> SUBPIXEL_BITS, col0 + TILE_W - 1);
  const int r_lo =
      max((min(min(y0, y1), y2) + (SUBPIXEL - 1 - HALF)) >> SUBPIXEL_BITS,
          row0 + rows_lo);
  const int r_hi = min((max(max(y0, y1), y2) - HALF) >> SUBPIXEL_BITS,
                       row0 + rows_lo + rows_n - 1);
  const int w = c_hi - c_lo + 1, h = r_hi - r_lo + 1;
  if (w <= 0 || h <= 0) return 0;
  const int px = c_lo * SUBPIXEL + HALF, py = r_lo * SUBPIXEL + HALF;
  const int dx[3] = {r[I_DX0], r[I_DX1], r[I_DX2]};
  const int dy[3] = {r[I_DY0], r[I_DY1], r[I_DY2]};
  const int ex[3] = {x1, x2, x0}, ey[3] = {y1, y2, y0};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.e[i][j] = edge_fn(dx[i], dy[i], ex[i], ey[i], px, py);
    s.cstep[i][j] = (int)(0u - (uint32_t)dy[i] * (uint32_t)SUBPIXEL);
    s.rstep[i][j] = (int)((uint32_t)dx[i] * (uint32_t)SUBPIXEL);
    s.bias[i][j] = r[I_BIAS0 + i];
    s.za[i][j] = zc[i];
  }
  stage_origin(s, j, r_lo - row0, c_lo - col0, w, tag);
  return w * h;
}

// Every (row, pixel) of the prepared batch, threads striding over the
// flattened evaluations; area is this thread's row's (0 for threads that
// prepared none).  Pixel q of a window of width w is row q / w, column q %
// w: floor((q + 0.5) / w) by one rounded product, exact as the quotient's
// fraction stays 0.5 / w from an integer and q < 4096.
template <class Mode>
__device__ __forceinline__ void eval_batch(KeyedSmem& s, int area) {
  int total;
  const int before = block_exclusive_scan(area, s.scan, total);
  if (threadIdx.x < KEY_BATCH) s.prefix[threadIdx.x] = before;
  if (threadIdx.x == 0) s.prefix[KEY_BATCH] = total;
  __syncthreads();
  int k = 0;
  for (int f = threadIdx.x; f < total; f += THREADS) {
    if (f >= s.prefix[k + 1]) {  // the last row whose prefix <= f
      int lo = k;
#pragma unroll
      for (int step = KEY_BATCH / 2; step > 0; step >>= 1)
        if (lo + step < KEY_BATCH && s.prefix[lo + step] <= f) lo += step;
      k = lo;
    }
    const int q = f - s.prefix[k];
    const int w = s.wide[k];
    const int dr = __float2int_rz(
        __fmul_rn(__fadd_rn(__int2float_rn(q), 0.5f), s.inv_wide[k]));
    const int dc = q - dr * w;
    int e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      e[i] = (int)((uint32_t)s.e[i][k] +
                   (uint32_t)dr * (uint32_t)s.rstep[i][k] +
                   (uint32_t)dc * (uint32_t)s.cstep[i][k]);
    if (e[0] < s.bias[0][k] || e[1] < s.bias[1][k] || e[2] < s.bias[2][k])
      continue;
    const float z = interp3(__int2float_rn(e[0]), __int2float_rn(e[1]),
                            __int2float_rn(e[2]), s.za[0][k], s.za[1][k],
                            s.za[2][k]);
    if (!(z >= 0.0f)) continue;
    const unsigned long long key = Mode::key(__float_as_uint(z), s.tag[k]);
    unsigned long long* slot = &s.key[s.origin[k] + dr * TILE_W + dc];
    if (key < *slot) atomicMin(slot, key);
  }
  __syncthreads();
}

// The first n rows of s.pending as one batch, read from ti/tf.
template <class Mode>
__device__ __forceinline__ void flush_rows(KeyedSmem& s, int n,
                                           const int* __restrict__ ti,
                                           const float* __restrict__ tf,
                                           int span_end, int row0, int col0) {
  int area = 0;
  const int j = threadIdx.x;
  if (j < n) {
    const int t = s.pending[j];
    area = prepare_record(s, j, ti + (size_t)t * NI32,
                          tf + (size_t)t * NF32 + F_ZA0,
                          Mode::row_tag(t, span_end), row0, col0);
  }
  eval_batch<Mode>(s, area);
}

// This thread's entry, where hit, appended to s.pending after the
// pending ones (in thread order); once KEY_BATCH wait, flush(KEY_BATCH)
// evaluates the first KEY_BATCH as one batch.  pending is block-uniform.
template <class Flush>
__device__ __forceinline__ void keyed_pend(KeyedSmem& s, bool hit, int entry,
                                           int& pending, Flush&& flush) {
  int hits;
  const int pos = block_exclusive_scan(hit ? 1 : 0, s.scan, hits);
  if (hit) s.pending[pending + pos] = entry;
  pending += hits;
  if (pending >= KEY_BATCH) {
    __syncthreads();
    flush(KEY_BATCH);
    const int rest = pending - KEY_BATCH;
    if ((int)threadIdx.x < rest)
      s.pending[threadIdx.x] = s.pending[KEY_BATCH + threadIdx.x];
    pending = rest;
  }
}

// The rows of hit block b (its bbox meets the tile): tested by the first
// 128 threads at once, the hits compacted into s.pending (keyed_pend).
template <class Mode>
__device__ __forceinline__ void keyed_block_rows(
    KeyedSmem& s, int b, int& pending, const int* __restrict__ ti,
    const float* __restrict__ tf, int span_end, int row0, int col0) {
  const int t = b * RASTER_BLOCK + (int)threadIdx.x;
  bool hit = false;
  if (threadIdx.x < RASTER_BLOCK) {
    const int* r = ti + (size_t)t * NI32;
    hit = tile_overlap(__ldg(r + I_JMIN), __ldg(r + I_JMAX),
                       __ldg(r + I_IMIN), __ldg(r + I_IMAX), row0, col0);
  }
  keyed_pend(s, hit, t, pending, [&](int n) {
    flush_rows<Mode>(s, n, ti, tf, span_end, row0, col0);
  });
}

// The pending rows left after a walk, as one batch.
template <class Mode>
__device__ __forceinline__ void flush_pending(KeyedSmem& s, int pending,
                                              const int* __restrict__ ti,
                                              const float* __restrict__ tf,
                                              int span_end, int row0,
                                              int col0) {
  if (pending > 0) {
    __syncthreads();
    flush_rows<Mode>(s, pending, ti, tf, span_end, row0, col0);
  }
}

// The rows of superblocks [s_begin, s_end) through the superblock -> block
// -> row bbox walk, one superblock and block after another, each hit
// block's rows by keyed_block_rows.
template <class Mode>
__device__ __forceinline__ void keyed_leftovers(
    KeyedSmem& s, const int* __restrict__ supers, int s_begin, int s_end,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int span_end, int row0, int col0) {
  int pending = 0;  // block-uniform
  for (int sb = s_begin; sb < s_end; ++sb) {
    const int* sp = supers + (size_t)sb * 8;
    if (!tile_overlap(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2), __ldg(sp + 3),
                      row0, col0))
      continue;
    for (int b = sb * SUPER_BLOCK; b < (sb + 1) * SUPER_BLOCK; ++b) {
      const int* bb = blocks + (size_t)b * 8;
      if (tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2), __ldg(bb + 3),
                       row0, col0))
        keyed_block_rows<Mode>(s, b, pending, ti, tf, span_end, row0, col0);
    }
  }
  flush_pending<Mode>(s, pending, ti, tf, span_end, row0, col0);
}

// The hit words of a launch's tiles over one hierarchy (raster_hier.cu,
// raster_twoclass.cu, raster_vis.cu), one int buffer of tiles * (2
// num_supers + 1) (ops/raster.py _keyed_hier_args): word sb of tile t has
// bit j set when block SUPER_BLOCK sb + j is a hit block (its bbox and
// superblock sb's meet the tile; K10vis: its group bits); before[sb]
// counts the tile's hit blocks in superblocks [0, sb); count[t] is its H.
// Int: int where the buffer is written, const int where read.
template <class Int>
struct HitWords {
  Int* words;
  Int* before;
  Int* count;
};

template <class Int>
__device__ __forceinline__ HitWords<Int> hit_words(Int* buf, int tiles,
                                                   int num_supers) {
  const size_t n = (size_t)tiles * num_supers;
  return {buf, buf + n, buf + 2 * n};
}

static_assert(SUPER_BLOCK == 32 && THREADS == WARPS * SUPER_BLOCK,
              "a warp tests a superblock's blocks");

// The block scans the counts of tile `tile`'s hit words (written by its
// threads before): before[sb] and count[tile].
__device__ __forceinline__ void hit_word_counts(const HitWords<int>& hw,
                                                int num_supers, int tile,
                                                int* warp_sums) {
  const int* words = hw.words + (size_t)tile * num_supers;
  int* before = hw.before + (size_t)tile * num_supers;
  __syncthreads();  // the block's words visible to all its threads
  int base = 0;     // block-uniform
  for (int c = 0; c < num_supers; c += THREADS) {
    const int sb = c + (int)threadIdx.x;
    int total;
    const int pre = block_exclusive_scan(
        sb < num_supers ? __popc((unsigned)words[sb]) : 0, warp_sums, total);
    if (sb < num_supers) before[sb] = base + pre;
    base += total;
  }
  if (threadIdx.x == 0) hw.count[tile] = base;
}

// The block writes the hit words of tile `tile` (of `tiles`; its first
// pixel at global (row0, col0)): block b of superblock sb is a hit block
// when its bbox and the superblock's meet the tile.  Warp w tests
// superblocks w, w + WARPS, ... and their 32 blocks, one ballot each
// (their loads do not wait on one another); then the block scans the
// words' counts.
__device__ __forceinline__ void tile_hit_words(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int* buf, int tiles, int tile, int row0,
    int col0, int* warp_sums) {
  const HitWords<int> hw = hit_words(buf, tiles, num_supers);
  int* words = hw.words + (size_t)tile * num_supers;
  const int lane = (int)threadIdx.x % SUPER_BLOCK;
#pragma unroll 4
  for (int sb = (int)threadIdx.x / SUPER_BLOCK; sb < num_supers;
       sb += WARPS) {
    const int* sp = supers + (size_t)sb * 8;
    const int* bb = blocks + ((size_t)sb * SUPER_BLOCK + lane) * 8;
    const bool hit =
        tile_overlap(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2), __ldg(sp + 3),
                     row0, col0) &&
        tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2), __ldg(bb + 3),
                     row0, col0);
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) words[sb] = (int)m;
  }
  hit_word_counts(hw, num_supers, tile, warp_sums);
}

// visit(b) for each of a tile's hit blocks [h0, h1) in row order (of its
// total H), from its rows of the hit words (words, before).  The
// superblocks before the share's first block are those whose blocks all
// lie before it (before + popcount <= h0, a prefix of the superblocks,
// counted a THREADS-long chunk at a time); the words are read HIT_WORDS at
// a time from there.  Block-uniform; its first count is a barrier.
template <class Visit>
__device__ __forceinline__ void walk_hit_blocks(
    KeyedSmem& s, const int* __restrict__ words,
    const int* __restrict__ before, int num_supers, int total, int h0,
    int h1, Visit&& visit) {
  int first = 0;  // block-uniform
  for (int c = 0;; c += THREADS) {
    const int sb = c + (int)threadIdx.x;
    const int n = __syncthreads_count(
        sb < num_supers &&
        __ldg(before + sb) + __popc((unsigned)__ldg(words + sb)) <= h0);
    first += n;
    if (n < THREADS) break;
  }
  int h = first < num_supers ? __ldg(before + first) : total;
  for (int c = first; c < num_supers && h < h1; c += HIT_WORDS) {
    __syncthreads();  // every thread past the previous words
    if (threadIdx.x < HIT_WORDS && c + (int)threadIdx.x < num_supers)
      s.hits[threadIdx.x] = (unsigned)__ldg(words + c + threadIdx.x);
    __syncthreads();
    for (int k = 0; k < HIT_WORDS && c + k < num_supers && h < h1; ++k) {
      for (unsigned m = s.hits[k]; m && h < h1; m &= m - 1, ++h)
        if (h >= h0) visit((c + k) * SUPER_BLOCK + __ffs(m) - 1);
    }
  }
}

// A work item's keys out, after the block's last batch: the tile's planes
// when the item is its tile's only one (alone), else an atomicMin of each
// key it lowered into the key plane, which starts all ones.  extra: a
// G-buffer key's further planes.  The planes and the key plane hold the
// height rows from global row row_base (a band's; 0 for a frame): the
// tile's global pixel row r is their row r - row_base.
template <class Mode>
__device__ __forceinline__ void keyed_out(
    const KeyedSmem& s, bool alone, unsigned long long* __restrict__ plane,
    int row0, int col0, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height, int row_base = 0) {
  const size_t frame = (size_t)width * height;
  if (alone) {
    for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) {
      const int row = row0 + p / TILE_W, col = col0 + p % TILE_W;
      Mode::store(s.key[p], row, col, ti, tf, color, depth, extra,
                  (size_t)(row - row_base) * width + col, frame);
    }
  } else {
    for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) {
      const unsigned long long k = s.key[p];
      if (k != Mode::CLEAR)
        atomicMin(plane + (size_t)(row0 - row_base + p / TILE_W) * width +
                      col0 + p % TILE_W,
                  k);
    }
  }
}

// One tile of several items: the merged keys in the plane, resolved (a
// pixel no item lowered holds all ones: the clear key).  row_base as
// keyed_out's.
template <class Mode>
__device__ __forceinline__ void resolve_tile(
    const unsigned long long* __restrict__ plane, int row0, int col0,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ extra, int width, int height, int row_base = 0) {
  const size_t frame = (size_t)width * height;
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) {
    const int row = row0 + p / TILE_W, col = col0 + p % TILE_W;
    const size_t idx = (size_t)(row - row_base) * width + col;
    Mode::store(min(plane[idx], Mode::CLEAR), row, col, ti, tf, color, depth,
                extra, idx, frame);
  }
}

}  // namespace zr
