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
// bbox meets the tile.  What it computes, per 32x128 tile: the superblocks
// whose bbox meets the tile; each of their blocks whose 16 group bits
// ((word[b / 2] >> 16 * (b % 2)) & 0xFFFF) are not all clear; each set
// bit's 8 rows in order over the whole tile, with no per-row bbox test,
// under the strict-less test z >= 0 && z < zb from 1.0.  A row that is
// dead (bias INT32_MAX) covers nothing; a valid row whose bbox clamped to
// empty below the frame draws in the padding rows, as the reference's
// does.
//
// K10trans replaces rasterize_setup_pallas_trans (:654, body
// _trans_vis_kernel :526).  Inputs: prepare_trans_inputs' records (the 20
// setup ints and the z-plane coefficients bitcast at lanes 20-22, 24 lanes
// a row), the union bbox of each 8-row group, and the block and superblock
// tables.  Per tile: the superblocks and blocks whose bbox meets it, then
// each group whose bbox does; the group's tile rows are evaluated in
// TRANS_R = 4 row chunks from lo = max(imin - row0, 0), the last chunks
// clamped to start at TILE_H - 4, which covers the rows
// [min(lo, TILE_H - 4), min(lo + 4 * nch, TILE_H)), nch = (hi - lo) / 4 + 1,
// hi = min(imax - row0, TILE_H - 1).  At each such pixel the group's
// winner is its first row with the least z among the covered rows with z
// >= 0, merged into the tile by strict less: the least z over the rows'
// evaluations, the lowest row id on exact ties, never z >= 1.0.
//
// Both run the keyed hierarchy body (raster_keyed.cuh, as K5 in
// raster_hier.cu), with the planes of the register body they ran before
// bit for bit.  What bound that body on the H100 (K10vis 13.22 ms, K10trans
// 11.06 ms a call on lattice1M at 1920x1088; 58 and 128 registers): one
// CUDA block a tile walked superblock -> block -> group one dependent load
// at a time, then ran every admitted row over its whole extent (K10vis the
// 4096 pixels of the tile, K10trans the group's span in 4-row chunks
// across all 128 columns): 4.41e9 and 2.10e9 (row, pixel) evaluations for
// a frame whose rows' windows hold 5.02e7.  Here:
// * a first kernel writes each tile's hit words once a call
//   (raster_keyed.cuh's layout): K10vis's from the bitmap (bit j of word
//   sb set when superblock sb meets the tile and block 32 sb + j has a set
//   group bit), K10trans's from the block and superblock bboxes
//   (tile_hit_words, K5's);
// * a tile's hit blocks are cut into `items` work items of about equal
//   counts, one CUDA block each (walk_hit_blocks); an item tests a hit
//   block's 128 rows by 128 threads at once, each kernel by its own rule
//   (K10vis: the row's group bit; K10trans: its group's bbox meets the
//   tile), all 8 rows of an admitted group, and compacts them into the
//   pending list (keyed_pend);
// * each pending row is evaluated over its window only: its vertices'
//   pixel bbox in the tile (prepare_record), within the kernel's extent
//   (K10vis the tile; K10trans its group's chunk rows).  A pixel a row
//   covers lies in that bbox, so the window holds every pixel the whole
//   extent drew, the padding rows included; a dead row's is empty;
// * one key a pixel in shared memory, VisKeys: DepthKeys' (order bits of
//   z, row id, sign of z), whose minimum is both kernels' result, with the
//   strict clear key (1.0, 0), which no z >= 1.0 goes below; items merge by
//   atomicMin into a key plane of the output's size (memset to all ones)
//   and a resolve writes the planes (a tile of one item resolves in place):
//   z and the sign from the key, so a -0.0 winner keeps its sign, and the
//   row id.  The store reads no row.
// Four device ops a call: hit words, memset, items, resolve.  Bound on the
// H100: the window pixels' edge work (26 ops each), or the bytes the body
// needs (tables, bitmap, admitted rows, the two planes).

#include "raster_keyed.cuh"

namespace zr {
namespace vis {

constexpr int GROUP = 8;                          // rows per hit bit / group
constexpr int GROUPS_PER_BLOCK = RASTER_BLOCK / GROUP;  // 16: half a word
constexpr int TRANS_R = 4;                        // tile rows per chunk
constexpr int REC_LANES = 24;                     // trans record stride
constexpr int TRANS_ZA = NI32;                    // z-plane lanes
constexpr int NO_ROW = -1;                        // id where no row passed
static_assert(GROUPS_PER_BLOCK == 16, "a block reads half a bitmap word");

// DepthKeys with the row id as visit index; the store writes z (its sign
// from the key) and the row id, -1 and 1.0 under the clear key.  `id` takes
// the colour plane's place in the keyed body's stores.
struct VisKeys : DepthKeys {
  static __device__ __forceinline__ void store(
      unsigned long long k, int row, int col, const int* __restrict__ ti,
      const float* __restrict__ tf, int* __restrict__ id,
      float* __restrict__ depth, float* __restrict__ extra, size_t idx,
      size_t frame) {
    DepthKeys::store(k, row, col, ti, tf, id, depth, extra, idx, frame);
    id[idx] = k == CLEAR ? NO_ROW : (int)((uint32_t)k >> 1);
  }
};

// One call's inputs: the hit words (buf, num_supers), the rows (K10vis:
// ti, NI32 ints a row, and tf's z coefficients, NF32 floats a row from
// F_ZA0; K10trans: rec, REC_LANES lanes a row for both), K10vis's bitmap
// and K10trans's group bounds.
struct VisRows {
  const int* buf;
  int num_supers;
  const int* ri;
  const float* zc;
  const int* bits;
  int nwords;
  const int* gbounds;
};

// Half of tile row row_bits' bitmap word for block b: its 16 group bits.
__device__ __forceinline__ uint32_t group_bits(const int* __restrict__ row_bits,
                                               int b) {
  return ((uint32_t)__ldg(row_bits + b / 2) >> (16 * (b % 2))) & 0xFFFFu;
}

// Block blockIdx.x writes the hit words of its tile from the bitmap
// (raster_keyed.cuh tile_hit_words' layout): block b < num_blocks is a hit
// block when its superblock meets the tile and one of its group bits is
// set.  Warp w tests superblocks w, w + WARPS, ..., a lane a block.
__global__ void __launch_bounds__(THREADS) vis_hit_words_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ bits, int nwords, int num_blocks, int* buf,
    int width, int height) {
  __shared__ int warp_sums[WARPS];
  const int tiles_x = width / TILE_W, tile = (int)blockIdx.x;
  const int row0 = (tile / tiles_x) * TILE_H, col0 = (tile % tiles_x) * TILE_W;
  const HitWords<int> hw = hit_words(buf, tiles_x * (height / TILE_H),
                                     num_supers);
  int* words = hw.words + (size_t)tile * num_supers;
  const int* row_bits = bits + (size_t)tile * nwords;
  const int lane = (int)threadIdx.x % SUPER_BLOCK;
#pragma unroll 4
  for (int sb = (int)threadIdx.x / SUPER_BLOCK; sb < num_supers;
       sb += WARPS) {
    const int* sp = supers + (size_t)sb * 8;
    const int b = sb * SUPER_BLOCK + lane;
    const bool hit =
        tile_overlap(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2), __ldg(sp + 3),
                     row0, col0) &&
        b < num_blocks && group_bits(row_bits, b) != 0;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) words[sb] = (int)m;
  }
  hit_word_counts(hw, num_supers, tile, warp_sums);
}

// Block blockIdx.x writes the hit words of its tile from the block and
// superblock bboxes, as K5's.
__global__ void __launch_bounds__(THREADS) trans_hit_words_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int* buf, int width, int height) {
  __shared__ int warp_sums[WARPS];
  const int tiles_x = width / TILE_W, tile = (int)blockIdx.x;
  tile_hit_words(supers, num_supers, blocks, buf,
                 tiles_x * (height / TILE_H), tile, (tile / tiles_x) * TILE_H,
                 (tile % tiles_x) * TILE_W, warp_sums);
}

// Group g's tile rows [lo, lo + n) at a tile from global row row0 whose
// rows its bbox meets: its 4-row chunks from max(imin - row0, 0), the last
// clamped to start at TILE_H - TRANS_R.
__device__ __forceinline__ void chunk_rows(const int* __restrict__ gbounds,
                                           int g, int row0, int& lo,
                                           int& n) {
  const int* gb = gbounds + (size_t)g * 4;
  const int first = max(__ldg(gb + 2) - row0, 0);
  const int last = min(__ldg(gb + 3) - row0, TILE_H - 1);
  const int nch = (last - first) / TRANS_R + 1;
  lo = min(first, TILE_H - TRANS_R);
  n = min(first + TRANS_R * nch, TILE_H) - lo;
}

// Work item blockIdx.x is item i = blockIdx.x % items of tile blockIdx.x /
// items, and takes the tile's hit blocks [i * H / items, (i + 1) * H /
// items) in row order (an item with none returns at once).  In each hit
// block thread t < 128 pends row 128 b + t when its group is admitted
// (K10vis: bit t / 8 of the block's half word; K10trans: group (128 b + t)
// / 8's bbox meets the tile); each pending row is evaluated over its window
// (K10trans: within its group's chunk rows).  Then out (keyed_out): the
// tile's planes from the item that holds all its hit blocks (one item a
// tile, or at most one hit block: the last item), else into the key plane.
template <bool TRANS>
__device__ __forceinline__ void vis_items(
    const VisRows& v, int items, unsigned long long* __restrict__ plane,
    float* __restrict__ depth, int* __restrict__ idx, int width,
    int height) {
  constexpr int RI = TRANS ? REC_LANES : NI32;  // int stride of a row
  constexpr int RF = TRANS ? REC_LANES : NF32;  // its z coefficients'
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSmem& s = *reinterpret_cast<KeyedSmem*>(keyed_smem);
  const int tiles_x = width / TILE_W, tiles = tiles_x * (height / TILE_H);
  const int tile = (int)blockIdx.x / items, item = (int)blockIdx.x % items;
  const int row0 = (tile / tiles_x) * TILE_H;
  const int col0 = (tile % tiles_x) * TILE_W;
  const HitWords<const int> hw = hit_words(v.buf, tiles, v.num_supers);
  const int total = __ldg(hw.count + tile);
  const int h0 = item * total / items, h1 = (item + 1) * total / items;
  const bool alone = items == 1 || (total <= 1 && item == items - 1);
  if (h0 == h1 && !alone) return;  // block-uniform
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS)
    s.key[p] = VisKeys::CLEAR;
  // The first n pending rows as one batch.
  auto flush = [&](int n) {
    int area = 0;
    const int j = threadIdx.x;
    if (j < n) {
      const int t = s.pending[j];
      int lo = 0, rows = TILE_H;
      if constexpr (TRANS) chunk_rows(v.gbounds, t / GROUP, row0, lo, rows);
      area = prepare_record(s, j, v.ri + (size_t)t * RI,
                            v.zc + (size_t)t * RF, VisKeys::row_tag(t, 0),
                            row0, col0, lo, rows);
    }
    eval_batch<VisKeys>(s, area);
  };
  int pending = 0;  // block-uniform; the walk's barriers order the clear
  walk_hit_blocks(
      s, hw.words + (size_t)tile * v.num_supers,
      hw.before + (size_t)tile * v.num_supers, v.num_supers, total, h0, h1,
      [&](int b) {
        const int t = b * RASTER_BLOCK + (int)threadIdx.x;
        bool hit = false;
        if (threadIdx.x < RASTER_BLOCK) {
          if constexpr (TRANS) {
            const int* gb = v.gbounds + (size_t)(t / GROUP) * 4;
            hit = tile_overlap(__ldg(gb), __ldg(gb + 1), __ldg(gb + 2),
                               __ldg(gb + 3), row0, col0);
          } else {
            hit = (group_bits(v.bits + (size_t)tile * v.nwords, b) >>
                   (threadIdx.x / GROUP)) &
                  1u;
          }
        }
        keyed_pend(s, hit, t, pending, flush);
      });
  if (pending > 0) {
    __syncthreads();
    flush(pending);
  }
  __syncthreads();
  keyed_out<VisKeys>(s, alone, plane, row0, col0, nullptr, nullptr, idx,
                     depth, nullptr, width, height);
}

// The resolve of a tile of several items whose rows lie in two or more hit
// blocks.
__device__ __forceinline__ void vis_resolve(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int* __restrict__ idx, int width, int height) {
  const int tiles_x = width / TILE_W, tiles = tiles_x * (height / TILE_H);
  const int tile = (int)blockIdx.x;
  if (__ldg(hit_words(buf, tiles, num_supers).count + tile) <= 1)
    return;  // resolved in place
  resolve_tile<VisKeys>(plane, (tile / tiles_x) * TILE_H,
                        (tile % tiles_x) * TILE_W, nullptr, nullptr, idx,
                        depth, nullptr, width, height);
}

// One entry point per kernel, so each has its own name in a profile.
__global__ void __launch_bounds__(THREADS) raster_vis_keyed_kernel(
    VisRows v, int items, unsigned long long* __restrict__ plane,
    float* __restrict__ depth, int* __restrict__ idx, int width,
    int height) {
  vis_items<false>(v, items, plane, depth, idx, width, height);
}

__global__ void __launch_bounds__(THREADS) raster_vis_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int* __restrict__ idx, int width, int height) {
  vis_resolve(buf, num_supers, plane, depth, idx, width, height);
}

__global__ void __launch_bounds__(THREADS) raster_trans_keyed_kernel(
    VisRows v, int items, unsigned long long* __restrict__ plane,
    float* __restrict__ depth, int* __restrict__ idx, int width,
    int height) {
  vis_items<true>(v, items, plane, depth, idx, width, height);
}

__global__ void __launch_bounds__(THREADS) raster_trans_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int* __restrict__ idx, int width, int height) {
  vis_resolve(buf, num_supers, plane, depth, idx, width, height);
}

}  // namespace vis
}  // namespace zr

// After the hit words: tiles * items work items, with several items a tile
// the key plane (height * width keys) set to all ones first and the resolve
// over the tiles after.
template <class Items, class Resolve>
static int launch_vis_items(Items items_kernel, Resolve resolve_kernel,
                            const zr::vis::VisRows& v, int items,
                            unsigned long long* plane, float* depth,
                            int* idx, int height, int width,
                            cudaStream_t s) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const int smem = (int)sizeof(zr::KeyedSmem);
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (items > 1) {
    err = cudaMemsetAsync(plane, 0xff,
                          (size_t)height * width * sizeof(*plane), s);
    if (err != cudaSuccess) return (int)err;
  }
  items_kernel<<<num_tiles * items, zr::THREADS, smem, s>>>(
      v, items, plane, depth, idx, width, height);
  if (items > 1)
    resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        v.buf, v.num_supers, plane, depth, idx, width, height);
  return (int)cudaGetLastError();
}

// K10vis: depth and row id planes.  buf: tiles * (2 num_supers + 1) ints of
// hit words; plane: height * width keys, unused with one item a tile.
extern "C" int zr_raster_vis(const int* supers, int num_supers,
                             const int* bits, int nwords, const int* ti,
                             const float* tf, int num_blocks, int items,
                             int* buf, unsigned long long* plane,
                             float* depth, int* idx, int height, int width,
                             void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  zr::vis::vis_hit_words_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
      supers, num_supers, bits, nwords, num_blocks, buf, width, height);
  const zr::vis::VisRows v{buf, num_supers, ti,     tf + zr::F_ZA0,
                           bits, nwords,    nullptr};
  return launch_vis_items(zr::vis::raster_vis_keyed_kernel,
                          zr::vis::raster_vis_resolve_kernel, v, items,
                          plane, depth, idx, height, width, s);
}

// K10trans: depth and row id planes; buf and plane as K10vis's.
extern "C" int zr_raster_trans(const int* supers, int num_supers,
                               const int* blocks, const int* rec,
                               const int* gbounds, int items, int* buf,
                               unsigned long long* plane, float* depth,
                               int* idx, int height, int width,
                               void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  zr::vis::trans_hit_words_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
      supers, num_supers, blocks, buf, width, height);
  const zr::vis::VisRows v{
      buf,     num_supers, rec, reinterpret_cast<const float*>(rec) +
                                    zr::vis::TRANS_ZA,
      nullptr, 0,          gbounds};
  return launch_vis_items(zr::vis::raster_trans_keyed_kernel,
                          zr::vis::raster_trans_resolve_kernel, v, items,
                          plane, depth, idx, height, width, s);
}
