// K10vec and K10vecg: the lane-parallel block-grouped raster, flat and
// G-buffer.
//
// Replaces rasterize_setup_pallas_vec and rasterize_gbuffer_pallas_vec
// (zrenderer_tpu/ops/experiments/raster_vec.py :347 and :384, body
// _vec_kernel :137).  Inputs are the outputs of prepare_vec_inputs
// (zrenderer_tpu_torch/ops/experiments/raster_vec.py): one REC_LANES-lane
// int32 record per setup row (the setup ints, the folded edge constants
// a_k = dy_k*x_ref - dx_k*y_ref in lanes 20-22, the union bbox of each
// 32-row subgroup's valid rows in lanes 24-27 of its first row, the setup
// floats bitcast from lane 32), with the block and superblock union-bbox
// tables.
//
// What the reference computes, per 32x128 tile:
// * the superblocks, then the blocks, whose bbox meets the tile;
// * per 32-record subgroup whose bbox meets the tile's columns, and per
//   8-row chunk of the tile its bbox meets, every live record (valid,
//   non-empty bbox; no per-record bbox test) evaluated at the chunk's
//   pixels with e_k = (a_k + dx_k*py) - dy_k*px, wrapping like the
//   reference's int32;
// * the subgroup's (z, row id) winner merged into the tile by the
//   strict-less test z >= 0 && z < zb from 1.0: the least z, ties to the
//   first row, never z >= 1.0;
// * the epilogue from the winner's record: colour where(covered,
//   numer*inv, 0), packed RGBA8 with alpha 255, depth, and for the
//   G-buffer the interpolants as covered ? buf*inv : 0 (the reference's
//   :341, K3g's form) and the constants as latched.
//
// K10vec and K10vecg run the keyed hierarchy body (raster_keyed.cuh, as
// K10trans in raster_vis.cu), with the planes of the register body they ran
// before bit for bit.  What bound that body on the H100 (K10vec 10.37 ms a
// call on lattice1M at 1920x1088, 60 registers; K10vecg 1.45 on
// lattice40k, 111): one CUDA block a tile read every superblock's bbox,
// staged each hit block's 128 records (36 KB) and ran every live record of
// a hit subgroup over each 8-row chunk its subgroup bbox meets, 1024
// pixels a chunk, most of them outside the triangle.  Here (vec_items, one
// template on the key type):
// * vec_hit_words_kernel writes each tile's hit words once a call (K5's
//   tile_hit_words over the blocks and superblocks);
// * a tile's hit blocks are cut into `items` work items of about equal
//   counts, one CUDA block each (walk_hit_blocks); in a hit block warp w
//   reads subgroup w's bbox and its 32 threads pend their rows when the
//   subgroup is admitted (its bbox meets the tile's columns and a chunk's
//   rows) and the row is live (the reference's own rule, no per-row bbox
//   test);
// * each pending row is evaluated over its window: its vertices' pixel
//   bbox in the tile (prepare_record) within the rows of its subgroup's
//   hit chunks.  A pixel a row covers lies in that bbox, so the window
//   holds every pixel the chunks drew, the padding rows included (a
//   subgroup bbox clamped above them meets no chunk there);
// * one key a pixel, VecKeys: HierFlatKeys' (order bits of z, row id),
//   whose minimum from the strict clear key (1.0, 0) is the strict-less
//   merge of the subgroup winners; items merge by atomicMin into a key
//   plane of the output's size (memset to all ones) and a resolve writes
//   the planes (a tile of one item resolves in place), the winner
//   re-evaluated from its 72-lane record (its -0.0 kept); K10vecg's
//   VecKeys<true> adds the 11 further planes under K3g's epilogue,
//   covered ? buf * inv : 0.
// Four device ops a call: hit words, memset, items, resolve.  Bound on the
// H100: the window pixels' edge work (26 ops each), or the bytes the body
// needs (tables, the subgroup bboxes, admitted rows, the 2 or 13 planes).
// The records' setup ints give the same int32 edge values as the a_k
// form.

#include "raster_keyed.cuh"

namespace zr {
namespace vec {

constexpr int SUBGROUP = 32;
constexpr int CHUNK_H = 8;
constexpr int SG_BBOX = 24;
constexpr int F_BASE = 32;
constexpr int REC_LANES = F_BASE + NF32;  // 72
static_assert(SUBGROUP == 32, "a warp admits a subgroup");

// K10vec's and K10vecg's key: HierFlatKeys' (order bits of z, row id) from
// the strict clear key (1.0, 0), the winner resolved from its record (ti:
// the records, tf: their floats from lane F_BASE, both REC_LANES lanes a
// row); PLANES (K10vecg): the 11 further planes too, covered ? buf * inv :
// 0.
template <bool PLANES>
struct VecKeys : WinnerKeys<PLANES, true, false> {
  using Base = WinnerKeys<PLANES, true, false>;
  static __device__ __forceinline__ void store(
      unsigned long long k, int row, int col, const int* __restrict__ ti,
      const float* __restrict__ tf, int* __restrict__ color,
      float* __restrict__ depth, float* __restrict__ extra, size_t idx,
      size_t frame) {
    resolve_winner<false, PLANES, true, REC_LANES, REC_LANES>(
        ti, tf, k == Base::CLEAR ? INT_MAX32 : (int)(uint32_t)k, 1.0f,
        col * SUBPIXEL + HALF, row * SUBPIXEL + HALF, color, depth, extra,
        idx, frame);
  }
};

// Subgroup s0's (its first record's) hit chunks at a tile from global
// (row0, col0): the tile rows [lo, lo + n) of the 8-row chunks its bbox
// meets, n 0 when the bbox misses the tile's columns or every chunk.
__device__ __forceinline__ void hit_chunks(const int* __restrict__ rec,
                                           int s0, int row0, int col0,
                                           int& lo, int& n) {
  const int* h = rec + (size_t)s0 * REC_LANES + SG_BBOX;
  const int sj0 = __ldg(h), sj1 = __ldg(h + 1);
  const int si0 = __ldg(h + 2), si1 = __ldg(h + 3);
  lo = n = 0;
  if (!tile_overlap(sj0, sj1, si0, si1, row0, col0)) return;
  const int c0 = max(si0 - row0, 0) / CHUNK_H;
  const int c1 = min(si1 - row0, TILE_H - 1) / CHUNK_H;
  lo = c0 * CHUNK_H;
  n = (c1 - c0 + 1) * CHUNK_H;
}

// Block blockIdx.x writes the hit words of its tile, as K5's.
__global__ void __launch_bounds__(THREADS) vec_hit_words_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int* buf, int width, int height) {
  __shared__ int warp_sums[WARPS];
  const int tiles_x = width / TILE_W, tile = (int)blockIdx.x;
  tile_hit_words(supers, num_supers, blocks, buf,
                 tiles_x * (height / TILE_H), tile, (tile / tiles_x) * TILE_H,
                 (tile % tiles_x) * TILE_W, warp_sums);
}

// Work item blockIdx.x is item i = blockIdx.x % items of tile blockIdx.x /
// items, and takes the tile's hit blocks [i * H / items, (i + 1) * H /
// items) in row order (an item with none returns at once).  In each hit
// block thread t < 128 pends row 128 b + t when its subgroup has a hit
// chunk and the row is live; each pending row is evaluated over its window
// within its subgroup's hit chunks.  Then out (keyed_out): the tile's
// planes (extra: Keys's further planes) from the item that holds all its
// hit blocks (one item a tile, or at most one hit block: the last item),
// else into the key plane.
template <class Keys>
__device__ __forceinline__ void vec_items(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ rec,
    int items, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ extra, int width, int height) {
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSmem& s = *reinterpret_cast<KeyedSmem*>(keyed_smem);
  const float* recf = reinterpret_cast<const float*>(rec + F_BASE);
  const int tiles_x = width / TILE_W, tiles = tiles_x * (height / TILE_H);
  const int tile = (int)blockIdx.x / items, item = (int)blockIdx.x % items;
  const int row0 = (tile / tiles_x) * TILE_H;
  const int col0 = (tile % tiles_x) * TILE_W;
  const HitWords<const int> hw = hit_words(buf, tiles, num_supers);
  const int total = __ldg(hw.count + tile);
  const int h0 = item * total / items, h1 = (item + 1) * total / items;
  const bool alone = items == 1 || (total <= 1 && item == items - 1);
  if (h0 == h1 && !alone) return;  // block-uniform
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS)
    s.key[p] = Keys::CLEAR;
  // The first n pending rows as one batch.
  auto flush = [&](int n) {
    int area = 0;
    const int j = threadIdx.x;
    if (j < n) {
      const int t = s.pending[j];
      int lo, rows;
      hit_chunks(rec, t & -SUBGROUP, row0, col0, lo, rows);
      area = prepare_record(s, j, rec + (size_t)t * REC_LANES,
                            recf + (size_t)t * REC_LANES + F_ZA0,
                            Keys::row_tag(t, 0), row0, col0, lo, rows);
    }
    eval_batch<Keys>(s, area);
  };
  int pending = 0;  // block-uniform; the walk's barriers order the clear
  walk_hit_blocks(
      s, hw.words + (size_t)tile * num_supers,
      hw.before + (size_t)tile * num_supers, num_supers, total, h0, h1,
      [&](int b) {
        const int t = b * RASTER_BLOCK + (int)threadIdx.x;
        bool hit = false;
        if (threadIdx.x < RASTER_BLOCK) {
          int lo, rows;
          hit_chunks(rec, t & -SUBGROUP, row0, col0, lo, rows);
          const int* r = rec + (size_t)t * REC_LANES;
          hit = rows > 0 && __ldg(r + I_JMIN) <= __ldg(r + I_JMAX) &&
                __ldg(r + I_IMIN) <= __ldg(r + I_IMAX) &&
                __ldg(r + I_VALID) > 0;
        }
        keyed_pend(s, hit, t, pending, flush);
      });
  if (pending > 0) {
    __syncthreads();
    flush(pending);
  }
  __syncthreads();
  keyed_out<Keys>(s, alone, plane, row0, col0, rec, recf, color, depth,
                  extra, width, height);
}

// The resolve of a tile of several items whose rows lie in two or more hit
// blocks.
template <class Keys>
__device__ __forceinline__ void vec_resolve(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ rec,
    const unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height) {
  const int tiles_x = width / TILE_W, tiles = tiles_x * (height / TILE_H);
  const int tile = (int)blockIdx.x;
  if (__ldg(hit_words(buf, tiles, num_supers).count + tile) <= 1)
    return;  // resolved in place
  resolve_tile<Keys>(plane, (tile / tiles_x) * TILE_H,
                     (tile % tiles_x) * TILE_W, rec,
                     reinterpret_cast<const float*>(rec + F_BASE), color,
                     depth, extra, width, height);
}

// One entry point per kernel, so each has its own name in a profile.
// K10vec: packed colour and depth.
__global__ void __launch_bounds__(THREADS) raster_vec_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ rec,
    int items, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  vec_items<VecKeys<false>>(buf, num_supers, rec, items, plane, color, depth,
                            nullptr, width, height);
}

__global__ void __launch_bounds__(THREADS) raster_vec_resolve_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ rec,
    const unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height) {
  vec_resolve<VecKeys<false>>(buf, num_supers, rec, plane, color, depth,
                              nullptr, width, height);
}

// K10vecg: out holds the GBUF_PLANES planes, width * height floats apart.
__global__ void __launch_bounds__(THREADS) gbuffer_vec_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ rec,
    int items, unsigned long long* __restrict__ plane,
    float* __restrict__ out, int width, int height) {
  const size_t frame = (size_t)width * height;
  vec_items<VecKeys<true>>(buf, num_supers, rec, items, plane,
                           reinterpret_cast<int*>(out), out + frame,
                           out + 2 * frame, width, height);
}

__global__ void __launch_bounds__(THREADS) gbuffer_vec_resolve_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ rec,
    const unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int height) {
  const size_t frame = (size_t)width * height;
  vec_resolve<VecKeys<true>>(buf, num_supers, rec, plane,
                             reinterpret_cast<int*>(out), out + frame,
                             out + 2 * frame, width, height);
}

}  // namespace vec
}  // namespace zr

// K10vec and K10vecg: the hit words, then with several items a tile the
// key plane set to all ones, tiles * items work items and the resolve over
// the tiles.  buf: tiles * (2 num_supers + 1) ints of hit words; plane:
// height * width keys, unused with one item a tile.
template <class Items, class Resolve, class... Out>
static int launch_vec(Items items_kernel, Resolve resolve_kernel,
                      const int* supers, int num_supers, const int* blocks,
                      const int* rec, int items, int* buf,
                      unsigned long long* plane, int height, int width,
                      void* stream, Out... out) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = (int)sizeof(zr::KeyedSmem);
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  zr::vec::vec_hit_words_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
      supers, num_supers, blocks, buf, width, height);
  if (items > 1) {
    err = cudaMemsetAsync(plane, 0xff,
                          (size_t)height * width * sizeof(*plane), s);
    if (err != cudaSuccess) return (int)err;
  }
  items_kernel<<<num_tiles * items, zr::THREADS, smem, s>>>(
      buf, num_supers, rec, items, plane, out..., width, height);
  if (items > 1)
    resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        buf, num_supers, rec, plane, out..., width, height);
  return (int)cudaGetLastError();
}

// K10vec: packed color (int bits) and depth.
extern "C" int zr_raster_vec(const int* supers, int num_supers,
                             const int* blocks, const int* rec, int items,
                             int* buf, unsigned long long* plane, int* color,
                             float* depth, int height, int width,
                             void* stream) {
  return launch_vec(zr::vec::raster_vec_keyed_kernel,
                    zr::vec::raster_vec_resolve_kernel, supers, num_supers,
                    blocks, rec, items, buf, plane, height, width, stream,
                    color, depth);
}

// K10vecg: the GBUF_PLANES planes back to back.
extern "C" int zr_gbuffer_vec(const int* supers, int num_supers,
                              const int* blocks, const int* rec, int items,
                              int* buf, unsigned long long* plane,
                              float* out, int height, int width,
                              void* stream) {
  return launch_vec(zr::vec::gbuffer_vec_keyed_kernel,
                    zr::vec::gbuffer_vec_resolve_kernel, supers, num_supers,
                    blocks, rec, items, buf, plane, height, width, stream,
                    out);
}
