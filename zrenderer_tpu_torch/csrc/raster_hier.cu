// K3 and K5: hierarchy flat raster; K3g and K5g: its G-buffer variants;
// K3d: its depth-only variant.
//
// Replaces rasterize_setup_pallas (K3: zrenderer_tpu/ops/raster_pallas.py,
// _raster_kernel, body _kernel_body) and rasterize_setup_pallas_hbm (K5:
// _hbm_kernel, body _hbm_kernel_body).  The two differ only in TPU memory
// placement (VMEM-resident rows, or rows streamed from HBM in block
// slabs); this kernel reads its rows from global memory at any row count,
// and the wrappers keep K3's 32768-row cap.  Inputs are the outputs of
// prepare_raster_inputs (zrenderer_tpu_torch/ops/raster.py): the live rows
// stable-compacted to the front (submission order kept), padded to
// RASTER_BLOCK, plus the block and superblock union-bbox tables.
//
// What it computes, per 32x128 tile (one CUDA block): the rows in
// submission order, skipping a superblock (4096 rows), a block (128 rows)
// or a row whose bbox misses the tile, with the sequential strict-less
// depth test z >= 0 && z < zb; then one divide per pixel into packed RGBA8
// + f32 depth.
//
// What bounds it on the H100: the per-tile triangle reads and the
// instruction throughput of the per-pixel edge evaluation, not
// device-memory bytes (the 1080p output planes are 16.7 MB).  Each tile
// walks the bbox tables from the start (a few hundred broadcast loads for
// 32K rows), then pays three edge functions and a depth test at 4096
// pixels for every row whose bbox touches it.  The simple design keeps the
// tile state in registers across the walk and reads setup rows through
// broadcast loads; the order of the walk is fixed because the strict-less
// test resolves exact depth ties in submission order.  Later work: stage
// hit blocks' rows in shared memory, skip pixel rows outside a triangle's
// bbox, persistent blocks.
//
// K3g and K5g replace rasterize_gbuffer_pallas (K3g: _gbuffer_kernel, body
// _kernel_body with the G-buffer scratch) and rasterize_gbuffer_pallas_hbm
// (K5g: _hbm_gbuffer_kernel, body _hbm_kernel_body).  Both compute the
// same walk and strict-less test, then the 13 planes resolved from the
// winning row (raster_common.cuh resolve_winner), and differ in the row
// cap (kept by the wrappers) and in the reference's epilogue: K3g writes
// covered ? buf * inv : 0, K5g buf * (covered ? inv : 0) (sign of zero,
// NaN).  K5g runs the register body: the tile state keeps z and the
// winning row id (the last row that passed; TileState::store_gbuffer).
// ptxas (sm_90a, -O3 -fmad=false): K3/K5 128 registers, K5g 110, no spills.
//
// K3d replaces rasterize_depth_pallas (_depth_kernel, :798), the
// shadow-map pass up to 32768 rows: K3's walk and strict-less test keeping
// z alone, one f32 plane out.
//
// K3g and K3d run the keyed body (raster_keyed.cuh) over the hierarchy
// alone, with the planes of the register body bit for bit.  What bound
// that body on the H100 (1.10 ms each at 1080p and on the 1024^2
// map): each tile walked superblock -> block -> row one dependent load at
// a time, then evaluated every row that meets it at all 4096 pixels, 8.6x
// (10.2x on the map) the pixels of the rows' bboxes; under half the tiles
// hold a row, and the busiest holds 324 (387), one block an SM.  The keyed
// body tests a superblock's blocks and a block's rows in parallel,
// evaluates each row over its window only, and keys each pixel: K3g
// HierGbufKeys ((order bits of z, row id), clear (1.0, 0), whose minimum
// is the strict-less test in row order; the store resolves the winner
// under K3g's epilogue), K3d DepthKeys (visit index = row id: the first
// row of an exact tie keeps its sign).  A tile's hit blocks (those whose
// bbox and superblock's bbox meet it) are cut into `items` work items of
// about equal counts, one CUDA block each, so that the busiest tile's rows
// spread over several SMs: with one item a tile resolves in place (one
// device operation a call), with several the items merge through the
// frame's key plane (memset, items, resolve; a tile of at most one hit
// block still resolves in place).  ops/raster.py HIER_ITEMS holds the
// count, from a sweep on the H100.  Bound on the H100: the window pixels'
// edge work, or for K3g the 13 output planes (109 MB at 1920x1088, 0.032
// ms at 3.35 TB/s).

// K3b replaces rasterize_setup_pallas_band (:976, _band_kernel :967, body
// _kernel_body with row_base): K3 over one horizontal band of a sharded
// frame.  Its grid is the band's tiles; tile i's pixel rows start at
// row_base + i * 32, so the edge functions see global rows, and the band's
// (band_h, W) planes are stored band-local.  The same walk, test and
// inputs as K3 (the gathered setup rows, compacted): its band equals rows
// [row_base, row_base + band_h) of K3's frame.  Bound on the H100: as K3,
// the per-pixel edge work over the band's (tile, triangle) pairs x 4096 x
// 26 ops.

#include "raster_keyed.cuh"

namespace zr {

__global__ void __launch_bounds__(THREADS)
    raster_hier_kernel(const int* __restrict__ supers, int num_supers,
                       const int* __restrict__ blocks,
                       const int* __restrict__ ti,
                       const float* __restrict__ tf, int* __restrict__ color,
                       float* __restrict__ depth, int width) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  TileState<false> st;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
  st.store(color, depth, width);
}

__global__ void __launch_bounds__(THREADS)
    raster_hier_band_kernel(const int* __restrict__ supers, int num_supers,
                            const int* __restrict__ blocks,
                            const int* __restrict__ ti,
                            const float* __restrict__ tf,
                            int* __restrict__ color,
                            float* __restrict__ depth, int width,
                            int row_base) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  TileState<false> st;
  st.init(row_base + (tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
  st.store(color, depth, width, row_base);
}

// K5g: the register body, the GBUF_PLANES planes of out (color bits,
// depth, then the rest), width * height floats apart.
__global__ void __launch_bounds__(THREADS)
    gbuffer_hbm_kernel(const int* __restrict__ supers, int num_supers,
                       const int* __restrict__ blocks,
                       const int* __restrict__ ti,
                       const float* __restrict__ tf, float* __restrict__ out,
                       int width, int height) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  TileState<false, true> st;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
  st.store_gbuffer<true>(ti, tf, out, width, (size_t)width * height);
}

// K3g and K3d take at most 32768 rows (MAX_RESIDENT_ROWS): 256 blocks in 8
// superblocks, one block's bbox a thread.
constexpr int HIER_MAX_SUPERS = THREADS / SUPER_BLOCK;
static_assert(SUPER_BLOCK == 32 && HIER_MAX_SUPERS == WARPS,
              "a warp tests a superblock's blocks");

// The blocks of the hierarchy that meet the tile at (row0, col0), their
// superblock too: warp w tests superblock w and its 32 blocks at once, bit
// j of hits[w] for block 32 w + j.  Returns their count.  Every thread
// calls it.
__device__ __forceinline__ int hier_hit_blocks(
    unsigned* hits, const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int row0, int col0) {
  const int w = (int)threadIdx.x / SUPER_BLOCK;
  bool hit = false;
  if (w < num_supers) {
    const int* sp = supers + (size_t)w * 8;
    const int* bb = blocks + (size_t)threadIdx.x * 8;
    hit = tile_overlap(__ldg(sp), __ldg(sp + 1), __ldg(sp + 2), __ldg(sp + 3),
                       row0, col0) &&
          tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2),
                       __ldg(bb + 3), row0, col0);
  }
  const unsigned m = __ballot_sync(0xffffffffu, hit);
  if (threadIdx.x % SUPER_BLOCK == 0) hits[w] = m;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < HIER_MAX_SUPERS; ++i) total += __popc(hits[i]);
  return total;
}

// K3g and K3d: work item blockIdx.x is item i = blockIdx.x % items of tile
// blockIdx.x / items, and takes the tile's hit blocks [i * H / items,
// (i + 1) * H / items) in row order (H hit blocks), so a busy tile's rows
// spread over its items; an item with none returns at once.  Its rows into
// the shared keys, then out (raster_keyed.cuh keyed_out): the tile's
// planes from the item that holds all its hit blocks (one item a tile, or
// at most one hit block: the last item), else into the key plane.
template <class Mode>
__device__ __forceinline__ void keyed_hier(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height) {
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSmem& s = *reinterpret_cast<KeyedSmem*>(keyed_smem);
  const int tiles_x = width / TILE_W;
  const int tile = (int)blockIdx.x / items, idx = (int)blockIdx.x % items;
  const int row0 = (tile / tiles_x) * TILE_H;
  const int col0 = (tile % tiles_x) * TILE_W;
  const int total =
      hier_hit_blocks(s.hits, supers, num_supers, blocks, row0, col0);
  const int h0 = idx * total / items, h1 = (idx + 1) * total / items;
  const bool alone = items == 1 || (total <= 1 && idx == items - 1);
  if (h0 == h1 && !alone) return;  // block-uniform
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) s.key[p] = Mode::CLEAR;
  __syncthreads();
  int pending = 0, h = 0;  // block-uniform
  for (int w = 0; w < HIER_MAX_SUPERS && h < h1; ++w) {
    for (unsigned m = s.hits[w]; m && h < h1; m &= m - 1, ++h)
      if (h >= h0)
        keyed_block_rows<Mode>(s, w * SUPER_BLOCK + __ffs(m) - 1, pending,
                               ti, tf, 0, row0, col0);
  }
  flush_pending<Mode>(s, pending, ti, tf, 0, row0, col0);
  __syncthreads();
  keyed_out<Mode>(s, alone, plane, row0, col0, ti, tf, color, depth, extra,
                  width, height);
}

// The resolve of a tile of several items whose rows lie in two or more hit
// blocks: the merged keys in the plane.
template <class Mode>
__device__ __forceinline__ void keyed_hier_resolve(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height) {
  __shared__ unsigned hits[HIER_MAX_SUPERS];
  const int tiles_x = width / TILE_W;
  const int row0 = ((int)blockIdx.x / tiles_x) * TILE_H;
  const int col0 = ((int)blockIdx.x % tiles_x) * TILE_W;
  if (hier_hit_blocks(hits, supers, num_supers, blocks, row0, col0) <= 1)
    return;  // resolved in place
  resolve_tile<Mode>(plane, row0, col0, ti, tf, color, depth, extra, width,
                     height);
}

// One entry point per kernel, so each has its own name in a profile.
// K3g: out holds the GBUF_PLANES planes, width * height floats apart.
__global__ void __launch_bounds__(THREADS) gbuffer_hier_keyed_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int height) {
  const size_t frame = (size_t)width * height;
  keyed_hier<HierGbufKeys>(supers, num_supers, blocks, ti, tf, items, plane,
                           reinterpret_cast<int*>(out), out + frame,
                           out + 2 * frame, width, height);
}

__global__ void __launch_bounds__(THREADS) gbuffer_hier_resolve_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ out, int width,
    int height) {
  const size_t frame = (size_t)width * height;
  keyed_hier_resolve<HierGbufKeys>(supers, num_supers, blocks, plane, ti, tf,
                                   reinterpret_cast<int*>(out), out + frame,
                                   out + 2 * frame, width, height);
}

// K3d: the depth plane alone.
__global__ void __launch_bounds__(THREADS) depth_hier_keyed_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int width, int height) {
  keyed_hier<DepthKeys>(supers, num_supers, blocks, ti, tf, items, plane,
                        nullptr, depth, nullptr, width, height);
}

__global__ void __launch_bounds__(THREADS) depth_hier_resolve_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ depth, int width,
    int height) {
  keyed_hier_resolve<DepthKeys>(supers, num_supers, blocks, plane, ti, tf,
                                nullptr, depth, nullptr, width, height);
}

}  // namespace zr

extern "C" int zr_raster_hier(const int* supers, int num_supers,
                              const int* blocks, const int* ti,
                              const float* tf, int* color, float* depth,
                              int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::raster_hier_kernel<<<num_tiles, zr::THREADS, 0,
                           (cudaStream_t)stream>>>(
      supers, num_supers, blocks, ti, tf, color, depth, width);
  return (int)cudaGetLastError();
}

// K3g and K3d launch the keyed body: num_tiles * items blocks, and with
// several items a tile the key plane (height * width keys) set to all ones
// first and the resolve over the tiles after.
template <class Items, class Resolve, class... Out>
static int launch_keyed_hier(Items items_kernel, Resolve resolve_kernel,
                             const int* supers, int num_supers,
                             const int* blocks, const int* ti,
                             const float* tf, int items,
                             unsigned long long* plane, int height, int width,
                             void* stream, Out... out) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = (int)sizeof(zr::KeyedSmem);
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && items > 1)
    err = cudaMemsetAsync(plane, 0xff,
                          (size_t)height * width * sizeof(*plane), s);
  if (err != cudaSuccess) return (int)err;
  items_kernel<<<num_tiles * items, zr::THREADS, smem, s>>>(
      supers, num_supers, blocks, ti, tf, items, plane, out..., width,
      height);
  if (items > 1)
    resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        supers, num_supers, blocks, plane, ti, tf, out..., width, height);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a K3g/K3d work item, in bytes.
extern "C" int zr_keyed_hier_smem_bytes() {
  return (int)sizeof(zr::KeyedSmem);
}

// K3g.
extern "C" int zr_gbuffer_hier(const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, int items,
                               unsigned long long* plane, float* out,
                               int height, int width, void* stream) {
  return launch_keyed_hier(zr::gbuffer_hier_keyed_kernel,
                           zr::gbuffer_hier_resolve_kernel, supers,
                           num_supers, blocks, ti, tf, items, plane, height,
                           width, stream, out);
}

// K5g.
extern "C" int zr_gbuffer_hbm(const int* supers, int num_supers,
                              const int* blocks, const int* ti,
                              const float* tf, float* out, int height,
                              int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::gbuffer_hbm_kernel<<<num_tiles, zr::THREADS, 0,
                           (cudaStream_t)stream>>>(
      supers, num_supers, blocks, ti, tf, out, width, height);
  return (int)cudaGetLastError();
}

// K3d.
extern "C" int zr_depth_hier(const int* supers, int num_supers,
                             const int* blocks, const int* ti,
                             const float* tf, int items,
                             unsigned long long* plane, float* depth,
                             int height, int width, void* stream) {
  return launch_keyed_hier(zr::depth_hier_keyed_kernel,
                           zr::depth_hier_resolve_kernel, supers, num_supers,
                           blocks, ti, tf, items, plane, height, width,
                           stream, depth);
}

// K3b: the band_h rows from global row row_base.
extern "C" int zr_raster_hier_band(const int* supers, int num_supers,
                                   const int* blocks, const int* ti,
                                   const float* tf, int* color, float* depth,
                                   int band_h, int width, int row_base,
                                   void* stream) {
  const int num_tiles = (band_h / zr::TILE_H) * (width / zr::TILE_W);
  zr::raster_hier_band_kernel<<<num_tiles, zr::THREADS, 0,
                                (cudaStream_t)stream>>>(
      supers, num_supers, blocks, ti, tf, color, depth, width, row_base);
  return (int)cudaGetLastError();
}
