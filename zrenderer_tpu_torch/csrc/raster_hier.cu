// The hierarchy rasters: K3 and K5 (flat), K3g and K5g (G-buffer), K3d
// (depth only) and K3b (K3 over one band of a sharded frame).
//
// K3 replaces rasterize_setup_pallas (zrenderer_tpu/ops/raster_pallas.py,
// _raster_kernel, body _kernel_body), K5 rasterize_setup_pallas_hbm
// (_hbm_kernel, body _hbm_kernel_body).  The two differ only in TPU memory
// placement (VMEM-resident rows, or rows streamed from HBM in block
// slabs); here both read their rows from global memory at any row count,
// and K3's wrapper keeps its 32768-row cap.  Inputs are the outputs of
// prepare_raster_inputs (zrenderer_tpu_torch/ops/raster.py): the live rows
// stable-compacted to the front (submission order kept), padded to
// RASTER_BLOCK, plus the block and superblock union-bbox tables.
//
// What each computes, per 32x128 tile: the rows in submission order,
// skipping a superblock (4096 rows), a block (128 rows) or a row whose
// bbox misses the tile, with the sequential strict-less depth test z >= 0
// && z < zb; then one divide per pixel into packed RGBA8 + f32 depth (K3,
// K3b, K5), the 13 planes resolved from the winning row (K3g, K5g;
// raster_common.cuh resolve_winner), or the f32 depth plane alone (K3d).
//
// K3g and K5g replace rasterize_gbuffer_pallas (K3g: _gbuffer_kernel, body
// _kernel_body with the G-buffer scratch) and rasterize_gbuffer_pallas_hbm
// (K5g: _hbm_gbuffer_kernel, body _hbm_kernel_body); they differ in the
// reference's epilogue: K3g writes covered ? buf * inv : 0, K5g buf *
// (covered ? inv : 0) (sign of zero, NaN).  K3d replaces
// rasterize_depth_pallas (_depth_kernel, :798), the shadow-map pass up to
// 32768 rows.  K3b replaces rasterize_setup_pallas_band (:976, _band_kernel
// :967, body _kernel_body with row_base): the band_h rows from global row
// row_base, with the same walk, test and inputs as K3 (the gathered setup
// rows, compacted), so its band equals rows [row_base, row_base + band_h)
// of K3's frame (of K5's above 32768 rows; K3b has no row cap).
//
// Which body each runs:
// * K5 and K5g: the register body (raster_common.cuh TileState, one CUDA
//   block a tile keeping the tile state in registers across the
//   superblock -> block -> row walk; K5g keeps z and the winning row id,
//   the last row that passed, and resolves through TileState::
//   store_gbuffer).  ptxas (sm_90a, -O3 -fmad=false): K5 128 registers,
//   K5g 108-110, no spills.
// * K3, K3b, K3g and K3d: the keyed body (raster_keyed.cuh) over the
//   hierarchy alone (keyed_hier), with the register body's planes bit for
//   bit.  What bound the register body on the H100 (K3 1.00 ms, K3b 0.93
//   ms a band of 2, K3g and K3d 1.10 ms each at 1080p and on the 1024^2
//   map): each tile walked superblock -> block -> row one dependent load
//   at a time, then evaluated every row that meets it at all 4096 pixels,
//   8.6x (10.2x on the map) the pixels of the rows' bboxes; under half the
//   tiles hold a row, and the busiest holds 324 (387), one block an SM.
//   The keyed body tests a group of 8 superblocks' blocks and a block's
//   rows in parallel, evaluates each row over its window only, and keys
//   each pixel: K3 and K3b HierFlatKeys, K3g HierGbufKeys ((order bits of
//   z, row id), clear (1.0, 0), whose minimum is the strict-less test in
//   row order; the store resolves the winner, K3g's under its epilogue),
//   K3d DepthKeys (visit index = row id: the first row of an exact tie
//   keeps its sign).  A tile's hit blocks (those whose bbox and
//   superblock's bbox meet it) are cut into `items` work items of about
//   equal counts, one CUDA block each, so that the busiest tile's rows
//   spread over several SMs: with one item a tile resolves in place (one
//   device operation a call), with several the items merge through the key
//   plane of the output's size (memset, items, resolve; a tile of at most
//   one hit block still resolves in place).  ops/raster.py HIER_ITEMS
//   holds the count, from a sweep on the H100.  Bound on the H100: the
//   window pixels' edge work, or the output planes and the winners' rows
//   (K3g: 13 planes, 109 MB at 1920x1088, 0.032 ms at 3.35 TB/s).
//
// The walk takes any number of superblocks: they are tested in groups of
// WARPS (warp w tests superblock WARPS g + w of group g and its 32 blocks
// at once).  A first pass counts a tile's hit blocks over every group; a
// work item then walks its share of them, recomputing each group's hit
// words (with one group, up to 32768 rows, the count's words serve).

#include "raster_keyed.cuh"

namespace zr {

// K5: the register body over any number of rows.
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

static_assert(SUPER_BLOCK == 32 && THREADS == WARPS * SUPER_BLOCK,
              "a warp tests a superblock's blocks");

// The blocks of superblock group g that meet the tile at (row0, col0),
// their superblock too: warp w tests superblock WARPS g + w and its 32
// blocks at once, bit j of hits[w] for its block j.  Returns their count.
// Every thread calls it; a caller that calls it again syncs the block
// first, as the words are read by every thread.
__device__ __forceinline__ int hier_group_hits(
    unsigned* hits, const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int g, int row0, int col0) {
  const int w = (int)threadIdx.x / SUPER_BLOCK;
  const int sb = g * WARPS + w;
  bool hit = false;
  if (sb < num_supers) {
    const int* sp = supers + (size_t)sb * 8;
    const int* bb = blocks + ((size_t)g * THREADS + threadIdx.x) * 8;
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
  for (int i = 0; i < WARPS; ++i) total += __popc(hits[i]);
  return total;
}

// The number of superblock groups of num_supers superblocks.
__device__ __forceinline__ int hier_groups(int num_supers) {
  return (num_supers + WARPS - 1) / WARPS;
}

// The tile's hit blocks over every group; hits holds the last group's
// words after it.  Every thread calls it.
__device__ __forceinline__ int hier_hit_count(
    unsigned* hits, const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int row0, int col0) {
  int total = 0;
  for (int g = 0; g < hier_groups(num_supers); ++g) {
    if (g > 0) __syncthreads();  // the previous group's words read
    total += hier_group_hits(hits, supers, num_supers, blocks, g, row0, col0);
  }
  return total;
}

// K3, K3b, K3g and K3d: work item blockIdx.x is item i = blockIdx.x % items
// of tile blockIdx.x / items, and takes the tile's hit blocks [i * H /
// items, (i + 1) * H / items) in row order (H hit blocks), so a busy
// tile's rows spread over its items; an item with none returns at once.
// Its rows into the shared keys, then out (raster_keyed.cuh keyed_out):
// the tile's planes from the item that holds all its hit blocks (one item
// a tile, or at most one hit block: the last item), else into the key
// plane.  The tiles are those of the height rows from global row row_base
// (a band's; 0 for a frame).
template <class Mode>
__device__ __forceinline__ void keyed_hier(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height, int row_base) {
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSmem& s = *reinterpret_cast<KeyedSmem*>(keyed_smem);
  const int tiles_x = width / TILE_W;
  const int tile = (int)blockIdx.x / items, idx = (int)blockIdx.x % items;
  const int row0 = row_base + (tile / tiles_x) * TILE_H;
  const int col0 = (tile % tiles_x) * TILE_W;
  const int groups = hier_groups(num_supers);
  const int total =
      hier_hit_count(s.hits, supers, num_supers, blocks, row0, col0);
  const int h0 = idx * total / items, h1 = (idx + 1) * total / items;
  const bool alone = items == 1 || (total <= 1 && idx == items - 1);
  if (h0 == h1 && !alone) return;  // block-uniform
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) s.key[p] = Mode::CLEAR;
  // The keys cleared before the first batch: here with one group, else by
  // hier_group_hits' own sync.
  if (groups == 1) __syncthreads();
  int pending = 0, h = 0;  // block-uniform
  for (int g = 0; g < groups && h < h1; ++g) {
    if (groups > 1) {  // else the count's words serve
      __syncthreads();  // every thread past the previous words
      const int n =
          hier_group_hits(s.hits, supers, num_supers, blocks, g, row0, col0);
      if (h + n <= h0) {  // the item's share starts past this group
        h += n;
        continue;
      }
    }
    for (int w = 0; w < WARPS && h < h1; ++w) {
      for (unsigned m = s.hits[w]; m && h < h1; m &= m - 1, ++h)
        if (h >= h0)
          keyed_block_rows<Mode>(s, (g * WARPS + w) * SUPER_BLOCK +
                                        __ffs(m) - 1,
                                 pending, ti, tf, 0, row0, col0);
    }
  }
  flush_pending<Mode>(s, pending, ti, tf, 0, row0, col0);
  __syncthreads();
  keyed_out<Mode>(s, alone, plane, row0, col0, ti, tf, color, depth, extra,
                  width, height, row_base);
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
    int height, int row_base) {
  __shared__ unsigned hits[WARPS];
  const int tiles_x = width / TILE_W;
  const int row0 = row_base + ((int)blockIdx.x / tiles_x) * TILE_H;
  const int col0 = ((int)blockIdx.x % tiles_x) * TILE_W;
  if (hier_hit_count(hits, supers, num_supers, blocks, row0, col0) <= 1)
    return;  // resolved in place
  resolve_tile<Mode>(plane, row0, col0, ti, tf, color, depth, extra, width,
                     height, row_base);
}

// One entry point per kernel, so each has its own name in a profile.  Each
// takes (..., width, height, row_base); K3, K3g and K3d draw a frame
// (row_base 0), K3b a band of height rows.
// K3: packed colour and depth.
__global__ void __launch_bounds__(THREADS) raster_hier_keyed_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier<HierFlatKeys>(supers, num_supers, blocks, ti, tf, items, plane,
                           color, depth, nullptr, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) raster_hier_resolve_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier_resolve<HierFlatKeys>(supers, num_supers, blocks, plane, ti, tf,
                                   color, depth, nullptr, width, height,
                                   row_base);
}

// K3b: K3's body over a band.
__global__ void __launch_bounds__(THREADS) raster_hier_band_keyed_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier<HierFlatKeys>(supers, num_supers, blocks, ti, tf, items, plane,
                           color, depth, nullptr, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) raster_hier_band_resolve_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier_resolve<HierFlatKeys>(supers, num_supers, blocks, plane, ti, tf,
                                   color, depth, nullptr, width, height,
                                   row_base);
}

// K3g: out holds the GBUF_PLANES planes, width * height floats apart.
__global__ void __launch_bounds__(THREADS) gbuffer_hier_keyed_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_hier<HierGbufKeys>(supers, num_supers, blocks, ti, tf, items, plane,
                           reinterpret_cast<int*>(out), out + frame,
                           out + 2 * frame, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) gbuffer_hier_resolve_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ out, int width,
    int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_hier_resolve<HierGbufKeys>(supers, num_supers, blocks, plane, ti, tf,
                                   reinterpret_cast<int*>(out), out + frame,
                                   out + 2 * frame, width, height, row_base);
}

// K3d: the depth plane alone.
__global__ void __launch_bounds__(THREADS) depth_hier_keyed_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int width, int height, int row_base) {
  keyed_hier<DepthKeys>(supers, num_supers, blocks, ti, tf, items, plane,
                        nullptr, depth, nullptr, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) depth_hier_resolve_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ depth, int width,
    int height, int row_base) {
  keyed_hier_resolve<DepthKeys>(supers, num_supers, blocks, plane, ti, tf,
                                nullptr, depth, nullptr, width, height,
                                row_base);
}

}  // namespace zr

// K5.
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

// K3, K3b, K3g and K3d launch the keyed body over the height rows from
// global row row_base: num_tiles * items blocks, and with several items a
// tile the key plane (height * width keys) set to all ones first and the
// resolve over the tiles after.
template <class Items, class Resolve, class... Out>
static int launch_keyed_hier(Items items_kernel, Resolve resolve_kernel,
                             const int* supers, int num_supers,
                             const int* blocks, const int* ti,
                             const float* tf, int items,
                             unsigned long long* plane, int height, int width,
                             int row_base, void* stream, Out... out) {
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
      height, row_base);
  if (items > 1)
    resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        supers, num_supers, blocks, plane, ti, tf, out..., width, height,
        row_base);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a K3/K3b/K3g/K3d work item, in bytes.
extern "C" int zr_keyed_hier_smem_bytes() {
  return (int)sizeof(zr::KeyedSmem);
}

// K3.
extern "C" int zr_raster_hier_keyed(const int* supers, int num_supers,
                                    const int* blocks, const int* ti,
                                    const float* tf, int items,
                                    unsigned long long* plane, int* color,
                                    float* depth, int height, int width,
                                    void* stream) {
  return launch_keyed_hier(zr::raster_hier_keyed_kernel,
                           zr::raster_hier_resolve_kernel, supers,
                           num_supers, blocks, ti, tf, items, plane, height,
                           width, 0, stream, color, depth);
}

// K3b: the band_h rows from global row row_base.
extern "C" int zr_raster_hier_band_keyed(const int* supers, int num_supers,
                                         const int* blocks, const int* ti,
                                         const float* tf, int items,
                                         unsigned long long* plane,
                                         int* color, float* depth,
                                         int band_h, int width, int row_base,
                                         void* stream) {
  return launch_keyed_hier(zr::raster_hier_band_keyed_kernel,
                           zr::raster_hier_band_resolve_kernel, supers,
                           num_supers, blocks, ti, tf, items, plane, band_h,
                           width, row_base, stream, color, depth);
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
                           width, 0, stream, out);
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
                           blocks, ti, tf, items, plane, height, width, 0,
                           stream, depth);
}
