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
// 32768 rows; above them K5's depth plane serves (rasterize_depth_hbm,
// the first row of an exact tie keeping its sign).  K3b replaces
// rasterize_setup_pallas_band (:976, _band_kernel :967, body _kernel_body
// with row_base): the band_h rows from global row row_base, with the same
// walk, test and inputs as K3 (the gathered setup rows, compacted), so its
// band equals rows [row_base, row_base + band_h) of K3's frame (of K5's
// above 32768 rows; K3b has no row cap).
//
// Every kernel here runs the keyed body (raster_keyed.cuh) over the
// hierarchy alone, with the planes of the register body it replaced bit
// for bit.  What bound that body on the H100 (K3 1.00 ms, K3b 0.93 ms a
// band of 2, K3g and K3d 1.10 ms each on lattice20k and its 1024^2 map, K5
// 13.27 ms and K5g 14.59 ms on lattice1M): one CUDA block a 32x128 tile
// walked superblock -> block -> row one dependent load at a time, then
// evaluated every row that meets the tile at all 4096 pixels, 8.6x (10.2x
// on the map) the pixels of the rows' bboxes; under half the tiles hold a
// row, and the busiest holds 324 (387), one block an SM.  The keyed body
// tests a superblock's 32 blocks and a block's rows in parallel, evaluates
// each row over its window only, and keys each pixel: K3, K3b and K5
// HierFlatKeys, K3g HierGbufKeys and K5g HbmGbufKeys ((order bits of z,
// row id), clear (1.0, 0), whose minimum is the strict-less test in row
// order; the store resolves the winner, K3g's under covered ? buf * 1/den
// : 0, K5g's under buf * (covered ? 1/den : 0)), K3d DepthKeys (visit
// index = row id: the first row of an exact tie keeps its sign).  A
// tile's hit blocks (those whose bbox and superblock's bbox meet it) are
// cut into `items` work items of about equal counts, one CUDA block each,
// so that the busiest tile's rows spread over several SMs: with one item a
// tile resolves in place, with several the items merge through the key
// plane of the output's size (memset, items, resolve; a tile of at most
// one hit block still resolves in place).  ops/raster.py HIER_ITEMS holds
// the count, from a sweep on the H100.  Bound on the H100: the window
// pixels' edge work, or the output planes and the winners' rows (K3g: 13
// planes, 109 MB at 1920x1088, 0.032 ms at 3.35 TB/s).
//
// The walk, at any superblock count (13 on lattice40k's band, 268 at 1M
// rows): a first kernel writes each tile's hit words once a call (warp w
// tests superblocks w, w + WARPS, ..., whose loads do not wait on one
// another) and, per superblock, the tile's hit blocks before it.  An item
// finds the superblock of its share's first block from those counts, then
// reads the words from there; the resolve reads the tile's count.
// Walking the superblocks in groups of WARPS inside each item instead
// tested each of the 34 groups of lattice1M twice in each of a tile's
// items, one dependent group after another.

#include "raster_keyed.cuh"

namespace zr {

// Block blockIdx.x writes the hit words of its tile (of the height rows
// from global row row_base; raster_keyed.cuh tile_hit_words).
__global__ void __launch_bounds__(THREADS) hier_hit_words_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int* buf, int width, int height,
    int row_base) {
  __shared__ int warp_sums[WARPS];
  const int tiles_x = width / TILE_W, tile = (int)blockIdx.x;
  tile_hit_words(supers, num_supers, blocks, buf,
                 tiles_x * (height / TILE_H), tile,
                 row_base + (tile / tiles_x) * TILE_H,
                 (tile % tiles_x) * TILE_W, warp_sums);
}

// Work item blockIdx.x is item i = blockIdx.x % items of tile blockIdx.x /
// items, and takes the tile's hit blocks [i * H / items, (i + 1) * H /
// items) in row order (H hit blocks), so a busy tile's rows spread over its
// items; an item with none returns at once.  It reads them from the hit
// words (raster_keyed.cuh walk_hit_blocks).  Its rows into the shared keys,
// then out (raster_keyed.cuh keyed_out): the tile's planes from the item
// that holds all its hit blocks (one item a tile, or at most one hit
// block: the last item), else into the key plane.  The tiles are those of
// the height rows from global row row_base (a band's; 0 for a frame).
template <class Mode>
__device__ __forceinline__ void keyed_hier(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ ti,
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
  const HitWords<const int> hw =
      hit_words(buf, tiles_x * (height / TILE_H), num_supers);
  const int* words = hw.words + (size_t)tile * num_supers;
  const int* before = hw.before + (size_t)tile * num_supers;
  const int total = __ldg(hw.count + tile);
  const int h0 = idx * total / items, h1 = (idx + 1) * total / items;
  const bool alone = items == 1 || (total <= 1 && idx == items - 1);
  if (h0 == h1 && !alone) return;  // block-uniform
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) s.key[p] = Mode::CLEAR;
  int pending = 0;  // block-uniform; the walk's barriers order the clear
  walk_hit_blocks(s, words, before, num_supers, total, h0, h1, [&](int b) {
    keyed_block_rows<Mode>(s, b, pending, ti, tf, 0, row0, col0);
  });
  flush_pending<Mode>(s, pending, ti, tf, 0, row0, col0);
  __syncthreads();
  keyed_out<Mode>(s, alone, plane, row0, col0, ti, tf, color, depth, extra,
                  width, height, row_base);
}

// The resolve of a tile of several items whose rows lie in two or more hit
// blocks, its count read from the hit words.
template <class Mode>
__device__ __forceinline__ void keyed_hier_resolve(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height, int row_base) {
  const int tiles_x = width / TILE_W, tiles = tiles_x * (height / TILE_H);
  const int tile = (int)blockIdx.x;
  if (__ldg(hit_words(buf, tiles, num_supers).count + tile) <= 1)
    return;  // resolved in place
  resolve_tile<Mode>(plane, row_base + (tile / tiles_x) * TILE_H,
                     (tile % tiles_x) * TILE_W, ti, tf, color, depth, extra,
                     width, height, row_base);
}

// One entry point per kernel, so each has its own name in a profile.  Each
// takes (..., width, height, row_base); K3, K3g, K3d, K5 and K5g draw a
// frame (row_base 0), K3b a band of height rows.
// K3: packed colour and depth.
__global__ void __launch_bounds__(THREADS) raster_hier_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier<HierFlatKeys>(buf, num_supers, ti, tf, items, plane, color,
                           depth, nullptr, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) raster_hier_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier_resolve<HierFlatKeys>(buf, num_supers, plane, ti, tf, color,
                                   depth, nullptr, width, height, row_base);
}

// K3b: K3's body over a band.
__global__ void __launch_bounds__(THREADS) raster_hier_band_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier<HierFlatKeys>(buf, num_supers, ti, tf, items, plane, color,
                           depth, nullptr, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) raster_hier_band_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier_resolve<HierFlatKeys>(buf, num_supers, plane, ti, tf, color,
                                   depth, nullptr, width, height, row_base);
}

// K3g: out holds the GBUF_PLANES planes, width * height floats apart.
__global__ void __launch_bounds__(THREADS) gbuffer_hier_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_hier<HierGbufKeys>(buf, num_supers, ti, tf, items, plane,
                     reinterpret_cast<int*>(out), out + frame,
                     out + 2 * frame, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) gbuffer_hier_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ out, int width,
    int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_hier_resolve<HierGbufKeys>(buf, num_supers, plane, ti, tf,
                             reinterpret_cast<int*>(out), out + frame,
                             out + 2 * frame, width, height, row_base);
}

// K3d: the depth plane alone.
__global__ void __launch_bounds__(THREADS) depth_hier_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int width, int height, int row_base) {
  keyed_hier<DepthKeys>(buf, num_supers, ti, tf, items, plane, nullptr,
                        depth, nullptr, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) depth_hier_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ depth, int width,
    int height, int row_base) {
  keyed_hier_resolve<DepthKeys>(buf, num_supers, plane, ti, tf, nullptr,
                                depth, nullptr, width, height, row_base);
}

// K5: K3's store, at any row count.
__global__ void __launch_bounds__(THREADS) raster_hbm_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier<HierFlatKeys>(buf, num_supers, ti, tf, items, plane, color,
                           depth, nullptr, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) raster_hbm_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_hier_resolve<HierFlatKeys>(buf, num_supers, plane, ti, tf, color,
                                   depth, nullptr, width, height, row_base);
}

// K5g: K5's rows, the GBUF_PLANES planes of out under K5g's epilogue.
__global__ void __launch_bounds__(THREADS) gbuffer_hbm_keyed_kernel(
    const int* __restrict__ buf, int num_supers, const int* __restrict__ ti,
    const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_hier<HbmGbufKeys>(buf, num_supers, ti, tf, items, plane,
                     reinterpret_cast<int*>(out), out + frame,
                     out + 2 * frame, width, height, row_base);
}

__global__ void __launch_bounds__(THREADS) gbuffer_hbm_resolve_kernel(
    const int* __restrict__ buf, int num_supers,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ out, int width,
    int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_hier_resolve<HbmGbufKeys>(buf, num_supers, plane, ti, tf,
                             reinterpret_cast<int*>(out), out + frame,
                             out + 2 * frame, width, height, row_base);
}

}  // namespace zr

// Every kernel here launches the hit words' kernel over the height rows
// from global row row_base, then the keyed body over them: num_tiles *
// items blocks, and with several items a tile the key plane (height *
// width keys) set to all ones first and the resolve over the tiles after.
// buf: tiles * (2 num_supers + 1) ints.
template <class Items, class Resolve, class... Out>
static int launch_keyed_hier(Items items_kernel, Resolve resolve_kernel,
                             const int* supers, int num_supers,
                             const int* blocks, const int* ti,
                             const float* tf, int items, int* buf,
                             unsigned long long* plane, int height, int width,
                             int row_base, void* stream, Out... out) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = (int)sizeof(zr::KeyedSmem);
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  zr::hier_hit_words_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
      supers, num_supers, blocks, buf, width, height, row_base);
  if (items > 1) {
    err = cudaMemsetAsync(plane, 0xff,
                          (size_t)height * width * sizeof(*plane), s);
    if (err != cudaSuccess) return (int)err;
  }
  items_kernel<<<num_tiles * items, zr::THREADS, smem, s>>>(
      buf, num_supers, ti, tf, items, plane, out..., width, height,
      row_base);
  if (items > 1)
    resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        buf, num_supers, plane, ti, tf, out..., width, height, row_base);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a K3/K3b/K3g/K3d/K5/K5g work item, in bytes.
extern "C" int zr_keyed_hier_smem_bytes() {
  return (int)sizeof(zr::KeyedSmem);
}

// K3.
extern "C" int zr_raster_hier_keyed(const int* supers, int num_supers,
                                    const int* blocks, const int* ti,
                                    const float* tf, int items, int* buf,
                                    unsigned long long* plane, int* color,
                                    float* depth, int height, int width,
                                    void* stream) {
  return launch_keyed_hier(zr::raster_hier_keyed_kernel,
                           zr::raster_hier_resolve_kernel, supers,
                           num_supers, blocks, ti, tf, items, buf, plane,
                           height, width, 0, stream, color, depth);
}

// K3b: the band_h rows from global row row_base.
extern "C" int zr_raster_hier_band_keyed(const int* supers, int num_supers,
                                         const int* blocks, const int* ti,
                                         const float* tf, int items,
                                         int* buf, unsigned long long* plane,
                                         int* color, float* depth,
                                         int band_h, int width, int row_base,
                                         void* stream) {
  return launch_keyed_hier(zr::raster_hier_band_keyed_kernel,
                           zr::raster_hier_band_resolve_kernel, supers,
                           num_supers, blocks, ti, tf, items, buf, plane,
                           band_h, width, row_base, stream, color, depth);
}

// K3g.
extern "C" int zr_gbuffer_hier(const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, int items, int* buf,
                               unsigned long long* plane, float* out,
                               int height, int width, void* stream) {
  return launch_keyed_hier(zr::gbuffer_hier_keyed_kernel,
                           zr::gbuffer_hier_resolve_kernel, supers,
                           num_supers, blocks, ti, tf, items, buf, plane,
                           height, width, 0, stream, out);
}

// K3d.
extern "C" int zr_depth_hier(const int* supers, int num_supers,
                             const int* blocks, const int* ti,
                             const float* tf, int items, int* buf,
                             unsigned long long* plane, float* depth,
                             int height, int width, void* stream) {
  return launch_keyed_hier(zr::depth_hier_keyed_kernel,
                           zr::depth_hier_resolve_kernel, supers, num_supers,
                           blocks, ti, tf, items, buf, plane, height, width,
                           0, stream, depth);
}

// K5.
extern "C" int zr_raster_hier(const int* supers, int num_supers,
                              const int* blocks, const int* ti,
                              const float* tf, int items, int* buf,
                              unsigned long long* plane, int* color,
                              float* depth, int height, int width,
                              void* stream) {
  return launch_keyed_hier(zr::raster_hbm_keyed_kernel,
                           zr::raster_hbm_resolve_kernel, supers, num_supers,
                           blocks, ti, tf, items, buf, plane, height, width,
                           0, stream, color, depth);
}

// K5g.
extern "C" int zr_gbuffer_hbm(const int* supers, int num_supers,
                              const int* blocks, const int* ti,
                              const float* tf, int items, int* buf,
                              unsigned long long* plane, float* out,
                              int height, int width, void* stream) {
  return launch_keyed_hier(zr::gbuffer_hbm_keyed_kernel,
                           zr::gbuffer_hbm_resolve_kernel, supers,
                           num_supers, blocks, ti, tf, items, buf, plane,
                           height, width, 0, stream, out);
}
