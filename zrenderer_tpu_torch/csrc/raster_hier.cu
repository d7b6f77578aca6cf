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
// (K5g: _hbm_gbuffer_kernel, body _hbm_kernel_body).  One tile body: the
// same walk and strict-less test keeping z and the winning row id (the
// last row that passed), then the 13 planes resolved from the winner
// (raster_common.cuh TileState::store_gbuffer).  The two differ only in
// the row cap (kept by the wrappers) and in the reference's epilogue:
// K3g writes covered ? buf * inv : 0, K5g buf * (covered ? inv : 0); the
// template flag keeps each one's bits (sign of zero, NaN).  Bound on the
// H100: K3's per-pixel edge work over the (tile, triangle) pairs, or on a
// sparse frame the 13 output planes (109 MB at 1920x1088, 0.032 ms at
// 3.35 TB/s).  ptxas (sm_90a, -O3 -fmad=false): K3/K5 128 registers, K3g
// 106, K5g 110, no spills.
//
// K3d replaces rasterize_depth_pallas (_depth_kernel, :798), the shadow-map
// pass up to 32768 rows: K3's walk and strict-less test keeping z alone
// (raster_common.cuh TileState::DEPTH), one f32 plane out.  Bound on the
// H100: K3's per-pixel edge work over the (tile, triangle) pairs of the
// shadow map.

// K3b replaces rasterize_setup_pallas_band (:976, _band_kernel :967, body
// _kernel_body with row_base): K3 over one horizontal band of a sharded
// frame.  Its grid is the band's tiles; tile i's pixel rows start at
// row_base + i * 32, so the edge functions see global rows, and the band's
// (band_h, W) planes are stored band-local.  The same walk, test and
// inputs as K3 (the gathered setup rows, compacted): its band equals rows
// [row_base, row_base + band_h) of K3's frame.  Bound on the H100: as K3,
// the per-pixel edge work over the band's (tile, triangle) pairs x 4096 x
// 26 ops.

#include "raster_common.cuh"

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

template <bool MASKED_INV>
__device__ __forceinline__ void gbuffer_hier_tile(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ out, int width,
    int height) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  TileState<false, true> st;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
  st.template store_gbuffer<MASKED_INV>(ti, tf, out, width,
                                        (size_t)width * height);
}

// One entry point per kernel, so each has its own name in a profile.
__global__ void __launch_bounds__(THREADS)
    gbuffer_hier_kernel(const int* __restrict__ supers, int num_supers,
                        const int* __restrict__ blocks,
                        const int* __restrict__ ti,
                        const float* __restrict__ tf,
                        float* __restrict__ out, int width, int height) {
  gbuffer_hier_tile<false>(supers, num_supers, blocks, ti, tf, out, width,
                           height);
}

__global__ void __launch_bounds__(THREADS)
    gbuffer_hbm_kernel(const int* __restrict__ supers, int num_supers,
                       const int* __restrict__ blocks,
                       const int* __restrict__ ti,
                       const float* __restrict__ tf, float* __restrict__ out,
                       int width, int height) {
  gbuffer_hier_tile<true>(supers, num_supers, blocks, ti, tf, out, width,
                          height);
}

__global__ void __launch_bounds__(THREADS)
    depth_hier_kernel(const int* __restrict__ supers, int num_supers,
                      const int* __restrict__ blocks,
                      const int* __restrict__ ti,
                      const float* __restrict__ tf,
                      float* __restrict__ depth, int width) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  TileState<false, false, true> st;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
  st.store_depth(depth, width);
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

// K3g.
extern "C" int zr_gbuffer_hier(const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, float* out, int height,
                               int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::gbuffer_hier_kernel<<<num_tiles, zr::THREADS, 0,
                            (cudaStream_t)stream>>>(
      supers, num_supers, blocks, ti, tf, out, width, height);
  return (int)cudaGetLastError();
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
                             const float* tf, float* depth, int height,
                             int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::depth_hier_kernel<<<num_tiles, zr::THREADS, 0,
                          (cudaStream_t)stream>>>(
      supers, num_supers, blocks, ti, tf, depth, width);
  return (int)cudaGetLastError();
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
