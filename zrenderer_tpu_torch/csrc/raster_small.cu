// K1: small-scene binned flat raster; K2g and K2d, its G-buffer and
// depth-only variants.
//
// Replaces rasterize_setup_pallas_small (K1: zrenderer_tpu/ops/
// raster_pallas.py, the _binned_kernel with local_lists=True, body
// _binned_body) and rasterize_gbuffer_pallas_small (K2g: the
// _binned_gbuffer_kernel with local_lists=True, the same body with the
// G-buffer latches and epilogue).  Inputs are
// the outputs of prepare_binned_small (zrenderer_tpu_torch/ops/raster.py):
// per-tile counts, per-tile lists of head-row ids (n_head entries a tile,
// the first counts[tile] live, ascending), the superblock/block bbox tables
// and the setup rows with every head row's bbox emptied, so the hierarchy
// only holds the clipped-fan rows.
//
// What it computes, per 32x128 tile (one CUDA block):
//   phase 1: every row of the tile's list, depth test
//            z >= 0 && (z < zb || (z == zb && t < tb)) - an order-free
//            (z, row id) tie-break, equal to sequential strict-less;
//   phase 2: the fan-tail rows through superblock -> block -> row bbox
//            skips with the same test;
//   resolve: one divide per pixel into packed RGBA8 + f32 depth.
// K2g runs the same phases keeping only z and the winning row id, then
// resolves the 13 G-buffer planes from the winner's row (raster_common.cuh
// TileState::store_gbuffer, epilogue buf * (covered ? 1/den : 0)).
//
// What bounds it on the H100: not device-memory bytes (a 1080p frame's two
// output planes are 16.7 MB, written once), but the per-tile triangle reads
// and the instruction throughput of the per-pixel edge evaluation: every
// listed triangle costs 3 edge functions and a depth test at each of the
// tile's 4096 pixels.  The simple design keeps the tile state in registers
// for the whole loop (no shared-memory or global round trips per
// triangle), stages the tile's list (at most 1024 ids, 4 KB) in shared
// memory once, and lets all 256 threads read each triangle's setup through
// broadcast loads.  Later work: stage setup rows in shared memory, skip
// pixel rows outside a triangle's bbox, persistent blocks.
//
// K2g on the H100: the same loops with two values a pixel in registers,
// plus an epilogue that gathers each pixel's winning row (12 ints, 33
// floats) and writes 13 planes: 109 MB at 1920x1088, about 0.032 ms at
// 3.35 TB/s, which bounds it on a small scene (0.045 ms measured on the
// 1080p test scene, NVIDIA H100 80GB HBM3 at 700 W); the resolve-from-
// winner design is in raster_common.cuh.  ptxas (sm_90a, -O3
// -fmad=false): K1 182 registers, K2g 109, no spills.
//
// K2d replaces rasterize_depth_pallas_small (the _binned_depth_kernel with
// local_lists=True: _binned_body with depth_only, :1271-1273, :1431-1433),
// the shadow-map pass of small scenes: the same two phases with z alone
// under the strict-less test (raster_common.cuh TileState::DEPTH), list
// rows in ascending id order, then the fan-tail hierarchy; one f32 plane
// out.  On a shadow map the list walk and the edge evaluation bound it, as
// K1; the output is 4 MB at 1024x1024.

#include "raster_common.cuh"

namespace zr {

constexpr int SMALL_MAX_LIST = 1024;  // raster.SMALL_BIN_MAX_ROWS

// Phase 1 (the tile's list) and phase 2 (the fan-tail hierarchy).
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
    raster_small_kernel(const int* __restrict__ counts,
                        const int* __restrict__ lists, int n_head,
                        const int* __restrict__ supers, int num_supers,
                        const int* __restrict__ blocks,
                        const int* __restrict__ ti,
                        const float* __restrict__ tf, int* __restrict__ color,
                        float* __restrict__ depth, int width) {
  TileState<true> st;
  small_scan(st, counts, lists, n_head, supers, num_supers, blocks, ti, tf,
             width);
  st.store(color, depth, width);
}

__global__ void __launch_bounds__(THREADS)
    gbuffer_small_kernel(const int* __restrict__ counts,
                         const int* __restrict__ lists, int n_head,
                         const int* __restrict__ supers, int num_supers,
                         const int* __restrict__ blocks,
                         const int* __restrict__ ti,
                         const float* __restrict__ tf,
                         float* __restrict__ out, int width, int height) {
  TileState<true, true> st;
  small_scan(st, counts, lists, n_head, supers, num_supers, blocks, ti, tf,
             width);
  st.store_gbuffer<true>(ti, tf, out, width, (size_t)width * height);
}

__global__ void __launch_bounds__(THREADS)
    depth_small_kernel(const int* __restrict__ counts,
                       const int* __restrict__ lists, int n_head,
                       const int* __restrict__ supers, int num_supers,
                       const int* __restrict__ blocks,
                       const int* __restrict__ ti,
                       const float* __restrict__ tf,
                       float* __restrict__ depth, int width) {
  TileState<false, false, true> st;
  small_scan(st, counts, lists, n_head, supers, num_supers, blocks, ti, tf,
             width);
  st.store_depth(depth, width);
}

}  // namespace zr

extern "C" int zr_raster_small(const int* counts, const int* lists,
                               int n_head, const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, int* color, float* depth,
                               int height, int width, void* stream) {
  if (n_head > zr::SMALL_MAX_LIST) return (int)cudaErrorInvalidValue;
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::raster_small_kernel<<<num_tiles, zr::THREADS, 0,
                            (cudaStream_t)stream>>>(
      counts, lists, n_head, supers, num_supers, blocks, ti, tf, color, depth,
      width);
  return (int)cudaGetLastError();
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
  if (n_head > zr::SMALL_MAX_LIST) return (int)cudaErrorInvalidValue;
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::depth_small_kernel<<<num_tiles, zr::THREADS, 0,
                           (cudaStream_t)stream>>>(
      counts, lists, n_head, supers, num_supers, blocks, ti, tf, depth,
      width);
  return (int)cudaGetLastError();
}

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
