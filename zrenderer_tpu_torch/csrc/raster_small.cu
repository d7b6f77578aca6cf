// K1: small-scene binned flat raster.
//
// Replaces rasterize_setup_pallas_small (zrenderer_tpu/ops/raster_pallas.py,
// the _binned_kernel with local_lists=True, body _binned_body).  Inputs are
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

#include "raster_common.cuh"

namespace zr {

constexpr int SMALL_MAX_LIST = 1024;  // raster.SMALL_BIN_MAX_ROWS

__global__ void __launch_bounds__(THREADS)
    raster_small_kernel(const int* __restrict__ counts,
                        const int* __restrict__ lists, int n_head,
                        const int* __restrict__ supers, int num_supers,
                        const int* __restrict__ blocks,
                        const int* __restrict__ ti,
                        const float* __restrict__ tf, int* __restrict__ color,
                        float* __restrict__ depth, int width) {
  __shared__ int s_list[SMALL_MAX_LIST];
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  const int n = counts[tile];
  const int* lst = lists + (size_t)tile * n_head;
  for (int k = threadIdx.x; k < n; k += THREADS) s_list[k] = lst[k];
  __syncthreads();

  TileState<true> st;
  st.init((tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  for (int k = 0; k < n; ++k) st.eval(ti, tf, s_list[k]);
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
  st.store(color, depth, width);
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

extern "C" const char* zr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
