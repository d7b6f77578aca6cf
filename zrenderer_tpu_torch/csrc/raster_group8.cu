// K10g8, K10g8g and K10g8d: the group-tile binned raster, flat, G-buffer
// and depth-only.
//
// Replaces rasterize_setup_pallas_group8, rasterize_gbuffer_pallas_group8
// and rasterize_depth_pallas_group8
// (zrenderer_tpu/ops/experiments/raster_group8.py, _run :650, body
// _group8_body :259).  Inputs are the outputs of prepare_group8_inputs
// (zrenderer_tpu_torch/ops/experiments/raster_group8.py): per 8x128 tile a
// span [offs[t], offs[t+1]) of list rows (ROW_LANES int32 lanes, sorted by
// row id), a per-tile gate tile_any, the leftover setup rows (listed rows'
// bboxes emptied) and their block, superblock and megablock union bboxes.
//
// What it computes, per 8x128 tile (one CUDA block of 256 threads, each
// owning one column and 4 rows: r0, r0 + 2, r0 + 4, r0 + 6):
// * phase 1: the tile's span, staged in shared memory STAGE rows at a
//   time; each row evaluated at the thread's pixels with the list row's
//   edge form e = (dx*py + c) - dy*px, c = dy*x_ref - dx*y_ref (wrapping
//   like the reference's int32: computed in uint32_t), and its bias bits;
// * phase 2, if tile_any: megablocks -> superblocks -> blocks -> rows
//   whose bbox meets the tile, in row order, with the setup rows' own edge
//   form dx*(py - y) - dy*(px - x) (the same int32 value);
// * the depth test: the (z, row id) lexicographic minimum from (1.0,
//   INT_MAX) over both phases (flat and G-buffer: a leftover row can have
//   a lower id than a listed one, so the test is not strict-less in visit
//   order), or for the depth-only pass the strict-less z test z >= 0 &&
//   z < zb in visit order, z alone kept;
// * the epilogue resolves the winner from the leftover setup rows (its
//   edge values are the same integers in either form): colour where
//   (covered, numer*inv, 0) packed RGBA8 with alpha 255, depth, and for
//   the G-buffer the interpolants as buf * (covered ? inv : 0)
//   (the reference's :584-600, K2g/K4g/K5g's form) and the constants as
//   they are.
//
// The tile state is raster_common.cuh's TileState at an 8-row tile: z and
// the winning row id for the thread's 4 pixels (8 registers), not the
// latches, as the G-buffer kernels keep; its row evaluation for phase 2,
// its superblock walk under each megablock, its resolve for the epilogue.
// New here: the list-row evaluation and the megablock level.
//
// What bounds it on the H100: the per-pixel edge work over the (tile, row)
// pairs of both phases (26 ops a pixel evaluation, 1024 pixels a pair),
// against the output planes' bytes on a sparse frame.  The 8-row tile
// quadruples the blocks of a 32x128 tiling and the pairs of rows taller
// than 8 pixels; the lists make phase 1 free of bbox tests, and the
// staged span is read by broadcast from shared memory.  Later work: the
// leftover walk re-reads the bbox tables from the start in every tile.

#include "raster_common.cuh"

namespace zr {
namespace g8 {

constexpr int GT_H = 8;
constexpr int ROW_LANES = 47;
constexpr int STAGE = 64;  // list rows staged in shared memory at a time

// List-row lanes (raster_group8.py C_*).
enum : int {
  C_DX0 = 0, C_DY0, C_C0, C_DX1, C_DY1, C_C1, C_DX2, C_DY2, C_C2,
  C_BIAS, C_ID, C_ZA
};

enum Mode : int { FLAT = 0, GBUF = 1, DEPTH = 2 };

// Flat and G-buffer: the (z, row id) winner; depth-only: strict-less z.
template <int MODE>
using Group8State = TileState<MODE != DEPTH, MODE != DEPTH, MODE == DEPTH,
                              GT_H>;

// Phase 1: one list row r (shared memory) at the thread's pixels, with
// the edge form e = (dx*py + c) - dy*px and the bias bits.
template <class State>
__device__ __forceinline__ void eval_list(State& st, const int* r) {
  const uint32_t dx0 = r[C_DX0], dy0 = r[C_DY0], c0 = r[C_C0];
  const uint32_t dx1 = r[C_DX1], dy1 = r[C_DY1], c1 = r[C_C1];
  const uint32_t dx2 = r[C_DX2], dy2 = r[C_DY2], c2 = r[C_C2];
  const int bias = r[C_BIAS];
  const int b0 = bias & 1, b1 = (bias >> 1) & 1, b2 = (bias >> 2) & 1;
  const float za0 = __int_as_float(r[C_ZA]);
  const float za1 = __int_as_float(r[C_ZA + 1]);
  const float za2 = __int_as_float(r[C_ZA + 2]);
  const int t = r[C_ID];
  const uint32_t upx = (uint32_t)st.px;
  const uint32_t ex0 = dy0 * upx, ex1 = dy1 * upx, ex2 = dy2 * upx;
#pragma unroll
  for (int k = 0; k < State::NPIX; ++k) {
    const uint32_t py = (uint32_t)st.py(k);
    const int e0 = (int)((dx0 * py + c0) - ex0);
    const int e1 = (int)((dx1 * py + c1) - ex1);
    const int e2 = (int)((dx2 * py + c2) - ex2);
    if (e0 < b0 || e1 < b1 || e2 < b2) continue;
    st.depth_test(k, interp3(__int2float_rn(e0), __int2float_rn(e1),
                             __int2float_rn(e2), za0, za1, za2), t);
  }
}

template <int MODE>
__device__ __forceinline__ void group8_tile(
    const int* __restrict__ offs, const int* __restrict__ tile_any,
    const int* __restrict__ rows, const int* __restrict__ megas,
    int num_megas, const int* __restrict__ supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height) {
  __shared__ int slab[STAGE * ROW_LANES];  // 12 032 bytes
  const int tiles_x = width / TILE_W;
  const int lin = blockIdx.x;
  Group8State<MODE> st;
  st.init((lin / tiles_x) * GT_H, (lin % tiles_x) * TILE_W);

  const int start = __ldg(offs + lin), end = __ldg(offs + lin + 1);
  for (int base = start; base < end; base += STAGE) {
    const int n = min(STAGE, end - base);
    __syncthreads();  // the previous stage is consumed
    const int* src = rows + (size_t)base * ROW_LANES;
    for (int i = threadIdx.x; i < n * ROW_LANES; i += THREADS)
      slab[i] = __ldg(src + i);
    __syncthreads();
    for (int j = 0; j < n; ++j) eval_list(st, slab + j * ROW_LANES);
  }
  // Phase 2, if the tile meets a leftover: megablock -> superblock ->
  // block -> row, each level's bbox against the tile, rows in order (the
  // reference's nested _scan_groups).
  if (__ldg(tile_any + lin) > 0) {
    for (int m = 0; m < num_megas; ++m) {
      const int* mb = megas + (size_t)m * 8;
      if (tile_overlap(__ldg(mb), __ldg(mb + 1), __ldg(mb + 2),
                       __ldg(mb + 3), st.row0, st.col0, GT_H))
        st.scan_hierarchy(supers, (m + 1) * SUPER_BLOCK, blocks, ti, tf,
                          m * SUPER_BLOCK);
    }
  }
  const size_t plane = (size_t)width * height;
  if constexpr (MODE == DEPTH) {
    st.store_depth(depth, width);
  } else {
    st.template resolve<true, MODE == GBUF>(ti, tf, color, depth, extra,
                                            width, plane);
  }
}

// One entry point per kernel, so each has its own name in a profile.
__global__ void __launch_bounds__(THREADS)
    raster_group8_kernel(const int* __restrict__ offs,
                         const int* __restrict__ tile_any,
                         const int* __restrict__ rows,
                         const int* __restrict__ megas, int num_megas,
                         const int* __restrict__ supers,
                         const int* __restrict__ blocks,
                         const int* __restrict__ ti,
                         const float* __restrict__ tf,
                         int* __restrict__ color, float* __restrict__ depth,
                         int width, int height) {
  group8_tile<FLAT>(offs, tile_any, rows, megas, num_megas, supers, blocks,
                    ti, tf, color, depth, nullptr, width, height);
}

__global__ void __launch_bounds__(THREADS)
    gbuffer_group8_kernel(const int* __restrict__ offs,
                          const int* __restrict__ tile_any,
                          const int* __restrict__ rows,
                          const int* __restrict__ megas, int num_megas,
                          const int* __restrict__ supers,
                          const int* __restrict__ blocks,
                          const int* __restrict__ ti,
                          const float* __restrict__ tf,
                          float* __restrict__ out, int width, int height) {
  const size_t plane = (size_t)width * height;
  group8_tile<GBUF>(offs, tile_any, rows, megas, num_megas, supers, blocks,
                    ti, tf, reinterpret_cast<int*>(out), out + plane,
                    out + 2 * plane, width, height);
}

__global__ void __launch_bounds__(THREADS)
    depth_group8_kernel(const int* __restrict__ offs,
                        const int* __restrict__ tile_any,
                        const int* __restrict__ rows,
                        const int* __restrict__ megas, int num_megas,
                        const int* __restrict__ supers,
                        const int* __restrict__ blocks,
                        const int* __restrict__ ti,
                        const float* __restrict__ tf,
                        float* __restrict__ depth, int width, int height) {
  group8_tile<DEPTH>(offs, tile_any, rows, megas, num_megas, supers, blocks,
                     ti, tf, nullptr, depth, nullptr, width, height);
}

}  // namespace g8
}  // namespace zr

// K10g8: packed color (int bits) and depth.
extern "C" int zr_raster_group8(const int* offs, const int* tile_any,
                                const int* rows, const int* megas,
                                int num_megas, const int* supers,
                                const int* blocks, const int* ti,
                                const float* tf, int* color, float* depth,
                                int height, int width, void* stream) {
  const int num_tiles = (height / zr::g8::GT_H) * (width / zr::TILE_W);
  zr::g8::raster_group8_kernel<<<num_tiles, zr::THREADS, 0,
                                 (cudaStream_t)stream>>>(
      offs, tile_any, rows, megas, num_megas, supers, blocks, ti, tf, color,
      depth, width, height);
  return (int)cudaGetLastError();
}

// K10g8g: the GBUF_PLANES planes back to back.
extern "C" int zr_gbuffer_group8(const int* offs, const int* tile_any,
                                 const int* rows, const int* megas,
                                 int num_megas, const int* supers,
                                 const int* blocks, const int* ti,
                                 const float* tf, float* out, int height,
                                 int width, void* stream) {
  const int num_tiles = (height / zr::g8::GT_H) * (width / zr::TILE_W);
  zr::g8::gbuffer_group8_kernel<<<num_tiles, zr::THREADS, 0,
                                  (cudaStream_t)stream>>>(
      offs, tile_any, rows, megas, num_megas, supers, blocks, ti, tf, out,
      width, height);
  return (int)cudaGetLastError();
}

// K10g8d: the one depth plane.
extern "C" int zr_depth_group8(const int* offs, const int* tile_any,
                               const int* rows, const int* megas,
                               int num_megas, const int* supers,
                               const int* blocks, const int* ti,
                               const float* tf, float* depth, int height,
                               int width, void* stream) {
  const int num_tiles = (height / zr::g8::GT_H) * (width / zr::TILE_W);
  zr::g8::depth_group8_kernel<<<num_tiles, zr::THREADS, 0,
                                (cudaStream_t)stream>>>(
      offs, tile_any, rows, megas, num_megas, supers, blocks, ti, tf, depth,
      width, height);
  return (int)cudaGetLastError();
}
