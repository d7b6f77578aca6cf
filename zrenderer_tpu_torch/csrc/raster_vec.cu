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
// What it computes, per 32x128 tile (one CUDA block of 256 threads, each
// owning one column and 16 rows: r0, r0 + 2, ..., as raster_common.cuh):
// * the superblocks, then the blocks, whose bbox meets the tile; each such
//   block's 128 records staged in shared memory;
// * per 32-record subgroup whose bbox meets the tile's columns, and per
//   8-row chunk of the tile its bbox meets (thread pixel k lies in chunk
//   k / 4), every live record (valid, non-empty bbox; no per-record bbox
//   test) evaluated at the chunk's pixels with e_k = (a_k + dx_k*py) -
//   dy_k*px, wrapping like the reference's int32 (uint32_t here);
// * the depth test: the records of a subgroup in order under the strict-
//   less test z >= 0 && z < zb, which keeps the subgroup's (z, row id)
//   winner when it beats the tile's depth: the reference's group winner
//   then strict-less merge, ties to the first row;
// * the epilogue reads the winner's coefficients from its record and
//   re-evaluates its edge values: colour where(covered, numer*inv, 0),
//   packed RGBA8 with alpha 255, depth, and for the G-buffer the
//   interpolants as covered ? buf*inv : 0 (the reference's :341, K3g's
//   form) and the constants as latched.
//
// The TPU kernel evaluates a subgroup as a (32, 8, 128) array and gathers
// the winner's coefficients with a one-hot matrix product; here each
// thread keeps z and the winning row id for its 16 pixels (raster_common.cuh
// TileState, its G-buffer state over records REC_LANES lanes apart) and
// its resolve reads the winner's record once at the end.  Its edge_fn on
// the record's setup ints gives the same int32 values as the a_k form.
//
// What bounds it on the H100: the per-pixel edge work, every live record
// of a hit subgroup at the 1024 pixels of each chunk its bbox meets (26
// ops each), against the output planes' bytes on a sparse frame.  Staging
// a block costs 36 KB of shared memory reads and writes per (tile, block)
// pair that hits.

#include "raster_common.cuh"

namespace zr {
namespace vec {

constexpr int SUBGROUP = 32;
constexpr int CHUNK_H = 8;
constexpr int A_BASE = 20;
constexpr int SG_BBOX = 24;
constexpr int F_BASE = 32;
constexpr int REC_LANES = F_BASE + NF32;  // 72
constexpr int SUBGROUPS = RASTER_BLOCK / SUBGROUP;  // 4
constexpr int CHUNKS = TILE_H / CHUNK_H;            // 4

// Strict-less (z, then first row) winner, resolved from the records.
using VecState = TileState<false, true, false, TILE_H, REC_LANES, REC_LANES>;
static_assert(ROW_STEP * (VecState::NPIX / CHUNKS) == CHUNK_H,
              "pixel k of a thread lies in chunk k / (NPIX / CHUNKS)");

template <bool GBUF>
__device__ __forceinline__ void vec_tile(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ rec,
    int* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ extra, int width, int height) {
  __shared__ int slab[RASTER_BLOCK * REC_LANES];  // 36 864 bytes
  constexpr int NPIX = VecState::NPIX;
  const int tiles_x = width / TILE_W;
  VecState st;
  st.init((blockIdx.x / tiles_x) * TILE_H, (blockIdx.x % tiles_x) * TILE_W);
  const int row0 = st.row0, col0 = st.col0;
  const uint32_t upx = (uint32_t)st.px;

  for (int s = 0; s < num_supers; ++s) {
    const int* sb = supers + (size_t)s * 8;
    if (!tile_overlap(__ldg(sb), __ldg(sb + 1), __ldg(sb + 2), __ldg(sb + 3),
                      row0, col0))
      continue;
    for (int b = s * SUPER_BLOCK; b < (s + 1) * SUPER_BLOCK; ++b) {
      const int* bb = blocks + (size_t)b * 8;
      if (!tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2),
                        __ldg(bb + 3), row0, col0))
        continue;
      __syncthreads();  // the previous block's records are consumed
      const int* src = rec + (size_t)b * RASTER_BLOCK * REC_LANES;
      for (int i = threadIdx.x; i < RASTER_BLOCK * REC_LANES; i += THREADS)
        slab[i] = __ldg(src + i);
      __syncthreads();
      for (int g = 0; g < SUBGROUPS; ++g) {
        const int* h = slab + g * SUBGROUP * REC_LANES + SG_BBOX;
        const int sj0 = h[0], sj1 = h[1], si0 = h[2], si1 = h[3];
        if (!(sj1 >= col0 && sj0 < col0 + TILE_W && sj0 <= sj1)) continue;
        bool hit[CHUNKS];
        bool any = false;
#pragma unroll
        for (int c = 0; c < CHUNKS; ++c) {
          const int crow0 = row0 + c * CHUNK_H;
          hit[c] = si1 >= crow0 && si0 < crow0 + CHUNK_H && si0 <= si1;
          any |= hit[c];
        }
        if (!any) continue;
        for (int i = 0; i < SUBGROUP; ++i) {
          const int* r = slab + (g * SUBGROUP + i) * REC_LANES;
          if (!(r[I_JMIN] <= r[I_JMAX] && r[I_IMIN] <= r[I_IMAX] &&
                r[I_VALID] > 0))
            continue;
          const uint32_t a0 = r[A_BASE], a1 = r[A_BASE + 1];
          const uint32_t a2 = r[A_BASE + 2];
          const uint32_t dx0 = r[I_DX0], dx1 = r[I_DX1], dx2 = r[I_DX2];
          const uint32_t ex0 = (uint32_t)r[I_DY0] * upx;
          const uint32_t ex1 = (uint32_t)r[I_DY1] * upx;
          const uint32_t ex2 = (uint32_t)r[I_DY2] * upx;
          const int b0 = r[I_BIAS0], b1 = r[I_BIAS1], b2 = r[I_BIAS2];
          const float za0 = __int_as_float(r[F_BASE + F_ZA0]);
          const float za1 = __int_as_float(r[F_BASE + F_ZA0 + 1]);
          const float za2 = __int_as_float(r[F_BASE + F_ZA0 + 2]);
          const int t = b * RASTER_BLOCK + g * SUBGROUP + i;
#pragma unroll
          for (int k = 0; k < NPIX; ++k) {
            if (!hit[k / (NPIX / CHUNKS)]) continue;
            const uint32_t py = (uint32_t)st.py(k);
            const int e0 = (int)((a0 + dx0 * py) - ex0);
            const int e1 = (int)((a1 + dx1 * py) - ex1);
            const int e2 = (int)((a2 + dx2 * py) - ex2);
            if (e0 < b0 || e1 < b1 || e2 < b2) continue;
            st.depth_test(k, interp3(__int2float_rn(e0), __int2float_rn(e1),
                                     __int2float_rn(e2), za0, za1, za2),
                          t);
          }
        }
      }
    }
  }
  st.template resolve<false, GBUF>(
      rec, reinterpret_cast<const float*>(rec + F_BASE), color, depth, extra,
      width, (size_t)width * height);
}

// One entry point per kernel, so each has its own name in a profile.
__global__ void __launch_bounds__(THREADS)
    raster_vec_kernel(const int* __restrict__ supers, int num_supers,
                      const int* __restrict__ blocks,
                      const int* __restrict__ rec, int* __restrict__ color,
                      float* __restrict__ depth, int width, int height) {
  vec_tile<false>(supers, num_supers, blocks, rec, color, depth, nullptr,
                  width, height);
}

__global__ void __launch_bounds__(THREADS)
    gbuffer_vec_kernel(const int* __restrict__ supers, int num_supers,
                       const int* __restrict__ blocks,
                       const int* __restrict__ rec, float* __restrict__ out,
                       int width, int height) {
  const size_t plane = (size_t)width * height;
  vec_tile<true>(supers, num_supers, blocks, rec,
                 reinterpret_cast<int*>(out), out + plane, out + 2 * plane,
                 width, height);
}

}  // namespace vec
}  // namespace zr

// K10vec: packed color (int bits) and depth.
extern "C" int zr_raster_vec(const int* supers, int num_supers,
                             const int* blocks, const int* rec, int* color,
                             float* depth, int height, int width,
                             void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::vec::raster_vec_kernel<<<num_tiles, zr::THREADS, 0,
                               (cudaStream_t)stream>>>(
      supers, num_supers, blocks, rec, color, depth, width, height);
  return (int)cudaGetLastError();
}

// K10vecg: the GBUF_PLANES planes back to back.
extern "C" int zr_gbuffer_vec(const int* supers, int num_supers,
                              const int* blocks, const int* rec, float* out,
                              int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::vec::gbuffer_vec_kernel<<<num_tiles, zr::THREADS, 0,
                                (cudaStream_t)stream>>>(
      supers, num_supers, blocks, rec, out, width, height);
  return (int)cudaGetLastError();
}
