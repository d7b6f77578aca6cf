// K4, K4c and K6: binned flat raster over pair-sorted tile spans; K4g and
// K6g: the G-buffer variants of K4 and K6; K4d and K6d: their depth-only
// variants.
//
// Replaces, in zrenderer_tpu/ops/raster_pallas.py:
//   K4   rasterize_setup_pallas_binned_hbm (_binned_hbm_kernel, body
//        _binned_hbm_body): spans of setup records gathered in pair order;
//   K4c  the same with coarse_cap (_binned_hbm_coarse_kernel): plus the
//        coarse list class;
//   K6   rasterize_setup_pallas_binned (_binned_kernel over global pair
//        lists, body _binned_body): spans of row ids into the setup rows.
// The Pallas functions differ in TPU memory placement (records streamed
// from HBM in aligned slabs, or row ids into VMEM-resident rows); here all
// read global memory, so one kernel body serves them, templated on the
// span source (records or row ids) and on the coarse phase.  Inputs are
// the outputs of prepare_binned_hbm_inputs / prepare_binned_inputs
// (zrenderer_tpu_torch/ops/raster.py).
//
// What it computes, per 32x128 tile (one CUDA block, tile state in
// registers, raster_common.cuh):
//   phase 1:   every entry of [offsets[t], offsets[t+1]); each is a
//              guaranteed bbox hit, so there is no bbox test.  Records are
//              (NI32 + 1) ints (the row id last) + NF32 floats;
//   phase 1.5: (K4c) every record of the tile's coarse bin
//              (ty / COARSE_CB) * ctiles_x + tx / COARSE_CB, skipped when
//              its bbox misses the tile (a block-uniform test);
//   phase 2:   the leftover rows through superblock -> block -> row bbox
//              skips;
//   every phase tests z >= 0 && (z < zb || (z == zb && id < tb)), the
//   order-free (z, row id) tie-break that equals sequential strict-less in
//   submission order; then one divide per pixel into RGBA8 + f32 depth.
//
// What bounds it on the H100: the per-pixel edge evaluation over the
// (tile, triangle) pairs, not device-memory bytes and not the tensor cores.
// Each pair costs 3 edge functions, 3 bias tests and a z interpolation at
// each of the tile's 4096 pixels, issued on the int32/fp32 CUDA cores; the
// records a tile reads are contiguous and read once (a few MB per frame).
// The simple design keeps the tile state in registers across all three
// phases and has all 256 threads read each record through broadcast loads.
// Later work: stage a tile's contiguous records in shared memory with
// cp.async/TMA, skip pixel rows outside a triangle's bbox, and balance the
// tiles' spans (they differ by orders of magnitude) with persistent blocks.
//
// K4g replaces rasterize_gbuffer_pallas_binned_hbm
// (_binned_hbm_gbuffer_kernel, body _binned_hbm_body with the G-buffer
// scratch, no coarse phase): K4's phases keeping z and the winning row id,
// then the 13 planes resolved from the winner (raster_common.cuh
// TileState::store_gbuffer, epilogue buf * (covered ? 1/den : 0)).  A
// record's id (its last int, the reference's L_PID) and a leftover row's
// id both index the padded, uncompacted setup rows that hier/tf hold
// (prepare_binned_hbm_inputs gathers the records from them), so the
// epilogue reads the winner from hier/tf whichever phase it came from;
// hier differs from the records only in bbox and valid columns, which the
// epilogue does not read.  Bound on the H100: as K4, plus the 13 output
// planes (109 MB at 1920x1088, 0.032 ms at 3.35 TB/s).  ptxas (sm_90a, -O3
// -fmad=false): K4g 112 registers against K4's 192, no spills.
//
// K6g replaces rasterize_gbuffer_pallas_binned (_binned_gbuffer_kernel over
// global pair lists, epilogue buf * where(covered, inv, 0) at :1452-1455):
// K6's phases keeping z and the winning row id, the 13 planes resolved
// from the winner in hier/tf (the rows pair_tri indexes), as K4g.
//
// K4d and K6d replace rasterize_depth_pallas_binned_hbm
// (_binned_hbm_depth_kernel, body :1887 with depth_only, :1939-1944,
// :2142-2144) and rasterize_depth_pallas_binned (_binned_depth_kernel over
// global pair lists), the shadow-map pass under record streaming and tile
// lists: the same phases, no coarse class, z alone under the strict-less
// test (raster_common.cuh TileState::DEPTH), one f32 plane out.  Without a
// row id an exact tie keeps the first row visited (span, then leftovers),
// so their planes equal K3d's by value; only the sign of a zero z may
// differ.  Bound on the H100: the per-pixel edge work over the shadow
// map's (tile, triangle) pairs.

// K9, K9g and K9d, the band kernels of the sharded frames, replace
//   K9   rasterize_setup_pallas_binned_band (:2413; _binned_hbm_band_kernel
//        :2388 and _binned_hbm_band_local_kernel :2400);
//   K9g  rasterize_gbuffer_pallas_binned_band (:2501,
//        _binned_hbm_gbuffer_band_kernel :2478);
//   K9d  rasterize_setup_pallas_binned_band_dist (:2701,
//        _binned_hbm_band_dist_kernel_factory :2686).
// Each is K4's (K9g: K4g's) tile body over one band: the grid is the band's
// tiles, a tile's pixel rows start at row_base + i * 32, and the outputs are
// band-local (band_h, W) planes.  K9's spans are indexed by band tile (the
// band-local prepare) or, with band_local = 0, by global tile
// (row_base / 32 + i) * tiles_x + j; one entry point takes the flag.  K9d
// streams n_src spans per tile, source by source, from offsets laid out
// (n_src, band_tiles + 1) and rebased to the concatenated slabs, then the
// leftover hierarchy.  The (z, row id) tie-break makes the order of the
// spans free, so the bands equal the rows of K4's frame.  Bound on the
// H100: as K4, the per-pixel edge work over the band's (tile, triangle)
// pairs x 4096 x 26 ops; K9g adds its 13 output planes.

#include "raster_common.cuh"

namespace zr {

constexpr int REC_I = NI32 + 1;  // record ints: the setup row + its row id
// Coarse bins are COARSE_CB x COARSE_CB tiles (ops/raster.py COARSE_CB, the
// reference's coarse_cb default).
constexpr int COARSE_CB = 4;

// Coarse records are bin residents: the reference's four-sided bbox test
// against the tile.
__device__ __forceinline__ bool record_hits(const int* __restrict__ r,
                                            int row0, int col0) {
  return __ldg(r + I_JMAX) >= col0 && __ldg(r + I_JMIN) < col0 + TILE_W &&
         __ldg(r + I_IMAX) >= row0 && __ldg(r + I_IMIN) < row0 + TILE_H;
}

// Phases 1, 1.5 and 2 of all twelve kernels.  RECORDS: spans of gathered
// records (K4/K4c/K4g/K9/K9g/K9d) or of row ids (K6).  COARSE: run phase
// 1.5 over the coarse class.  A band kernel passes row_base (its first
// global row), list_base (the span index of its first tile: 0 for
// band-local spans) and, for K9d, n_src span lists src_stride apart.
template <bool RECORDS, bool COARSE, class State>
__device__ __forceinline__ void binned_scan(
    State& st, const int* __restrict__ offsets,
    const int* __restrict__ span_i, const float* __restrict__ span_f,
    const int* __restrict__ coffsets, const int* __restrict__ crec_i,
    const float* __restrict__ crec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf, int width,
    int row_base = 0, int list_base = 0, int n_src = 1, int src_stride = 0) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x, tx = tile % tiles_x;
  st.init(row_base + ty * TILE_H, tx * TILE_W);

  for (int s = 0; s < n_src; ++s) {
    const int* offs = offsets + (size_t)s * src_stride + list_base + tile;
    const int end = __ldg(offs + 1);
    for (int k = __ldg(offs); k < end; ++k) {
      if constexpr (RECORDS) {
        const int* r = span_i + (size_t)k * REC_I;
        st.eval_row(r, span_f + (size_t)k * NF32, __ldg(r + NI32));
      } else {
        st.eval(ti, tf, __ldg(span_i + k));
      }
    }
  }

  if constexpr (COARSE) {
    const int ctiles_x = (tiles_x + COARSE_CB - 1) / COARSE_CB;
    const int bin = (ty / COARSE_CB) * ctiles_x + tx / COARSE_CB;
    const int cend = __ldg(coffsets + bin + 1);
    for (int k = __ldg(coffsets + bin); k < cend; ++k) {
      const int* r = crec_i + (size_t)k * REC_I;
      if (record_hits(r, st.row0, st.col0))
        st.eval_row(r, crec_f + (size_t)k * NF32, __ldg(r + NI32));
    }
  }

  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
}

// The body of the three flat kernels.
template <bool RECORDS, bool COARSE>
__device__ __forceinline__ void binned_tile(
    const int* __restrict__ offsets, const int* __restrict__ span_i,
    const float* __restrict__ span_f, const int* __restrict__ coffsets,
    const int* __restrict__ crec_i, const float* __restrict__ crec_f,
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width) {
  TileState<true> st;
  binned_scan<RECORDS, COARSE>(st, offsets, span_i, span_f, coffsets, crec_i,
                               crec_f, supers, num_supers, blocks, ti, tf,
                               width);
  st.store(color, depth, width);
}

// One entry point per kernel, so each has its own name in a profile.
__global__ void __launch_bounds__(THREADS)
    raster_records_kernel(const int* __restrict__ offsets,
                          const int* __restrict__ rec_i,
                          const float* __restrict__ rec_f,
                          const int* __restrict__ supers, int num_supers,
                          const int* __restrict__ blocks,
                          const int* __restrict__ ti,
                          const float* __restrict__ tf,
                          int* __restrict__ color, float* __restrict__ depth,
                          int width) {
  binned_tile<true, false>(offsets, rec_i, rec_f, nullptr, nullptr, nullptr,
                           supers, num_supers, blocks, ti, tf, color, depth,
                           width);
}

__global__ void __launch_bounds__(THREADS) raster_records_coarse_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ coffsets,
    const int* __restrict__ crec_i, const float* __restrict__ crec_f,
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width) {
  binned_tile<true, true>(offsets, rec_i, rec_f, coffsets, crec_i, crec_f,
                          supers, num_supers, blocks, ti, tf, color, depth,
                          width);
}

__global__ void __launch_bounds__(THREADS)
    raster_lists_kernel(const int* __restrict__ offsets,
                        const int* __restrict__ pair_tri,
                        const int* __restrict__ supers, int num_supers,
                        const int* __restrict__ blocks,
                        const int* __restrict__ ti,
                        const float* __restrict__ tf, int* __restrict__ color,
                        float* __restrict__ depth, int width) {
  binned_tile<false, false>(offsets, pair_tri, nullptr, nullptr, nullptr,
                            nullptr, supers, num_supers, blocks, ti, tf,
                            color, depth, width);
}

__global__ void __launch_bounds__(THREADS)
    gbuffer_records_kernel(const int* __restrict__ offsets,
                           const int* __restrict__ rec_i,
                           const float* __restrict__ rec_f,
                           const int* __restrict__ supers, int num_supers,
                           const int* __restrict__ blocks,
                           const int* __restrict__ ti,
                           const float* __restrict__ tf,
                           float* __restrict__ out, int width, int height) {
  TileState<true, true> st;
  binned_scan<true, false>(st, offsets, rec_i, rec_f, nullptr, nullptr,
                           nullptr, supers, num_supers, blocks, ti, tf,
                           width);
  st.store_gbuffer<true>(ti, tf, out, width, (size_t)width * height);
}

__global__ void __launch_bounds__(THREADS)
    gbuffer_lists_kernel(const int* __restrict__ offsets,
                         const int* __restrict__ pair_tri,
                         const int* __restrict__ supers, int num_supers,
                         const int* __restrict__ blocks,
                         const int* __restrict__ ti,
                         const float* __restrict__ tf,
                         float* __restrict__ out, int width, int height) {
  TileState<true, true> st;
  binned_scan<false, false>(st, offsets, pair_tri, nullptr, nullptr, nullptr,
                            nullptr, supers, num_supers, blocks, ti, tf,
                            width);
  st.store_gbuffer<true>(ti, tf, out, width, (size_t)width * height);
}

__global__ void __launch_bounds__(THREADS)
    depth_records_kernel(const int* __restrict__ offsets,
                         const int* __restrict__ rec_i,
                         const float* __restrict__ rec_f,
                         const int* __restrict__ supers, int num_supers,
                         const int* __restrict__ blocks,
                         const int* __restrict__ ti,
                         const float* __restrict__ tf,
                         float* __restrict__ depth, int width) {
  TileState<false, false, true> st;
  binned_scan<true, false>(st, offsets, rec_i, rec_f, nullptr, nullptr,
                           nullptr, supers, num_supers, blocks, ti, tf,
                           width);
  st.store_depth(depth, width);
}

__global__ void __launch_bounds__(THREADS)
    depth_lists_kernel(const int* __restrict__ offsets,
                       const int* __restrict__ pair_tri,
                       const int* __restrict__ supers, int num_supers,
                       const int* __restrict__ blocks,
                       const int* __restrict__ ti,
                       const float* __restrict__ tf,
                       float* __restrict__ depth, int width) {
  TileState<false, false, true> st;
  binned_scan<false, false>(st, offsets, pair_tri, nullptr, nullptr, nullptr,
                            nullptr, supers, num_supers, blocks, ti, tf,
                            width);
  st.store_depth(depth, width);
}

// K9: K4 over one band; list_base = 0 for band-local spans, else the
// global span index of the band's first tile.
__global__ void __launch_bounds__(THREADS) raster_records_band_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int row_base, int list_base) {
  TileState<true> st;
  binned_scan<true, false>(st, offsets, rec_i, rec_f, nullptr, nullptr,
                           nullptr, supers, num_supers, blocks, ti, tf, width,
                           row_base, list_base);
  st.store(color, depth, width, row_base);
}

// K9g: K4g over one band (band-local spans); out holds GBUF_PLANES
// (band_h, width) planes.
__global__ void __launch_bounds__(THREADS) gbuffer_records_band_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    float* __restrict__ out, int width, int band_h, int row_base) {
  TileState<true, true> st;
  binned_scan<true, false>(st, offsets, rec_i, rec_f, nullptr, nullptr,
                           nullptr, supers, num_supers, blocks, ti, tf, width,
                           row_base);
  st.store_gbuffer<true>(ti, tf, out, width, (size_t)width * band_h,
                         row_base);
}

// K9d: n_src band-local span lists, one per source shard.
__global__ void __launch_bounds__(THREADS) raster_records_dist_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int row_base, int n_src) {
  TileState<true> st;
  binned_scan<true, false>(st, offsets, rec_i, rec_f, nullptr, nullptr,
                           nullptr, supers, num_supers, blocks, ti, tf, width,
                           row_base, 0, n_src, (int)gridDim.x + 1);
  st.store(color, depth, width, row_base);
}

}  // namespace zr

// K4 (coffsets == nullptr) or K4c.
extern "C" int zr_raster_records(const int* offsets, const int* rec_i,
                                 const float* rec_f, const int* coffsets,
                                 const int* crec_i, const float* crec_f,
                                 const int* supers, int num_supers,
                                 const int* blocks, const int* ti,
                                 const float* tf, int* color, float* depth,
                                 int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  if (coffsets == nullptr) {
    zr::raster_records_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        offsets, rec_i, rec_f, supers, num_supers, blocks, ti, tf, color,
        depth, width);
  } else {
    zr::raster_records_coarse_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        offsets, rec_i, rec_f, coffsets, crec_i, crec_f, supers, num_supers,
        blocks, ti, tf, color, depth, width);
  }
  return (int)cudaGetLastError();
}

// K6.
extern "C" int zr_raster_lists(const int* offsets, const int* pair_tri,
                               const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, int* color, float* depth,
                               int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::raster_lists_kernel<<<num_tiles, zr::THREADS, 0,
                            (cudaStream_t)stream>>>(
      offsets, pair_tri, supers, num_supers, blocks, ti, tf, color, depth,
      width);
  return (int)cudaGetLastError();
}

// K4g.
extern "C" int zr_gbuffer_records(const int* offsets, const int* rec_i,
                                  const float* rec_f, const int* supers,
                                  int num_supers, const int* blocks,
                                  const int* ti, const float* tf, float* out,
                                  int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::gbuffer_records_kernel<<<num_tiles, zr::THREADS, 0,
                               (cudaStream_t)stream>>>(
      offsets, rec_i, rec_f, supers, num_supers, blocks, ti, tf, out, width,
      height);
  return (int)cudaGetLastError();
}

// K6g.
extern "C" int zr_gbuffer_lists(const int* offsets, const int* pair_tri,
                                const int* supers, int num_supers,
                                const int* blocks, const int* ti,
                                const float* tf, float* out, int height,
                                int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::gbuffer_lists_kernel<<<num_tiles, zr::THREADS, 0,
                             (cudaStream_t)stream>>>(
      offsets, pair_tri, supers, num_supers, blocks, ti, tf, out, width,
      height);
  return (int)cudaGetLastError();
}

// K4d.
extern "C" int zr_depth_records(const int* offsets, const int* rec_i,
                                const float* rec_f, const int* supers,
                                int num_supers, const int* blocks,
                                const int* ti, const float* tf, float* depth,
                                int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::depth_records_kernel<<<num_tiles, zr::THREADS, 0,
                             (cudaStream_t)stream>>>(
      offsets, rec_i, rec_f, supers, num_supers, blocks, ti, tf, depth,
      width);
  return (int)cudaGetLastError();
}

// K6d.
extern "C" int zr_depth_lists(const int* offsets, const int* pair_tri,
                              const int* supers, int num_supers,
                              const int* blocks, const int* ti,
                              const float* tf, float* depth, int height,
                              int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::depth_lists_kernel<<<num_tiles, zr::THREADS, 0,
                           (cudaStream_t)stream>>>(
      offsets, pair_tri, supers, num_supers, blocks, ti, tf, depth, width);
  return (int)cudaGetLastError();
}

// K9: band_local = 1 for spans indexed by band tile, 0 for global tiles.
extern "C" int zr_raster_records_band(const int* offsets, const int* rec_i,
                                      const float* rec_f, const int* supers,
                                      int num_supers, const int* blocks,
                                      const int* ti, const float* tf,
                                      int* color, float* depth, int band_h,
                                      int width, int row_base, int band_local,
                                      void* stream) {
  const int tiles_x = width / zr::TILE_W;
  const int num_tiles = (band_h / zr::TILE_H) * tiles_x;
  const int list_base = band_local ? 0 : (row_base / zr::TILE_H) * tiles_x;
  zr::raster_records_band_kernel<<<num_tiles, zr::THREADS, 0,
                                   (cudaStream_t)stream>>>(
      offsets, rec_i, rec_f, supers, num_supers, blocks, ti, tf, color, depth,
      width, row_base, list_base);
  return (int)cudaGetLastError();
}

// K9g.
extern "C" int zr_gbuffer_records_band(const int* offsets, const int* rec_i,
                                       const float* rec_f, const int* supers,
                                       int num_supers, const int* blocks,
                                       const int* ti, const float* tf,
                                       float* out, int band_h, int width,
                                       int row_base, void* stream) {
  const int num_tiles = (band_h / zr::TILE_H) * (width / zr::TILE_W);
  zr::gbuffer_records_band_kernel<<<num_tiles, zr::THREADS, 0,
                                    (cudaStream_t)stream>>>(
      offsets, rec_i, rec_f, supers, num_supers, blocks, ti, tf, out, width,
      band_h, row_base);
  return (int)cudaGetLastError();
}

// K9d: offsets (n_src, band_tiles + 1), rebased to the concatenated slabs.
extern "C" int zr_raster_records_dist(const int* offsets, const int* rec_i,
                                      const float* rec_f, const int* supers,
                                      int num_supers, const int* blocks,
                                      const int* ti, const float* tf,
                                      int* color, float* depth, int band_h,
                                      int width, int row_base, int n_src,
                                      void* stream) {
  const int num_tiles = (band_h / zr::TILE_H) * (width / zr::TILE_W);
  zr::raster_records_dist_kernel<<<num_tiles, zr::THREADS, 0,
                                   (cudaStream_t)stream>>>(
      offsets, rec_i, rec_f, supers, num_supers, blocks, ti, tf, color, depth,
      width, row_base, n_src);
  return (int)cudaGetLastError();
}
