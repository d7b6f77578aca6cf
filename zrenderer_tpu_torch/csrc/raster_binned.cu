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
// read global memory, so one register body (binned_scan) serves K4c, K6
// and their variants, templated on the span source (records or row ids)
// and on the coarse phase; K4, K4g and K4d run the keyed body (below).
// Inputs are the outputs of prepare_binned_hbm_inputs /
// prepare_binned_inputs (zrenderer_tpu_torch/ops/raster.py).
//
// What the register body computes, per 32x128 tile (one CUDA block, tile
// state in registers, raster_common.cuh), and the keyed body too:
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
// What bounds that body on the H100 is pixel work no pixel needs: each
// record of a span is evaluated at all 4096 pixels of its tile (3 edge
// functions, 3 bias tests, a z interpolation each), while a record's bbox
// in the tile, the pixels it can draw, is about 1/40 of that at 1M
// triangles; all 256 threads read each record through broadcast loads; K4's
// six values a pixel take 183 registers, one block an SM; and one block
// walks a tile's whole span, whose lengths differ by orders of magnitude
// (K4d's 1024^2 map has 256 tiles for 132 SMs).
//
// K4, K4g and K4d run the keyed body of raster_keyed.cuh instead
// (keyed_records below), with the same planes bit for bit: one 64-bit key
// a pixel in shared memory lowered by atomicMin (K4 and K4g FlatKeys and
// GbufKeys, (order bits of z, row id), whose minimum is the (z, row id)
// tie-break; K4d DepthKeys, (order bits of z, visit index, sign of z), a
// span record's visit index its record index, a leftover row's the span's
// end plus its row id), each record evaluated over its window (its
// vertices' pixel bbox in the tile), the leftover rows compacted into the
// same batches by the hierarchy walk.  Here:
// * Records staged in shared memory with cp.async, double-buffered.  K4c
//   and K9 can move onto the body as instantiations (a coarse producer, a
//   band's row base).
// * A tile's span is cut into work items of at most item_records records,
//   one block each, which share the tile's leftover superblocks too.  A
//   tile of one item resolves its keys in place; otherwise the items merge
//   through the frame's key plane and a second kernel resolves it.  Three
//   device operations a call (memset, items, resolve).
// The resolve re-evaluates the winner from hier/tf: K4 its z (-0.0 kept)
// and colour, K4g the same and its 11 further planes; K4d decodes z from
// the key.  The records are read once.
//
// K4g replaces rasterize_gbuffer_pallas_binned_hbm
// (_binned_hbm_gbuffer_kernel, body _binned_hbm_body with the G-buffer
// scratch, no coarse phase): K4's key (GbufKeys, K4's FlatKeys with the
// planes) and its work items, then the 13 planes resolved from the winner
// (epilogue buf * (covered ? 1/den : 0)).  A record's id (its last int,
// the reference's L_PID) and a leftover row's id both index the padded,
// uncompacted setup rows that hier/tf hold (prepare_binned_hbm_inputs
// gathers the records from them), so the resolve reads the winner from
// hier/tf whichever phase it came from; hier differs from the records only
// in bbox and valid columns, which the resolve does not read.  Bound on the
// H100: as K4's, plus 11 more output planes (92 MB at 1920x1088) and the
// winners' uv, normal and constant coefficients.
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
// Each is the register tile body of K4 (K9g: of K4g) over one band: the
// grid is the band's tiles, a tile's pixel rows start at row_base + i * 32,
// and the outputs are band-local (band_h, W) planes.  K9's spans are
// indexed by band tile (the band-local prepare) or, with band_local = 0,
// by global tile (row_base / 32 + i) * tiles_x + j; one entry point takes
// the flag.  K9d
// streams n_src spans per tile, source by source, from offsets laid out
// (n_src, band_tiles + 1) and rebased to the concatenated slabs, then the
// leftover hierarchy.  The (z, row id) tie-break makes the order of the
// spans free, so the bands equal the rows of K4's frame.  Bound on the
// H100: as K4, the per-pixel edge work over the band's (tile, triangle)
// pairs x 4096 x 26 ops; K9g adds its 13 output planes.

#include "raster_keyed.cuh"

namespace zr {

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

// Phases 1, 1.5 and 2 of the register kernels.  RECORDS: spans of gathered
// records (K4c/K9/K9g/K9d) or of row ids (K6, K6g, K6d).  COARSE: run phase
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

// ---------------------------------------------------------------------------
// The keyed record raster (K4, K4g, K4d): the body of raster_keyed.cuh over
// a tile's record span, then the leftover rows.
// ---------------------------------------------------------------------------

// Shared memory of a K4/K4g/K4d work item (dynamic: above the 48 KB static
// limit): the keyed body's, and the span's records staged by cp.async.
struct KeyedSpanSmem : KeyedSmem {
  int raw_i[2][KEY_BATCH * REC_I];  // staged records, double-buffered
  float raw_z[2][KEY_BATCH * 3];    // their z coefficients
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

// Work items of tile u: its span in pieces of at most item_records, and
// one item for an empty span (the leftovers and the resolve).
__device__ __forceinline__ int tile_items(const int* __restrict__ offsets,
                                          int u, int item_records) {
  const int n = __ldg(offsets + u + 1) - __ldg(offsets + u);
  return max(1, (n + item_records - 1) / item_records);
}

// Items are numbered tile by tile.  Each block finds its own (tile, index,
// count) in s.item, tile -1 past the last item.
__device__ __forceinline__ void find_item(KeyedSmem& s,
                                          const int* __restrict__ offsets,
                                          int num_tiles, int item_records) {
  const int per = (num_tiles + THREADS - 1) / THREADS;
  const int u0 = min((int)threadIdx.x * per, num_tiles);
  const int u1 = min(u0 + per, num_tiles);
  int local = 0;
  for (int u = u0; u < u1; ++u) local += tile_items(offsets, u, item_records);
  if (threadIdx.x == 0) s.item[0] = -1;
  int total;
  int acc = block_exclusive_scan(local, s.scan, total);
  const int b = (int)blockIdx.x;
  for (int u = u0; u < u1; ++u) {
    const int n = tile_items(offsets, u, item_records);
    if (b >= acc && b < acc + n) {
      s.item[0] = u;
      s.item[1] = b - acc;
      s.item[2] = n;
    }
    acc += n;
  }
  __syncthreads();
}

// Records [k0, k0 + n) into staging buffer buf by cp.async, one commit.
__device__ __forceinline__ void stage_records(KeyedSpanSmem& s, int buf,
                                              const int* __restrict__ rec_i,
                                              const float* __restrict__ rec_f,
                                              int k0, int n) {
  const int* src = rec_i + (size_t)k0 * REC_I;
  for (int w = threadIdx.x; w < n * REC_I; w += THREADS)
    cp_async4(&s.raw_i[buf][w], src + w);
  for (int w = threadIdx.x; w < n * 3; w += THREADS)
    cp_async4(&s.raw_z[buf][w],
              rec_f + (size_t)(k0 + w / 3) * NF32 + F_ZA0 + w % 3);
  __pipeline_commit();
}

// Records [k_begin, k_end) of the span, KEY_BATCH at a time: the next
// batch's copies fly while this one is evaluated.
template <class Mode>
__device__ __forceinline__ void keyed_span(KeyedSpanSmem& s,
                                           const int* __restrict__ rec_i,
                                           const float* __restrict__ rec_f,
                                           int k_begin, int k_end, int row0,
                                           int col0) {
  const int batches = (k_end - k_begin + KEY_BATCH - 1) / KEY_BATCH;
  if (batches > 0)
    stage_records(s, 0, rec_i, rec_f, k_begin,
                  min(KEY_BATCH, k_end - k_begin));
  for (int b = 0; b < batches; ++b) {
    const int k0 = k_begin + b * KEY_BATCH;
    const int nb = min(KEY_BATCH, k_end - k0);
    if (b + 1 < batches) {
      stage_records(s, (b + 1) & 1, rec_i, rec_f, k0 + KEY_BATCH,
                    min(KEY_BATCH, k_end - k0 - KEY_BATCH));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    int area = 0;
    const int j = threadIdx.x;
    if (j < nb) {
      const int* r = s.raw_i[b & 1] + j * REC_I;
      area = prepare_record(s, j, r, s.raw_z[b & 1] + j * 3,
                            Mode::span_tag(r, k0 + j), row0, col0);
    }
    eval_batch<Mode>(s, area);
  }
}

// Work item blockIdx.x: its share of the tile's span and of the leftover
// superblocks into the shared keys, then out (raster_keyed.cuh keyed_out).
// Mode: FlatKeys (K4), GbufKeys (K4g; extra: its 11 further planes) or
// DepthKeys (K4d).
template <class Mode>
__device__ __forceinline__ void keyed_records(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int item_records, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ extra, int width, int height) {
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSpanSmem& s = *reinterpret_cast<KeyedSpanSmem*>(keyed_smem);
  const int tiles_x = width / TILE_W;
  find_item(s, offsets, tiles_x * (height / TILE_H), item_records);
  const int tile = s.item[0], idx = s.item[1], n_items = s.item[2];
  if (tile < 0) return;  // past the last item
  const int row0 = (tile / tiles_x) * TILE_H;
  const int col0 = (tile % tiles_x) * TILE_W;
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) s.key[p] = Mode::CLEAR;
  const int span_end = __ldg(offsets + tile + 1);
  const int k_begin =
      min(__ldg(offsets + tile) + idx * item_records, span_end);
  const int k_end = min(k_begin + item_records, span_end);
  __syncthreads();
  keyed_span<Mode>(s, rec_i, rec_f, k_begin, k_end, row0, col0);
  keyed_leftovers<Mode>(
      s, supers, (int)((long long)idx * num_supers / n_items),
      (int)((long long)(idx + 1) * num_supers / n_items), blocks, ti, tf,
      span_end, row0, col0);
  __syncthreads();
  keyed_out<Mode>(s, n_items == 1, plane, row0, col0, ti, tf, color, depth,
                  extra, width, height);
}

// The tiles of several items: their merged keys in the plane, resolved.
template <class Mode>
__device__ __forceinline__ void keyed_resolve(
    const int* __restrict__ offsets, int item_records,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int height) {
  const int tile = blockIdx.x, tiles_x = width / TILE_W;
  if (tile_items(offsets, tile, item_records) == 1) return;
  resolve_tile<Mode>(plane, (tile / tiles_x) * TILE_H,
                     (tile % tiles_x) * TILE_W, ti, tf, color, depth, extra,
                     width, height);
}

// K4: the keyed body over record spans, flat planes.
__global__ void __launch_bounds__(THREADS) raster_records_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int item_records, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height) {
  keyed_records<FlatKeys>(offsets, rec_i, rec_f, supers, num_supers, blocks,
                          ti, tf, item_records, plane, color, depth, nullptr,
                          width, height);
}

__global__ void __launch_bounds__(THREADS) raster_records_resolve_kernel(
    const int* __restrict__ offsets, int item_records,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, int* __restrict__ color,
    float* __restrict__ depth, int width, int height) {
  keyed_resolve<FlatKeys>(offsets, item_records, plane, ti, tf, color, depth,
                          nullptr, width, height);
}

// K4g: the keyed body, the GBUF_PLANES planes of out (color bits, depth,
// then the rest), width * height floats apart.
__global__ void __launch_bounds__(THREADS) gbuffer_records_keyed_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int item_records, unsigned long long* __restrict__ plane,
    float* __restrict__ out, int width, int height) {
  const size_t frame = (size_t)width * height;
  keyed_records<GbufKeys>(offsets, rec_i, rec_f, supers, num_supers, blocks,
                          ti, tf, item_records, plane,
                          reinterpret_cast<int*>(out), out + frame,
                          out + 2 * frame, width, height);
}

__global__ void __launch_bounds__(THREADS) gbuffer_records_resolve_kernel(
    const int* __restrict__ offsets, int item_records,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ out, int width,
    int height) {
  const size_t frame = (size_t)width * height;
  keyed_resolve<GbufKeys>(offsets, item_records, plane, ti, tf,
                          reinterpret_cast<int*>(out), out + frame,
                          out + 2 * frame, width, height);
}

// K4d: the keyed body, the depth plane alone.
__global__ void __launch_bounds__(THREADS) depth_records_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int item_records, unsigned long long* __restrict__ plane,
    float* __restrict__ depth, int width, int height) {
  keyed_records<DepthKeys>(offsets, rec_i, rec_f, supers, num_supers, blocks,
                           ti, tf, item_records, plane, nullptr, depth,
                           nullptr, width, height);
}

__global__ void __launch_bounds__(THREADS) depth_records_resolve_kernel(
    const int* __restrict__ offsets, int item_records,
    const unsigned long long* __restrict__ plane, const int* __restrict__ ti,
    const float* __restrict__ tf, float* __restrict__ depth, int width,
    int height) {
  keyed_resolve<DepthKeys>(offsets, item_records, plane, ti, tf, nullptr,
                           depth, nullptr, width, height);
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

// K9g: K4g's register body over one band (band-local spans); out holds
// GBUF_PLANES (band_h, width) planes.
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

// K4c.
extern "C" int zr_raster_records(const int* offsets, const int* rec_i,
                                 const float* rec_f, const int* coffsets,
                                 const int* crec_i, const float* crec_f,
                                 const int* supers, int num_supers,
                                 const int* blocks, const int* ti,
                                 const float* tf, int* color, float* depth,
                                 int height, int width, void* stream) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  zr::raster_records_coarse_kernel<<<num_tiles, zr::THREADS, 0,
                                     (cudaStream_t)stream>>>(
      offsets, rec_i, rec_f, coffsets, crec_i, crec_f, supers, num_supers,
      blocks, ti, tf, color, depth, width);
  return (int)cudaGetLastError();
}

// K4, K4g and K4d launch the keyed body: the key plane (height * width keys)
// set to all ones, `items` blocks (tiles plus ceil(records /
// item_records), a bound on the work items), then the resolve over the
// tiles.
template <class Items, class Resolve, class... Out>
static int launch_keyed(Items items_kernel, Resolve resolve_kernel,
                        const int* offsets, const int* rec_i,
                        const float* rec_f, const int* supers, int num_supers,
                        const int* blocks, const int* ti, const float* tf,
                        int item_records, int items, unsigned long long* plane,
                        int height, int width, void* stream, Out... out) {
  const int num_tiles = (height / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = (int)sizeof(zr::KeyedSpanSmem);
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(plane, 0xff,
                          (size_t)height * width * sizeof(*plane), s);
  if (err != cudaSuccess) return (int)err;
  items_kernel<<<items, zr::THREADS, smem, s>>>(
      offsets, rec_i, rec_f, supers, num_supers, blocks, ti, tf, item_records,
      plane, out..., width, height);
  resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
      offsets, item_records, plane, ti, tf, out..., width, height);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a K4/K4g/K4d work item, in bytes.
extern "C" int zr_keyed_smem_bytes() {
  return (int)sizeof(zr::KeyedSpanSmem);
}

// K4.
extern "C" int zr_raster_records_keyed(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int items, unsigned long long* plane,
    int* color, float* depth, int height, int width, void* stream) {
  return launch_keyed(zr::raster_records_kernel,
                      zr::raster_records_resolve_kernel, offsets, rec_i,
                      rec_f, supers, num_supers, blocks, ti, tf, item_records,
                      items, plane, height, width, stream, color, depth);
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
extern "C" int zr_gbuffer_records_keyed(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int items, unsigned long long* plane,
    float* out, int height, int width, void* stream) {
  return launch_keyed(zr::gbuffer_records_keyed_kernel,
                      zr::gbuffer_records_resolve_kernel, offsets, rec_i,
                      rec_f, supers, num_supers, blocks, ti, tf, item_records,
                      items, plane, height, width, stream, out);
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
extern "C" int zr_depth_records_keyed(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int items, unsigned long long* plane,
    float* depth, int height, int width, void* stream) {
  return launch_keyed(zr::depth_records_kernel,
                      zr::depth_records_resolve_kernel, offsets, rec_i, rec_f,
                      supers, num_supers, blocks, ti, tf, item_records, items,
                      plane, height, width, stream, depth);
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
