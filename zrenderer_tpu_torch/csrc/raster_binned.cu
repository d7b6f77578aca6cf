// The record and pair-list rasters: K4, K4c and K6 (flat), K4g and K6g
// (G-buffer), K4d and K6d (depth only), and the band kernels K9, K9g and
// K9d of the sharded frames.
//
// Replaces, in zrenderer_tpu/ops/raster_pallas.py:
//   K4   rasterize_setup_pallas_binned_hbm (_binned_hbm_kernel, body
//        _binned_hbm_body): spans of setup records gathered in pair order;
//   K4c  the same with coarse_cap (_binned_hbm_coarse_kernel :2239): plus
//        the coarse list class;
//   K6   rasterize_setup_pallas_binned (_binned_kernel over global pair
//        lists, body _binned_body): spans of row ids into the setup rows;
//   K4g  rasterize_gbuffer_pallas_binned_hbm (_binned_hbm_gbuffer_kernel,
//        body _binned_hbm_body with the G-buffer scratch, no coarse phase);
//   K6g  rasterize_gbuffer_pallas_binned (_binned_gbuffer_kernel, epilogue
//        buf * where(covered, inv, 0) at :1452-1455);
//   K4d, K6d  rasterize_depth_pallas_binned_hbm (_binned_hbm_depth_kernel,
//        body :1887 with depth_only, :1939-1944, :2142-2144) and
//        rasterize_depth_pallas_binned (:1582, _binned_depth_kernel :1490
//        over _binned_body :1219);
//   K9   rasterize_setup_pallas_binned_band (:2413; _binned_hbm_band_kernel
//        :2388, global spans, and _binned_hbm_band_local_kernel :2400,
//        band-local spans);
//   K9g  rasterize_gbuffer_pallas_binned_band (:2501,
//        _binned_hbm_gbuffer_band_kernel :2478);
//   K9d  rasterize_setup_pallas_binned_band_dist (:2701,
//        _binned_hbm_band_dist_kernel_factory :2686; the per-source span
//        loop of _binned_hbm_body at :2047-2069).
// The Pallas functions differ in TPU memory placement (records streamed
// from HBM in aligned slabs, or row ids into VMEM-resident rows); here all
// read global memory.  Inputs are the outputs of prepare_binned_hbm_inputs,
// prepare_binned_inputs and prepare_binned_dist_owner
// (zrenderer_tpu_torch/ops/raster.py).
//
// What every kernel here computes, per 32x128 tile:
//   phase 1:   every entry of [offsets[t], offsets[t+1]) (K9d: of each
//              source's span in turn); each is a guaranteed bbox hit, so
//              there is no bbox test.  Records are (NI32 + 1) ints (the row
//              id last) + NF32 floats; a row-id entry (K6, K6g, K6d) names
//              the setup row that holds them;
//   phase 1.5: (K4c) every record of the tile's coarse bin
//              (ty / COARSE_CB) * ctiles_x + tx / COARSE_CB whose bbox
//              meets the tile (record_hits, the reference's four-sided
//              test);
//   phase 2:   the leftover rows through superblock -> block -> row bbox
//              skips;
//   every phase tests z >= 0 && (z < zb || (z == zb && id < tb)), the
//   order-free (z, row id) tie-break that equals sequential strict-less in
//   submission order (K4d, K6d: z alone, strict-less, the first visited
//   row kept); then one divide per pixel into RGBA8 + f32 depth.
//
// Two bodies compute it.
//
// The keyed body (raster_keyed.cuh; keyed_records below) runs every kernel
// here but K9g: one 64-bit key a pixel in shared memory lowered by
// atomicMin (K4, K4c, K9, K9d, K6: FlatKeys, K4g, K6g: GbufKeys, (order
// bits of z, row id), whose minimum is the (z, row id) tie-break; K4d,
// K6d: DepthKeys, (order bits of z, visit index, sign of z), a span
// entry's visit index its index in the span list, a leftover row's the
// span's end plus its row id), each record evaluated over its window (its
// vertices' pixel bbox in the tile), the leftover rows compacted into the
// same batches by the hierarchy walk.
// * Records staged in shared memory with cp.async, double-buffered: copied
//   from the gathered records (GatheredRecords), or gathered from the
//   setup rows by row id (RowIdRecords, K6, K6g, K6d: the row's NI32 ints,
//   its id, its z coefficients), into the same layout.
// * A tile's record lists are cut into work items of at most item_records
//   records (halved, down to 32, while the launch would have fewer than
//   min_items items: item_size), one block each, which share the tile's
//   leftover superblocks too.  K4, K4g, K4d, K9, K6, K6g and K6d walk one
//   list, the tile's span; K9d its n_src spans, one per source shard, laid
//   end to end; K4c its span and then its coarse bin's records, a coarse
//   record kept by record_hits before its window is prepared (the window
//   alone would let a record whose bbox was clamped away from the tile
//   draw there).  A tile of one item resolves its keys in place; otherwise
//   the items merge through a key plane of the output's size and a second
//   kernel resolves it.  Three device operations a call (memset, items,
//   resolve).
// * K9 and K9d are K4's entry over one band: the band's tiles (row_base,
//   its first global row), band-local planes and key plane (band_h * width
//   keys), global tiles, windows and edge functions, as K3b's
//   (raster_hier.cu).  Band-local spans are indexed by band tile; K9's
//   global spans (band_local = 0) by frame tile, which the launch passes as
//   offsets from the band's first tile (list_base).  K9d's offsets are
//   laid out (n_src, band_tiles + 1), rebased to the concatenated slabs.
// The resolve re-evaluates the winner from hier/tf: K4, K4c, K9, K9d and
// K6 its z (-0.0 kept) and colour, K4g and K6g the same and their 11
// further planes under buf * (covered ? 1/den : 0); K4d and K6d decode z
// from the key.  A record's id (its last int, the reference's L_PID; K9d's
// the canonical id, shard index * shard head + row; a row-id entry's the
// row id itself) and a leftover row's id both index the padded,
// uncompacted setup rows that hier/tf hold (the prepares gather the
// records from them), so the resolve reads the winner from hier/tf
// whichever list it came from.  It reads the winner's edge, z and colour
// (G-buffer) words alone, never the bbox or valid flag that the prepares
// empty in hier for the listed rows.
//
// The register body (gbuffer_records_band_kernel below; raster_common.cuh
// TileState: the tile's state in registers, each record of a span
// evaluated at all 4096 pixels of its tile, one block a tile) runs K9g
// (K4g over one band, band-local spans): it keeps z and the winning row
// id, starts a tile's pixel rows at row_base + i * 32, resolves its 13
// planes from the winner in hier/tf, as K4g, and writes band-local
// (band_h, W) planes.
//
// Bound on the H100: the keyed kernels by their window pixel evaluations
// x 26 ops or the bytes they need (chip_smoke.py keyed_work), the register
// kernel by the per-pixel edge work over its (tile, triangle) pairs x
// 4096 x 26 ops; the G-buffer kernels add their 13 output planes.

#include "raster_keyed.cuh"

namespace zr {

// Coarse bins are COARSE_CB x COARSE_CB tiles (ops/raster.py COARSE_CB, the
// reference's coarse_cb default).
constexpr int COARSE_CB = 4;

// K9g: K4g's register body over one band: the tile's span of gathered
// records (band-local), then the leftover rows, its pixel rows from global
// row row_base; out holds GBUF_PLANES (band_h, width) planes.
__global__ void __launch_bounds__(THREADS) gbuffer_records_band_kernel(
    const int* __restrict__ offsets, const int* __restrict__ rec_i,
    const float* __restrict__ rec_f, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    float* __restrict__ out, int width, int band_h, int row_base) {
  const int tiles_x = width / TILE_W;
  const int tile = blockIdx.x;
  TileState st;
  st.init(row_base + (tile / tiles_x) * TILE_H, (tile % tiles_x) * TILE_W);
  const int end = __ldg(offsets + tile + 1);
  for (int k = __ldg(offsets + tile); k < end; ++k) {
    const int* r = rec_i + (size_t)k * REC_I;
    st.eval_row(r, rec_f + (size_t)k * NF32, __ldg(r + NI32));
  }
  st.scan_hierarchy(supers, num_supers, blocks, ti, tf);
  st.store_gbuffer<true>(ti, tf, out, width, (size_t)width * band_h,
                         row_base);
}

// ---------------------------------------------------------------------------
// The keyed record raster (K4, K4c, K4g, K4d, K9, K9d, K6, K6g, K6d): the
// body of raster_keyed.cuh over a tile's record lists, then the leftover
// rows.
// ---------------------------------------------------------------------------

// Shared memory of a keyed record work item (dynamic: above the 48 KB
// static limit): the keyed body's, and the records staged by cp.async.
struct KeyedSpanSmem : KeyedSmem {
  int raw_i[2][KEY_BATCH * REC_I];  // staged records, double-buffered
  float raw_z[2][KEY_BATCH * 3];    // their z coefficients
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

// Where a list's records come from.  Each stages records [k0, k0 + n) of
// its list into staging buffer buf (REC_I ints a record, the row id last,
// and its 3 z coefficients) by cp.async, one commit.
//
// GatheredRecords: setup records gathered in list order (K4, K4c's coarse
// class, K4g, K4d, K9, K9d), record k at row k of rec_i/rec_f.
struct GatheredRecords {
  const int* rec_i;
  const float* rec_f;

  __device__ __forceinline__ void stage(KeyedSpanSmem& s, int buf, int k0,
                                        int n) const {
    const int* src = rec_i + (size_t)k0 * REC_I;
    for (int w = threadIdx.x; w < n * REC_I; w += THREADS)
      cp_async4(&s.raw_i[buf][w], src + w);
    for (int w = threadIdx.x; w < n * 3; w += THREADS)
      cp_async4(&s.raw_z[buf][w],
                rec_f + (size_t)(k0 + w / 3) * NF32 + F_ZA0 + w % 3);
    __pipeline_commit();
  }
};

// RowIdRecords: row ids into the setup rows (K6, K6g, K6d: pair_tri into
// hier/tf), entry k setup row ids[k], gathered with its id in slot NI32
// (FlatKeys' and GbufKeys' tag, the row the resolve reads back).  The rows
// the lists own have their bbox and valid flag emptied in ti (so the
// leftover walk skips them); the window reads the vertices alone
// (raster_keyed.cuh prepare_record), the resolve the edge, z and colour
// words alone.
struct RowIdRecords {
  const int* ids;
  const int* ti;
  const float* tf;

  __device__ __forceinline__ void stage(KeyedSpanSmem& s, int buf, int k0,
                                        int n) const {
    for (int w = threadIdx.x; w < n * REC_I; w += THREADS) {
      const int j = w / REC_I, c = w - j * REC_I;
      const int t = __ldg(ids + k0 + j);
      if (c < NI32)
        cp_async4(&s.raw_i[buf][w], ti + (size_t)t * NI32 + c);
      else
        s.raw_i[buf][w] = t;
    }
    for (int w = threadIdx.x; w < n * 3; w += THREADS) {
      const int t = __ldg(ids + k0 + w / 3);
      cp_async4(&s.raw_z[buf][w], tf + (size_t)t * NF32 + F_ZA0 + w % 3);
    }
    __pipeline_commit();
  }
};

// The record lists of a keyed launch and their cut into work items.  Tile
// u of the launch (for K9 and K9d the band's tile) owns records
// [offsets[s * src_stride + u], offsets[s * src_stride + u + 1]) of each
// of its n_src span lists, laid end to end (K9d: one list per source
// shard, src_stride = band_tiles + 1; elsewhere one list).  K4c: bin b of
// the coarse class owns records [coffsets[b], coffsets[b + 1]) of
// crec_i/crec_f (unused elsewhere).  Items hold at most item_records
// records, fewer while the launch would have fewer than min_items items
// (item_size).
struct RecordLists {
  const int* offsets;
  const int* coffsets;
  const int* crec_i;
  const float* crec_f;
  int n_src;
  int src_stride;
  int item_records;
  int min_items;
};

// The least item size that item_size halves to (ops/raster.py
// MIN_ITEM_RECORDS).
constexpr int MIN_ITEM_RECORDS = 32;

// The coarse bin of frame tile u.
__device__ __forceinline__ int coarse_bin(int u, int tiles_x) {
  const int ctiles_x = (tiles_x + COARSE_CB - 1) / COARSE_CB;
  return (u / tiles_x / COARSE_CB) * ctiles_x + u % tiles_x / COARSE_CB;
}

// Coarse records are bin residents: the reference's four-sided bbox test
// against the tile, on a staged record.
__device__ __forceinline__ bool record_hits(const int* r, int row0,
                                            int col0) {
  return r[I_JMAX] >= col0 && r[I_JMIN] < col0 + TILE_W &&
         r[I_IMAX] >= row0 && r[I_IMIN] < row0 + TILE_H;
}

// Records of tile u: its spans' (every source's), and with COARSE its
// bin's.
template <bool COARSE>
__device__ __forceinline__ int tile_records(const RecordLists& l, int u,
                                            int tiles_x) {
  int n = 0;
  for (int s = 0; s < l.n_src; ++s) {
    const int* o = l.offsets + (size_t)s * l.src_stride + u;
    n += __ldg(o + 1) - __ldg(o);
  }
  if constexpr (COARSE) {
    const int b = coarse_bin(u, tiles_x);
    n += __ldg(l.coffsets + b + 1) - __ldg(l.coffsets + b);
  }
  return n;
}

// Work items of tile u: its records in pieces of at most item_records, and
// one item for none (the leftovers and the resolve).
template <bool COARSE>
__device__ __forceinline__ int tile_items(const RecordLists& l, int u,
                                          int tiles_x, int item_records) {
  return max(1, (tile_records<COARSE>(l, u, tiles_x) + item_records - 1) /
                    item_records);
}

// The records of all tiles' lists, from the lists' ends alone (a coarse
// bin's counted COARSE_CB^2 times: it serves at most that many tiles).
template <bool COARSE>
__device__ __forceinline__ long long lists_records(const RecordLists& l,
                                                   int num_tiles,
                                                   int tiles_x) {
  long long n = 0;
  for (int s = 0; s < l.n_src; ++s) {
    const int* o = l.offsets + (size_t)s * l.src_stride;
    n += __ldg(o + num_tiles) - __ldg(o);
  }
  if constexpr (COARSE) {
    const int ctiles_x = (tiles_x + COARSE_CB - 1) / COARSE_CB;
    const int bins = ctiles_x * ((num_tiles / tiles_x + COARSE_CB - 1) /
                                 COARSE_CB);
    n += (long long)COARSE_CB * COARSE_CB *
         (__ldg(l.coffsets + bins) - __ldg(l.coffsets));
  }
  return n;
}

// A bound on the launch's work items at item size `size`: a tile of n
// records has at most 1 + n / size items.
__device__ __forceinline__ long long item_bound(int num_tiles,
                                                long long records,
                                                int size) {
  return num_tiles + records / size;
}

// The launch's item size: l.item_records, halved while it stays even and
// at least MIN_ITEM_RECORDS and the lists' records would make fewer than
// l.min_items items (item_bound), so that small lists (a 20K-triangle
// map, a 40K-triangle band) still spread over the card while large ones
// keep l.item_records.  Halved, the items stay under 2 l.min_items, which
// with the bound at l.item_records sizes the launch's grid (ops/raster.py
// keyed_items) without a host sync.
__device__ __forceinline__ int item_size(const RecordLists& l, int num_tiles,
                                         long long records) {
  int size = l.item_records;
  while (size % 2 == 0 && size / 2 >= MIN_ITEM_RECORDS &&
         item_bound(num_tiles, records, size) < l.min_items)
    size /= 2;
  return size;
}

// Items are numbered tile by tile.  Each block finds its own (tile, index,
// count) in s.item, tile -1 past the last item.
template <bool COARSE>
__device__ __forceinline__ void find_item(KeyedSmem& s, const RecordLists& l,
                                          int num_tiles, int tiles_x,
                                          int item_records) {
  const int per = (num_tiles + THREADS - 1) / THREADS;
  const int u0 = min((int)threadIdx.x * per, num_tiles);
  const int u1 = min(u0 + per, num_tiles);
  int local = 0;
  for (int u = u0; u < u1; ++u)
    local += tile_items<COARSE>(l, u, tiles_x, item_records);
  if (threadIdx.x == 0) s.item[0] = -1;
  int total;
  int acc = block_exclusive_scan(local, s.scan, total);
  const int b = (int)blockIdx.x;
  for (int u = u0; u < u1; ++u) {
    const int n = tile_items<COARSE>(l, u, tiles_x, item_records);
    if (b >= acc && b < acc + n) {
      s.item[0] = u;
      s.item[1] = b - acc;
      s.item[2] = n;
    }
    acc += n;
  }
  __syncthreads();
}

// Records [k_begin, k_end) of one list, KEY_BATCH at a time: the next
// batch's copies fly while this one is evaluated.  MASKED (K4c's coarse
// records): a record whose bbox misses the tile adds nothing.
template <class Mode, bool MASKED, class Records>
__device__ __forceinline__ void keyed_span(KeyedSpanSmem& s,
                                           const Records& recs, int k_begin,
                                           int k_end, int row0, int col0) {
  const int batches = (k_end - k_begin + KEY_BATCH - 1) / KEY_BATCH;
  if (batches > 0) recs.stage(s, 0, k_begin, min(KEY_BATCH, k_end - k_begin));
  for (int b = 0; b < batches; ++b) {
    const int k0 = k_begin + b * KEY_BATCH;
    const int nb = min(KEY_BATCH, k_end - k0);
    if (b + 1 < batches) {
      recs.stage(s, (b + 1) & 1, k0 + KEY_BATCH,
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
      if (!MASKED || record_hits(r, row0, col0))
        area = prepare_record(s, j, r, s.raw_z[b & 1] + j * 3,
                              Mode::span_tag(r, k0 + j), row0, col0);
    }
    eval_batch<Mode>(s, area);
  }
}

// The part of a list of n records from record `first` that an item taking
// records [q, q + item_records) of the lists laid end to end reads, the
// list's own records starting at q = 0: [first + lo, first + hi).
__device__ __forceinline__ int2 item_piece(int first, int n, int q,
                                           int item_records) {
  return make_int2(first + min(max(q, 0), n),
                   first + min(max(q + item_records, 0), n));
}

// Work item blockIdx.x: its share of the tile's record lists and of the
// leftover superblocks into the shared keys, then out (raster_keyed.cuh
// keyed_out).  Mode: FlatKeys (K4, K4c, K9, K9d, K6), GbufKeys (K4g, K6g;
// extra: the 11 further planes) or DepthKeys (K4d, K6d).  Records: the
// span lists' GatheredRecords, or RowIdRecords (K6, K6g, K6d).  The item
// takes records [q0, q0 + item_size) of the tile's lists laid end to end:
// its n_src spans in source order, then with COARSE (K4c) its bin's
// records.  The tiles are those of the height rows from global row
// row_base (a band's; 0 for a frame).
template <class Mode, bool COARSE, class Records>
__device__ __forceinline__ void keyed_records(
    const RecordLists& l, const Records& recs,
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, const int* __restrict__ ti,
    const float* __restrict__ tf, unsigned long long* __restrict__ plane,
    int* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ extra, int width, int height, int row_base) {
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSpanSmem& s = *reinterpret_cast<KeyedSpanSmem*>(keyed_smem);
  const int tiles_x = width / TILE_W;
  const int num_tiles = tiles_x * (height / TILE_H);
  const long long records = lists_records<COARSE>(l, num_tiles, tiles_x);
  const int item_records = item_size(l, num_tiles, records);
  // The grid bounds the items by the record buffers' sizes, which a list
  // may fill far less (K6's pair_tri holds n_head * cap slots): the blocks
  // past the lists' own bound return before they scan the tiles.
  if (blockIdx.x >= item_bound(num_tiles, records, item_records))
    return;  // (block-uniform)
  find_item<COARSE>(s, l, num_tiles, tiles_x, item_records);
  const int tile = s.item[0], idx = s.item[1], n_items = s.item[2];
  if (tile < 0) return;  // past the last item
  const int row0 = row_base + (tile / tiles_x) * TILE_H;
  const int col0 = (tile % tiles_x) * TILE_W;
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS) s.key[p] = Mode::CLEAR;
  __syncthreads();
  int q = idx * item_records;  // the item's first record, from this list's
  int lists_end = 0;           // the last span's end (DepthKeys' leftovers)
  for (int src = 0; src < l.n_src; ++src) {
    const int* o = l.offsets + (size_t)src * l.src_stride + tile;
    const int first = __ldg(o), n = __ldg(o + 1) - first;
    const int2 k = item_piece(first, n, q, item_records);
    keyed_span<Mode, false>(s, recs, k.x, k.y, row0, col0);
    q -= n;
    lists_end = first + n;
  }
  if constexpr (COARSE) {
    const int b = coarse_bin(tile, tiles_x);
    const int first = __ldg(l.coffsets + b);
    const int2 k = item_piece(first, __ldg(l.coffsets + b + 1) - first, q,
                              item_records);
    keyed_span<Mode, true>(s, GatheredRecords{l.crec_i, l.crec_f}, k.x, k.y,
                           row0, col0);
  }
  keyed_leftovers<Mode>(
      s, supers, (int)((long long)idx * num_supers / n_items),
      (int)((long long)(idx + 1) * num_supers / n_items), blocks, ti, tf,
      lists_end, row0, col0);
  __syncthreads();
  keyed_out<Mode>(s, n_items == 1, plane, row0, col0, ti, tf, color, depth,
                  extra, width, height, row_base);
}

// The tiles of several items: their merged keys in the plane, resolved.
template <class Mode, bool COARSE = false>
__device__ __forceinline__ void keyed_resolve(
    const RecordLists& l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ extra, int width, int height, int row_base) {
  const int tile = blockIdx.x, tiles_x = width / TILE_W;
  const int num_tiles = tiles_x * (height / TILE_H);
  const int item_records = item_size(
      l, num_tiles, lists_records<COARSE>(l, num_tiles, tiles_x));
  if (tile_items<COARSE>(l, tile, tiles_x, item_records) == 1) return;
  resolve_tile<Mode>(plane, row_base + (tile / tiles_x) * TILE_H,
                     (tile % tiles_x) * TILE_W, ti, tf, color, depth, extra,
                     width, height, row_base);
}

// One item kernel and one resolve kernel a keyed kernel.  Each takes (...,
// width, height, row_base); all but K9 and K9d draw a frame (row_base 0).
// K4: flat planes.
__global__ void __launch_bounds__(THREADS) raster_records_kernel(
    RecordLists l, GatheredRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_records<FlatKeys, false>(l, recs, supers, num_supers, blocks, ti, tf,
                                 plane, color, depth, nullptr, width, height,
                                 row_base);
}

__global__ void __launch_bounds__(THREADS) raster_records_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height, int row_base) {
  keyed_resolve<FlatKeys>(l, plane, ti, tf, color, depth, nullptr, width,
                          height, row_base);
}

// K4c: K4 with the coarse class.
__global__ void __launch_bounds__(THREADS) raster_records_coarse_keyed_kernel(
    RecordLists l, GatheredRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_records<FlatKeys, true>(l, recs, supers, num_supers, blocks, ti, tf,
                                plane, color, depth, nullptr, width, height,
                                row_base);
}

__global__ void __launch_bounds__(THREADS)
    raster_records_coarse_resolve_kernel(
        RecordLists l, const unsigned long long* __restrict__ plane,
        const int* __restrict__ ti, const float* __restrict__ tf,
        int* __restrict__ color, float* __restrict__ depth, int width,
        int height, int row_base) {
  keyed_resolve<FlatKeys, true>(l, plane, ti, tf, color, depth, nullptr,
                                width, height, row_base);
}

// K9: K4 over the band of height rows from global row row_base.
__global__ void __launch_bounds__(THREADS) raster_records_band_keyed_kernel(
    RecordLists l, GatheredRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_records<FlatKeys, false>(l, recs, supers, num_supers, blocks, ti, tf,
                                 plane, color, depth, nullptr, width, height,
                                 row_base);
}

__global__ void __launch_bounds__(THREADS) raster_records_band_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height, int row_base) {
  keyed_resolve<FlatKeys>(l, plane, ti, tf, color, depth, nullptr, width,
                          height, row_base);
}

// K9d: K9 over the band's n_src span lists, one per source shard.
__global__ void __launch_bounds__(THREADS) raster_records_dist_keyed_kernel(
    RecordLists l, GatheredRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_records<FlatKeys, false>(l, recs, supers, num_supers, blocks, ti, tf,
                                 plane, color, depth, nullptr, width, height,
                                 row_base);
}

__global__ void __launch_bounds__(THREADS) raster_records_dist_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height, int row_base) {
  keyed_resolve<FlatKeys>(l, plane, ti, tf, color, depth, nullptr, width,
                          height, row_base);
}

// K4g: the GBUF_PLANES planes of out (color bits, depth, then the rest),
// width * height floats apart.
__global__ void __launch_bounds__(THREADS) gbuffer_records_keyed_kernel(
    RecordLists l, GatheredRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_records<GbufKeys, false>(l, recs, supers, num_supers, blocks, ti, tf,
                                 plane, reinterpret_cast<int*>(out),
                                 out + frame, out + 2 * frame, width, height,
                                 row_base);
}

__global__ void __launch_bounds__(THREADS) gbuffer_records_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    float* __restrict__ out, int width, int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_resolve<GbufKeys>(l, plane, ti, tf, reinterpret_cast<int*>(out),
                          out + frame, out + 2 * frame, width, height,
                          row_base);
}

// K4d: the depth plane alone.
__global__ void __launch_bounds__(THREADS) depth_records_kernel(
    RecordLists l, GatheredRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int width, int height, int row_base) {
  keyed_records<DepthKeys, false>(l, recs, supers, num_supers, blocks, ti,
                                  tf, plane, nullptr, depth, nullptr, width,
                                  height, row_base);
}

__global__ void __launch_bounds__(THREADS) depth_records_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_resolve<DepthKeys>(l, plane, ti, tf, nullptr, depth, nullptr, width,
                           height, row_base);
}

// K6: K4 over a tile's row-id span (the setup rows gathered by id).
__global__ void __launch_bounds__(THREADS) raster_lists_keyed_kernel(
    RecordLists l, RowIdRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_records<FlatKeys, false>(l, recs, supers, num_supers, blocks, ti, tf,
                                 plane, color, depth, nullptr, width, height,
                                 row_base);
}

__global__ void __launch_bounds__(THREADS) raster_lists_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    int* __restrict__ color, float* __restrict__ depth, int width,
    int height, int row_base) {
  keyed_resolve<FlatKeys>(l, plane, ti, tf, color, depth, nullptr, width,
                          height, row_base);
}

// K6g: K4g over a tile's row-id span; out as K4g's.
__global__ void __launch_bounds__(THREADS) gbuffer_lists_keyed_kernel(
    RecordLists l, RowIdRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_records<GbufKeys, false>(l, recs, supers, num_supers, blocks, ti, tf,
                                 plane, reinterpret_cast<int*>(out),
                                 out + frame, out + 2 * frame, width, height,
                                 row_base);
}

__global__ void __launch_bounds__(THREADS) gbuffer_lists_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    float* __restrict__ out, int width, int height, int row_base) {
  const size_t frame = (size_t)width * height;
  keyed_resolve<GbufKeys>(l, plane, ti, tf, reinterpret_cast<int*>(out),
                          out + frame, out + 2 * frame, width, height,
                          row_base);
}

// K6d: K4d over a tile's row-id span (the setup rows gathered by id).
__global__ void __launch_bounds__(THREADS) depth_lists_keyed_kernel(
    RecordLists l, RowIdRecords recs, const int* __restrict__ supers,
    int num_supers, const int* __restrict__ blocks,
    const int* __restrict__ ti, const float* __restrict__ tf,
    unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int width, int height, int row_base) {
  keyed_records<DepthKeys, false>(l, recs, supers, num_supers, blocks, ti,
                                  tf, plane, nullptr, depth, nullptr, width,
                                  height, row_base);
}

__global__ void __launch_bounds__(THREADS) depth_lists_resolve_kernel(
    RecordLists l, const unsigned long long* __restrict__ plane,
    const int* __restrict__ ti, const float* __restrict__ tf,
    float* __restrict__ depth, int width, int height, int row_base) {
  keyed_resolve<DepthKeys>(l, plane, ti, tf, nullptr, depth, nullptr, width,
                           height, row_base);
}

}  // namespace zr

// The keyed launches (every kernel here but K9g): the key plane
// (height * width keys, a band's for K9 and K9d) set to all ones, `items`
// blocks (a bound on the work items: ops/raster.py keyed_items), then the
// resolve over the tiles.
template <class Items, class Resolve, class Records, class... Out>
static int launch_keyed(Items items_kernel, Resolve resolve_kernel,
                        zr::RecordLists lists, Records recs,
                        const int* supers, int num_supers, const int* blocks,
                        const int* ti, const float* tf, int items,
                        unsigned long long* plane, int height, int width,
                        int row_base, void* stream, Out... out) {
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
      lists, recs, supers, num_supers, blocks, ti, tf, plane, out..., width,
      height, row_base);
  resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
      lists, plane, ti, tf, out..., width, height, row_base);
  return (int)cudaGetLastError();
}

// One span list a tile, at `offsets`, cut into items of at most
// item_records (fewer while under min_items items).
static zr::RecordLists span_lists(const int* offsets, int item_records,
                                  int min_items) {
  return zr::RecordLists{offsets, nullptr, nullptr,     nullptr,
                         1,       0,       item_records, min_items};
}

// Dynamic shared memory of a keyed record work item, in bytes.
extern "C" int zr_keyed_smem_bytes() {
  return (int)sizeof(zr::KeyedSpanSmem);
}

// Each keyed entry takes (..., item_records, min_items, items, plane, ...):
// the largest item, the items item_size aims at, the grid and the key
// plane (ops/raster.py _keyed_launch).
// K4.
extern "C" int zr_raster_records_keyed(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int min_items, int items,
    unsigned long long* plane, int* color, float* depth, int height,
    int width, void* stream) {
  return launch_keyed(
      zr::raster_records_kernel, zr::raster_records_resolve_kernel,
      span_lists(offsets, item_records, min_items),
      zr::GatheredRecords{rec_i, rec_f}, supers, num_supers, blocks, ti, tf,
      items, plane, height, width, 0, stream, color, depth);
}

// K4c: K4's lists and the coarse class (coffsets, crec_i, crec_f).
extern "C" int zr_raster_records(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* coffsets, const int* crec_i, const float* crec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int min_items, int items,
    unsigned long long* plane, int* color, float* depth, int height,
    int width, void* stream) {
  return launch_keyed(
      zr::raster_records_coarse_keyed_kernel,
      zr::raster_records_coarse_resolve_kernel,
      zr::RecordLists{offsets, coffsets, crec_i, crec_f, 1, 0, item_records,
                      min_items},
      zr::GatheredRecords{rec_i, rec_f}, supers, num_supers, blocks, ti, tf,
      items, plane, height, width, 0, stream, color, depth);
}

// K6: the row-id spans of pair_tri into ti/tf (hier: the listed rows'
// bboxes emptied).
extern "C" int zr_raster_lists(const int* offsets, const int* pair_tri,
                               const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, int item_records,
                               int min_items, int items,
                               unsigned long long* plane, int* color,
                               float* depth, int height, int width,
                               void* stream) {
  return launch_keyed(
      zr::raster_lists_keyed_kernel, zr::raster_lists_resolve_kernel,
      span_lists(offsets, item_records, min_items),
      zr::RowIdRecords{pair_tri, ti, tf}, supers, num_supers, blocks, ti, tf,
      items, plane, height, width, 0, stream, color, depth);
}

// K4g.
extern "C" int zr_gbuffer_records_keyed(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int min_items, int items,
    unsigned long long* plane, float* out, int height, int width,
    void* stream) {
  return launch_keyed(
      zr::gbuffer_records_keyed_kernel, zr::gbuffer_records_resolve_kernel,
      span_lists(offsets, item_records, min_items),
      zr::GatheredRecords{rec_i, rec_f}, supers, num_supers, blocks, ti, tf,
      items, plane, height, width, 0, stream, out);
}

// K6g: K6's row-id spans, the G-buffer planes.
extern "C" int zr_gbuffer_lists(const int* offsets, const int* pair_tri,
                                const int* supers, int num_supers,
                                const int* blocks, const int* ti,
                                const float* tf, int item_records,
                                int min_items, int items,
                                unsigned long long* plane, float* out,
                                int height, int width, void* stream) {
  return launch_keyed(
      zr::gbuffer_lists_keyed_kernel, zr::gbuffer_lists_resolve_kernel,
      span_lists(offsets, item_records, min_items),
      zr::RowIdRecords{pair_tri, ti, tf}, supers, num_supers, blocks, ti, tf,
      items, plane, height, width, 0, stream, out);
}

// K4d.
extern "C" int zr_depth_records_keyed(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int min_items, int items,
    unsigned long long* plane, float* depth, int height, int width,
    void* stream) {
  return launch_keyed(
      zr::depth_records_kernel, zr::depth_records_resolve_kernel,
      span_lists(offsets, item_records, min_items),
      zr::GatheredRecords{rec_i, rec_f}, supers, num_supers, blocks, ti, tf,
      items, plane, height, width, 0, stream, depth);
}

// K6d: the row-id spans of pair_tri into ti/tf (hier: the listed rows'
// bboxes emptied).
extern "C" int zr_depth_lists(const int* offsets, const int* pair_tri,
                              const int* supers, int num_supers,
                              const int* blocks, const int* ti,
                              const float* tf, int item_records,
                              int min_items, int items,
                              unsigned long long* plane, float* depth,
                              int height, int width, void* stream) {
  return launch_keyed(
      zr::depth_lists_keyed_kernel, zr::depth_lists_resolve_kernel,
      span_lists(offsets, item_records, min_items),
      zr::RowIdRecords{pair_tri, ti, tf}, supers, num_supers, blocks, ti, tf,
      items, plane, height, width, 0, stream, depth);
}

// K9: the band_h rows from global row row_base, a band-sized key plane;
// band_local = 1 for spans indexed by band tile, 0 for global tiles (the
// offsets passed on from the band's first tile, list_base).
extern "C" int zr_raster_records_band(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int min_items, int items,
    unsigned long long* plane, int* color, float* depth, int band_h,
    int width, int row_base, int band_local, void* stream) {
  const int list_base =
      band_local ? 0 : (row_base / zr::TILE_H) * (width / zr::TILE_W);
  return launch_keyed(
      zr::raster_records_band_keyed_kernel,
      zr::raster_records_band_resolve_kernel,
      span_lists(offsets + list_base, item_records, min_items),
      zr::GatheredRecords{rec_i, rec_f}, supers, num_supers, blocks, ti, tf,
      items, plane, band_h, width, row_base, stream, color, depth);
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

// K9d: K9 over offsets (n_src, band_tiles + 1), each source's band-local
// spans rebased to the concatenated slabs rec_i/rec_f.
extern "C" int zr_raster_records_dist(
    const int* offsets, const int* rec_i, const float* rec_f,
    const int* supers, int num_supers, const int* blocks, const int* ti,
    const float* tf, int item_records, int min_items, int items,
    unsigned long long* plane, int* color, float* depth, int band_h,
    int width, int row_base, int n_src, void* stream) {
  const int band_tiles = (band_h / zr::TILE_H) * (width / zr::TILE_W);
  return launch_keyed(
      zr::raster_records_dist_keyed_kernel,
      zr::raster_records_dist_resolve_kernel,
      zr::RecordLists{offsets, nullptr, nullptr, nullptr, n_src,
                      band_tiles + 1, item_records, min_items},
      zr::GatheredRecords{rec_i, rec_f}, supers, num_supers, blocks, ti, tf,
      items, plane, band_h, width, row_base, stream, color, depth);
}
