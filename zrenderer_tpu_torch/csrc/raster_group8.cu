// K10g8, K10g8g and K10g8d: the group-tile binned raster, flat, G-buffer
// and depth-only.
//
// Replaces rasterize_setup_pallas_group8, rasterize_gbuffer_pallas_group8
// and rasterize_depth_pallas_group8
// (zrenderer_tpu/ops/experiments/raster_group8.py, _run :650, body
// _group8_body :259).  Inputs are the outputs of prepare_group8_inputs
// (zrenderer_tpu_torch/ops/experiments/raster_group8.py): per 8x128 list
// tile a span [offs[t], offs[t+1]) of list rows (ROW_LANES int32 lanes,
// sorted by row id, the row id in lane C_ID), a per-tile gate tile_any, the
// leftover setup rows (listed rows' bbox and valid flag emptied, their
// vertices, edges and floats intact) and their block, superblock and
// megablock union bboxes.
//
// What the reference computes, per 8x128 tile:
// * phase 1: the tile's span, each row evaluated at the tile's pixels with
//   the list row's edge form e = (dx*py + c) - dy*px, c = dy*x_ref -
//   dx*y_ref (wrapping like the reference's int32), and its bias bits;
// * phase 2, if tile_any: megablocks -> superblocks -> blocks -> rows
//   whose bbox meets the tile, in row order, with the setup rows' own edge
//   form dx*(py - y) - dy*(px - x) (the same int32 value);
// * the depth test: the (z, row id) lexicographic minimum from (1.0,
//   INT_MAX) over both phases (flat and G-buffer: a leftover row can have
//   a lower id than a listed one, so the test is not strict-less in visit
//   order), or for the depth-only pass the strict-less z test z >= 0 &&
//   z < zb in visit order, z alone kept;
// * the epilogue from the winner's setup row (its edge values are the
//   same integers in either form): colour where(covered, numer*inv, 0)
//   packed RGBA8 with alpha 255, depth, and for the G-buffer the
//   interpolants as buf * (covered ? inv : 0) (the reference's :584-600,
//   K2g/K4g/K5g's form) and the constants as they are.
//
// All three run the keyed body (raster_keyed.cuh) on 32x128 key tiles,
// each the four 8x128 list tiles below one another, with the planes of the
// register body they ran before bit for bit.  What bound that body on the
// H100 (K10g8 3.49 ms a call on lattice1M at 1920x1088, K10g8g 1.50 on
// lattice40k, K10g8d 1.00 on the 20K lattice's 1024x1024 map; 4 pixels a
// thread): each list row evaluated at all 1024 pixels of its tile, and
// every gated tile re-walking the megablock -> superblock -> block -> row
// tables from the start.  Here (group8_items, one template on the key
// type):
// * group8_hit_words_kernel writes each key tile's hit words over the
//   leftover hierarchy once a call (K5's tile_hit_words: a block is a hit
//   block when its bbox and its superblock's meet the key tile; a
//   superblock that meets one of the key tile's list tiles meets the key
//   tile, and lies in a megablock that does, so the megablock level adds
//   no skip);
// * a key tile's work, its four list tiles' spans laid end to end (E
//   entries) and its hit blocks (H), is cut into `items` work items, one
//   CUDA block each: item i takes entries [i E / items, (i + 1) E / items)
//   and hit blocks [i H / items, (i + 1) H / items);
// * a list entry names its setup row by id (lane C_ID): the row is read
//   from the leftover rows, whose vertices the prepare leaves intact, as
//   K6's RowIdRecords stage them, and evaluated over its window, its
//   vertices' pixel bbox cut to its own 8x128 list tile;
// * a hit block's rows whose bbox meets the key tile are pended (K5's
//   keyed_block_rows test), each over its vertices' pixel bbox cut to the
//   8x128 list tiles its bbox meets whose tile_any is set (every one: a
//   row with a non-empty bbox is valid, so in its superblock's bbox);
//   entries and rows share the pending batches (an entry marked by
//   LIST_ENTRY);
// * one key a pixel.  K10g8 and K10g8g: (order bits of z, row id) from
//   the clear key (1.0, INT_MAX), so a row at z == 1.0 latches as the (z,
//   row id) test lets it: FlatKeys, and GbufKeys (K4g's and K6g's, the
//   epilogue buf * (covered ? inv : 0)).  K10g8d: DepthKeys, (order bits
//   of z, visit index, sign of z) from (1.0, 0), the strict-less test in
//   visit order, whose minimum keeps the first visited row of the least z
//   (only the sign of a zero z tells two such rows apart): an entry's
//   visit index is q, its index in the key tile's spans laid end to end,
//   which rises in span order within each list tile; a leftover row t's
//   is E + t, above every entry of every list tile its window meets, in
//   row order.  A pixel is only written by its own list tile's entries and
//   by leftovers, so the key's order is the reference's per list tile.
//   Items merge by atomicMin into a key plane (memset to all ones) and a
//   resolve writes the planes (a key tile whose work is at most one entry
//   and one hit block resolves in place in its last item): K10g8 and
//   K10g8g re-evaluate the winner from the leftover rows (its -0.0 kept),
//   K10g8d decodes z and its sign from the key.
// The windows never reach past the list tiles the reference evaluates, so
// rows below the last listed or gated tile (the padding rows of a 1080-row
// frame in a 1088-row target) stay clear.  A target whose height is not a
// multiple of 32 is run on planes padded to one (the wrapper returns the
// target's rows).  Four device ops a call: hit words, memset, items,
// resolve.  Bound on the H100: the window pixels' edge work (26 ops each),
// or the bytes the body needs (spans, tables, entries and admitted rows,
// the 2, 13 or 1 planes).

#include "raster_keyed.cuh"

namespace zr {
namespace g8 {

constexpr int GT_H = 8;
constexpr int ROW_LANES = 47;
constexpr int LISTS = TILE_H / GT_H;  // list tiles a key tile
constexpr int LIST_ENTRY = 1 << 30;   // a pending entry that is a list entry

constexpr int C_ID = 10;  // a list row's row id lane (raster_group8.py)

// One call's list inputs: the spans (offs, tiles8_y * tiles_x + 1 of
// them), the gate and the list rows, of a target of tiles8_y list-tile
// rows.
struct Lists {
  const int* offs;
  const int* tile_any;
  const int* rows;
  int tiles8_y;
};

// The spans of key tile (ty, tx)'s list tiles, top to bottom: list tile k
// (global list-tile row 4 ty + k, absent past tiles8_y: no entries) holds
// its span's first entry first[k] and ends[k] entries in all up to it.
// Returns the key tile's entries E.
__device__ __forceinline__ int key_tile_spans(const Lists& l, int ty, int tx,
                                              int tiles_x, int* first,
                                              int* ends) {
  int e = 0;
#pragma unroll
  for (int k = 0; k < LISTS; ++k) {
    const int ly = ty * LISTS + k;
    first[k] = 0;
    if (ly < l.tiles8_y) {
      const int* o = l.offs + (size_t)ly * tiles_x + tx;
      first[k] = __ldg(o);
      e += __ldg(o + 1) - first[k];
    }
    ends[k] = e;
  }
  return e;
}

// List tile k of the key tile from global row row0 is gated: it exists
// (row0 / GT_H + k < tiles8_y) and its tile_any is set.
__device__ __forceinline__ bool gated(const Lists& l, int row0, int col0,
                                      int tiles_x, int k) {
  const int ly = row0 / GT_H + k;
  return ly < l.tiles8_y &&
         __ldg(l.tile_any + (size_t)ly * tiles_x + col0 / TILE_W) > 0;
}

// Hit words of key tile blockIdx.x over the leftover hierarchy, as K5's.
__global__ void __launch_bounds__(THREADS) group8_hit_words_kernel(
    const int* __restrict__ supers, int num_supers,
    const int* __restrict__ blocks, int* buf, int width, int key_h) {
  __shared__ int warp_sums[WARPS];
  const int tiles_x = width / TILE_W, tile = (int)blockIdx.x;
  tile_hit_words(supers, num_supers, blocks, buf,
                 tiles_x * (key_h / TILE_H), tile, (tile / tiles_x) * TILE_H,
                 (tile % tiles_x) * TILE_W, warp_sums);
}

// Work item blockIdx.x is item i = blockIdx.x % items of key tile
// blockIdx.x / items: its share of the key tile's list entries and of its
// hit blocks (an item with neither returns at once), pended together;
// each pending entry is evaluated over its window in its list tile, each
// pending leftover row over its window in its gated list tiles.  Then out
// (keyed_out): the tile's planes from the item that holds all its work
// (one item a tile, or at most one entry and one hit block: the last
// item), else into the key plane.  The planes (extra: Keys's further
// planes) and the key plane hold key_h rows.
template <class Keys>
__device__ __forceinline__ void group8_items(
    const Lists& l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int key_h) {
  extern __shared__ __align__(16) unsigned char keyed_smem[];
  KeyedSmem& s = *reinterpret_cast<KeyedSmem*>(keyed_smem);
  const int tiles_x = width / TILE_W, tiles = tiles_x * (key_h / TILE_H);
  const int tile = (int)blockIdx.x / items, item = (int)blockIdx.x % items;
  const int ty = tile / tiles_x, tx = tile % tiles_x;
  const int row0 = ty * TILE_H, col0 = tx * TILE_W;
  int first[LISTS], ends[LISTS];
  const int entries = key_tile_spans(l, ty, tx, tiles_x, first, ends);
  const HitWords<const int> hw = hit_words(buf, tiles, num_supers);
  const int total = __ldg(hw.count + tile);
  const int e0 = (int)((long long)item * entries / items);
  const int e1 = (int)((long long)(item + 1) * entries / items);
  const int h0 = item * total / items, h1 = (item + 1) * total / items;
  const bool alone =
      items == 1 || (entries <= 1 && total <= 1 && item == items - 1);
  if (e0 == e1 && h0 == h1 && !alone) return;  // block-uniform
  for (int p = threadIdx.x; p < TILE_PIX; p += THREADS)
    s.key[p] = Keys::CLEAR;
  __syncthreads();
  // The first n pending entries and rows as one batch.
  auto flush = [&](int n) {
    int area = 0;
    const int j = threadIdx.x;
    if (j < n) {
      const int code = s.pending[j];
      // The key's tag (Keys::entry_tag, Keys::row_tag): a row id, or
      // DepthKeys' visit index, q for entry q and entries + t for leftover
      // row t: both codes are below LIST_ENTRY (2^30), so the index is
      // below 2^31 and the key holds it shifted by one.
      int t, lo = 0, k1 = -1;
      uint32_t tag;
      if (code & LIST_ENTRY) {
        const int q = code - LIST_ENTRY;
        int k = 0, at = first[0] + q;  // its list tile, its list row
#pragma unroll
        for (int i = 0; i < LISTS - 1; ++i)
          if (q >= ends[i]) {
            k = i + 1;
            at = first[i + 1] + q - ends[i];
          }
        t = __ldg(l.rows + (size_t)at * ROW_LANES + C_ID);
        tag = Keys::entry_tag(t, q);
        lo = k1 = k;
      } else {
        t = code;
        tag = Keys::row_tag(t, entries);
        const int* r = ti + (size_t)t * NI32;
        lo = (max(__ldg(r + I_IMIN), row0) - row0) / GT_H;
        k1 = (min(__ldg(r + I_IMAX), row0 + TILE_H - 1) - row0) / GT_H;
        while (lo <= k1 && !gated(l, row0, col0, tiles_x, lo)) ++lo;
        while (k1 >= lo && !gated(l, row0, col0, tiles_x, k1)) --k1;
      }
      if (lo <= k1)
        area = prepare_record(s, j, ti + (size_t)t * NI32,
                              tf + (size_t)t * NF32 + F_ZA0,
                              tag, row0, col0, lo * GT_H,
                              (k1 - lo + 1) * GT_H);
    }
    eval_batch<Keys>(s, area);
  };
  int pending = 0;  // block-uniform
  for (int base = e0; base < e1; base += KEY_BATCH) {
    const int q = base + (int)threadIdx.x;
    keyed_pend(s, threadIdx.x < KEY_BATCH && q < e1, q | LIST_ENTRY,
               pending, flush);
  }
  walk_hit_blocks(
      s, hw.words + (size_t)tile * num_supers,
      hw.before + (size_t)tile * num_supers, num_supers, total, h0, h1,
      [&](int b) {
        const int t = b * RASTER_BLOCK + (int)threadIdx.x;
        bool hit = false;
        if (threadIdx.x < RASTER_BLOCK) {
          const int* r = ti + (size_t)t * NI32;
          hit = tile_overlap(__ldg(r + I_JMIN), __ldg(r + I_JMAX),
                             __ldg(r + I_IMIN), __ldg(r + I_IMAX), row0,
                             col0);
        }
        keyed_pend(s, hit, t, pending, flush);
      });
  if (pending > 0) {
    __syncthreads();
    flush(pending);
  }
  __syncthreads();
  keyed_out<Keys>(s, alone, plane, row0, col0, ti, tf, color, depth, extra,
                  width, key_h);
}

// The resolve of a key tile of several items with more than one entry or
// more than one hit block.
template <class Keys>
__device__ __forceinline__ void group8_resolve(
    const Lists& l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf,
    const unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, float* __restrict__ extra, int width,
    int key_h) {
  const int tiles_x = width / TILE_W, tiles = tiles_x * (key_h / TILE_H);
  const int tile = (int)blockIdx.x;
  const int ty = tile / tiles_x, tx = tile % tiles_x;
  int first[LISTS], ends[LISTS];
  const int entries = key_tile_spans(l, ty, tx, tiles_x, first, ends);
  if (entries <= 1 &&
      __ldg(hit_words(buf, tiles, num_supers).count + tile) <= 1)
    return;  // resolved in place
  resolve_tile<Keys>(plane, ty * TILE_H, tx * TILE_W, ti, tf, color, depth,
                     extra, width, key_h);
}

// One entry point per kernel, so each has its own name in a profile.
// K10g8: packed colour and depth.
__global__ void __launch_bounds__(THREADS) raster_group8_keyed_kernel(
    Lists l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int key_h) {
  group8_items<FlatKeys>(l, buf, num_supers, ti, tf, items, plane, color,
                         depth, nullptr, width, key_h);
}

__global__ void __launch_bounds__(THREADS) raster_group8_resolve_kernel(
    Lists l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf,
    const unsigned long long* __restrict__ plane, int* __restrict__ color,
    float* __restrict__ depth, int width, int key_h) {
  group8_resolve<FlatKeys>(l, buf, num_supers, ti, tf, plane, color, depth,
                           nullptr, width, key_h);
}

// K10g8g: out holds the GBUF_PLANES planes, width * key_h floats apart.
__global__ void __launch_bounds__(THREADS) gbuffer_group8_keyed_kernel(
    Lists l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int key_h) {
  const size_t frame = (size_t)width * key_h;
  group8_items<GbufKeys>(l, buf, num_supers, ti, tf, items, plane,
                         reinterpret_cast<int*>(out), out + frame,
                         out + 2 * frame, width, key_h);
}

__global__ void __launch_bounds__(THREADS) gbuffer_group8_resolve_kernel(
    Lists l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf,
    const unsigned long long* __restrict__ plane, float* __restrict__ out,
    int width, int key_h) {
  const size_t frame = (size_t)width * key_h;
  group8_resolve<GbufKeys>(l, buf, num_supers, ti, tf, plane,
                           reinterpret_cast<int*>(out), out + frame,
                           out + 2 * frame, width, key_h);
}

// K10g8d: the one depth plane.
__global__ void __launch_bounds__(THREADS) depth_group8_keyed_kernel(
    Lists l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf, int items,
    unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int width, int key_h) {
  group8_items<DepthKeys>(l, buf, num_supers, ti, tf, items, plane, nullptr,
                          depth, nullptr, width, key_h);
}

__global__ void __launch_bounds__(THREADS) depth_group8_resolve_kernel(
    Lists l, const int* __restrict__ buf, int num_supers,
    const int* __restrict__ ti, const float* __restrict__ tf,
    const unsigned long long* __restrict__ plane, float* __restrict__ depth,
    int width, int key_h) {
  group8_resolve<DepthKeys>(l, buf, num_supers, ti, tf, plane, nullptr,
                            depth, nullptr, width, key_h);
}

}  // namespace g8
}  // namespace zr

// K10g8, K10g8g and K10g8d: the hit words, then with several items a tile
// the key plane set to all ones, key tiles * items work items and the
// resolve over the key tiles.  The planes (out...) hold key_h rows (the
// target's height rounded up to TILE_H), the target's tiles8_y list-tile
// rows first.
// num_supers: the superblocks that hold blocks (blocks / SUPER_BLOCK);
// buf: key tiles * (2 num_supers + 1) ints of hit words; plane: key_h *
// width keys, unused with one item a tile.
template <class Items, class Resolve, class... Out>
static int launch_group8(Items items_kernel, Resolve resolve_kernel,
                         const int* offs, const int* tile_any,
                         const int* rows, int tiles8_y, const int* supers,
                         int num_supers, const int* blocks, const int* ti,
                         const float* tf, int items, int* buf,
                         unsigned long long* plane, int key_h, int width,
                         void* stream, Out... out) {
  const int num_tiles = (key_h / zr::TILE_H) * (width / zr::TILE_W);
  const cudaStream_t s = (cudaStream_t)stream;
  const zr::g8::Lists l{offs, tile_any, rows, tiles8_y};
  const int smem = (int)sizeof(zr::KeyedSmem);
  cudaError_t err = cudaFuncSetAttribute(
      items_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  zr::g8::group8_hit_words_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
      supers, num_supers, blocks, buf, width, key_h);
  if (items > 1) {
    err = cudaMemsetAsync(plane, 0xff,
                          (size_t)key_h * width * sizeof(*plane), s);
    if (err != cudaSuccess) return (int)err;
  }
  items_kernel<<<num_tiles * items, zr::THREADS, smem, s>>>(
      l, buf, num_supers, ti, tf, items, plane, out..., width, key_h);
  if (items > 1)
    resolve_kernel<<<num_tiles, zr::THREADS, 0, s>>>(
        l, buf, num_supers, ti, tf, plane, out..., width, key_h);
  return (int)cudaGetLastError();
}

// K10g8: packed color (int bits) and depth.
extern "C" int zr_raster_group8(const int* offs, const int* tile_any,
                                const int* rows, int tiles8_y,
                                const int* supers, int num_supers,
                                const int* blocks, const int* ti,
                                const float* tf, int items, int* buf,
                                unsigned long long* plane, int* color,
                                float* depth, int key_h, int width,
                                void* stream) {
  return launch_group8(zr::g8::raster_group8_keyed_kernel,
                       zr::g8::raster_group8_resolve_kernel, offs, tile_any,
                       rows, tiles8_y, supers, num_supers, blocks, ti, tf,
                       items, buf, plane, key_h, width, stream, color,
                       depth);
}

// K10g8g: the GBUF_PLANES planes back to back.
extern "C" int zr_gbuffer_group8(const int* offs, const int* tile_any,
                                 const int* rows, int tiles8_y,
                                 const int* supers, int num_supers,
                                 const int* blocks, const int* ti,
                                 const float* tf, int items, int* buf,
                                 unsigned long long* plane, float* out,
                                 int key_h, int width, void* stream) {
  return launch_group8(zr::g8::gbuffer_group8_keyed_kernel,
                       zr::g8::gbuffer_group8_resolve_kernel, offs,
                       tile_any, rows, tiles8_y, supers, num_supers, blocks,
                       ti, tf, items, buf, plane, key_h, width, stream, out);
}

// K10g8d: the one depth plane.
extern "C" int zr_depth_group8(const int* offs, const int* tile_any,
                               const int* rows, int tiles8_y,
                               const int* supers, int num_supers,
                               const int* blocks, const int* ti,
                               const float* tf, int items, int* buf,
                               unsigned long long* plane, float* depth,
                               int key_h, int width, void* stream) {
  return launch_group8(zr::g8::depth_group8_keyed_kernel,
                       zr::g8::depth_group8_resolve_kernel, offs, tile_any,
                       rows, tiles8_y, supers, num_supers, blocks, ti, tf,
                       items, buf, plane, key_h, width, stream, depth);
}
