// K7: tiled deferred lighting, Cook-Torrance GGX over L point lights with
// per-tile light culling (BASELINE config 3).
//
// Replaces tiled_deferred_lighting (zrenderer_tpu/ops/light_kernel.py: the
// _tiled_light_kernel body and its XLA prepass of per-tile light lists).
// Inputs, from tiled_deferred_lighting in zrenderer_tpu_torch/ops/
// light_kernel.py:
//   planes  (11, H, W) f32 or bf16: albedo r/g/b, normal x/y/z, world
//           x/y/z, metallic, roughness;
//   mask    (H, W) int32 coverage;
//   bounds  (L, 4) int32 light screen boxes (jmin, jmax, imin, imax);
//   lights  (L, 6) f32 (x, y, z, r, g, b);
//   consts  (4,) f32 camera x, y, z and ambient.
// Output (3, H, W) f32: where(mask > 0, acc, 0) per channel.
//
// The lights are listed per 32x128 tile, and a tile's covered pixels are
// cut into work items of at most ITEM_PIXELS (light_kernel.ITEM_PIXELS),
// one block of 256 threads each.  The grid is an upper bound, tiles x
// ceil(4096 / ITEM_PIXELS) blocks, so the host never waits for a count:
// every block of a tile compacts the tile's covered pixels in row-major
// order (a warp ballot over 32 columns and a per-warp prefix, as the
// light list) and keeps the indices of its own share in shared memory; a
// block past the tile's covered count exits there, and the tile's first
// block writes 0 to its uncovered pixels in that pass (the reference's
// where(mask, acc, 0) gives the same bits).  A block then builds its
// tile's light list in shared memory: each pass tests 256 lights' boxes
// against the tile (its first row is tile_i * 32 + row_offset, global rows
// for a band) and compacts the hits the same way, so the list keeps
// light-id order; each listed light is staged as one float4 (x, y, z, r)
// and one float2 (g, b), two vector loads in the loop.  No (tiles, L) list
// leaves the block.  Then the threads take the item's pixels in turn, the
// 32 lanes of a warp 32 covered pixels, each computing the per-pixel
// prologue and looping the list.  More than MAX_LIGHTS lights are taken in
// chunks of MAX_LIGHTS ids, one list each, in id order: a pixel's sums are
// stored to `out` after a chunk and reloaded for the next by the same
// thread (the prologue is recomputed), so the order of the adds, and the
// bits, do not depend on the chunking or on the items.
//
// Numerics: the bits of the plain version, tiled_light_plain.  Every
// product, sum and difference is pinned with __fmul_rn/__fadd_rn/
// __fsub_rn in the reference's association (the build also passes
// -fmad=false); rsqrt(x) is __fdiv_rn(1, __fsqrt_rn(x)); the reference's
// pl.reciprocal(denom, approx=True) is 1 / bf16_rn(denom) with
// __float2bfloat16_rn, its interpret-mode form; jnp.maximum(x, c) is
// x < c ? c : x, so a NaN stays NaN.
//
// What bounds it on the H100: operations, the arithmetic instructions of
// each (pixel, listed light) evaluation (chip_smoke.py's OPS_PER_LIGHT,
// counted in the built library's SASS), three IEEE divides, two square
// roots and a bf16 round trip among them, the divides and roots each a
// multi-instruction sequence; at 1920x1088 with all 256 lights listed in every tile that is
// up to 535 M evaluations, against 100 MB of device memory in (f32 planes
// and the mask) and 25 MB out.  A block a tile would be one wave of 510
// blocks whose time the SMs with the most covered tiles set, and a warp
// of one tile row would run the light loop for its uncovered lanes too;
// items of equal size balance the SMs, and compacted pixels keep every
// lane of a warp busy.  The pixel's prologue (22 values) stays in
// registers across the light loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zr {
namespace light {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int TILE_PIX = TILE_H * TILE_W;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LIGHTS = 1024;  // a chunk (light_kernel.MAX_LIGHTS)
// Covered pixels of a work item (light_kernel.ITEM_PIXELS): on the H100 at
// 1080p, 512 was best for the wide and r2 lights together.
constexpr int ITEM_PIXELS = 512;
constexpr int ITEMS_PER_TILE = (TILE_PIX + ITEM_PIXELS - 1) / ITEM_PIXELS;
static_assert(ITEM_PIXELS >= 1 && ITEM_PIXELS <= TILE_PIX,
              "a work item holds 1..TILE_PIX pixels");

// float32 of the reference's constants (hex, so no decimal rounding).
constexpr float PI_F = 0x1.921fb6p+1f;       // jnp.pi
constexpr float INV_PI_F = 0x1.45f306p-2f;   // float32(1 / jnp.pi)
constexpr float F0_DIELECTRIC = 0x1.47ae14p-5f;  // 0.04
constexpr float EPS_LEN = 0x1.197998p-40f;   // 1e-12
constexpr float EPS_NV = 0x1.a36e2ep-14f;    // 1e-4
constexpr float EPS_D = 0x1.5798eep-27f;     // 1e-8

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float vmax(float x, float c) { return x < c ? c : x; }
__device__ __forceinline__ float vmin(float x, float c) { return x > c ? c : x; }
__device__ __forceinline__ float rsqrt_rn(float x) {
  return __fdiv_rn(1.0f, __fsqrt_rn(x));
}
// (a*b + c*d) + e*f, rounded after each op.
__device__ __forceinline__ float dot3(float a, float b, float c, float d,
                                      float e, float f) {
  return add(add(mul(a, b), mul(c, d)), mul(e, f));
}

__device__ __forceinline__ float load(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Exclusive prefix of this thread's flag over the block's threads in
// thread order (a ballot a warp, then the warps' counts); total gets the
// count.  Every thread calls it; it ends with the block synchronised.
__device__ __forceinline__ int block_rank(bool flag, int* warp_counts,
                                          int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int n = warp_counts[w];
    before += w < warp ? n : 0;
    total += n;
  }
  __syncthreads();  // warp_counts is rewritten by the next call
  return before + __popc(ballot & ((1u << lane) - 1u));
}

// CHUNKED: more than MAX_LIGHTS lights, taken in chunks.  The one-chunk
// instantiation keeps the sums in registers from the ambient term on, with
// no read of `out`.
template <class T, bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
    light_tiled_kernel(const T* __restrict__ planes,
                       const int* __restrict__ mask,
                       const int* __restrict__ bounds,
                       const float* __restrict__ lights, int num_lights,
                       const float* __restrict__ consts, int row_offset,
                       float* __restrict__ out, int width, int height) {
  __shared__ float4 s_pos[MAX_LIGHTS];  // x, y, z and red of each light
  __shared__ float2 s_gb[MAX_LIGHTS];   // its green and blue
  __shared__ unsigned short s_pix[ITEM_PIXELS];  // the item's tile pixels
  __shared__ int s_warp[WARPS];

  const int tile = blockIdx.x / ITEMS_PER_TILE;
  const int item = blockIdx.x % ITEMS_PER_TILE;
  const int tiles_x = width / TILE_W;
  const int tile_i = tile / tiles_x;
  const int row0 = tile_i * TILE_H + row_offset;  // global first row
  const int col0 = (tile % tiles_x) * TILE_W;
  const size_t plane = (size_t)width * height;

  // The tile's covered pixels in row-major order; this item's are ranks
  // [first, first + ITEM_PIXELS).  The first item zeroes the uncovered.
  const int first = item * ITEM_PIXELS;
  int covered = 0;
  for (int base = 0; base < TILE_PIX; base += THREADS) {
    const int p = base + threadIdx.x;
    const size_t idx =
        (size_t)(tile_i * TILE_H + p / TILE_W) * width + col0 + p % TILE_W;
    const bool cov = mask[idx] > 0;
    if (!cov && item == 0) {
      out[idx] = 0.0f;
      out[plane + idx] = 0.0f;
      out[2 * plane + idx] = 0.0f;
    }
    int total;
    const int rank = covered + block_rank(cov, s_warp, total);
    if (cov && rank >= first && rank - first < ITEM_PIXELS)
      s_pix[rank - first] = (unsigned short)p;
    covered += total;
  }
  const int n = min(covered - first, ITEM_PIXELS);  // block-uniform
  if (n <= 0) return;

  const float cam_x = consts[0], cam_y = consts[1], cam_z = consts[2];
  const float ambient = consts[3];

  // The lights go through shared memory in chunks of MAX_LIGHTS, in id
  // order; between chunks each pixel's sums wait in `out` (an exact f32
  // round trip), so every pixel adds its tile's lights in id order
  // whatever the chunking.
  const int num_chunks =
      CHUNKED ? (num_lights + MAX_LIGHTS - 1) / MAX_LIGHTS : 1;
  for (int chunk = 0; chunk < num_chunks; ++chunk) {
    const int l_first = chunk * MAX_LIGHTS;
    const int l_last = min(l_first + MAX_LIGHTS, num_lights);

    // The chunk's list in id order.
    int count = 0;
    for (int base = l_first; base < l_last; base += THREADS) {
      const int l = base + threadIdx.x;
      bool hit = false;
      if (l < l_last) {
        const int* b = bounds + 4 * l;
        hit = b[1] >= col0 && b[0] < col0 + TILE_W && b[3] >= row0 &&
              b[2] < row0 + TILE_H;
      }
      int total;
      const int slot = count + block_rank(hit, s_warp, total);
      if (hit) {
        const float* src = lights + 6 * l;
        s_pos[slot] = make_float4(src[0], src[1], src[2], src[3]);
        s_gb[slot] = make_float2(src[4], src[5]);
      }
      count += total;
    }
    __syncthreads();  // the staged lights

    for (int j = threadIdx.x; j < n; j += THREADS) {
      const int p = s_pix[j];
      const size_t idx = (size_t)(tile_i * TILE_H + p / TILE_W) * width +
                         col0 + p % TILE_W;
      const float ar = load(planes, idx);
      const float ag = load(planes, plane + idx);
      const float ab = load(planes, 2 * plane + idx);
      float nx = load(planes, 3 * plane + idx);
      float ny = load(planes, 4 * plane + idx);
      float nz = load(planes, 5 * plane + idx);
      const float wx = load(planes, 6 * plane + idx);
      const float wy = load(planes, 7 * plane + idx);
      const float wz = load(planes, 8 * plane + idx);
      const float mv = load(planes, 9 * plane + idx);
      const float rv = load(planes, 10 * plane + idx);

      // Per-pixel prologue (_tiled_light_kernel :106-150), recomputed for
      // each chunk: the same bits every time.
      const float inv_nlen =
          rsqrt_rn(vmax(dot3(nx, nx, ny, ny, nz, nz), EPS_LEN));
      nx = mul(nx, inv_nlen);
      ny = mul(ny, inv_nlen);
      nz = mul(nz, inv_nlen);
      float vx = sub(cam_x, wx), vy = sub(cam_y, wy), vz = sub(cam_z, wz);
      const float inv_vlen =
          rsqrt_rn(vmax(dot3(vx, vx, vy, vy, vz, vz), EPS_LEN));
      vx = mul(vx, inv_vlen);
      vy = mul(vy, inv_vlen);
      vz = mul(vz, inv_vlen);
      const float nv_raw = dot3(nx, vx, ny, vy, nz, vz);
      const float ndotv = vmax(nv_raw, EPS_NV);

      const float one_minus_m = sub(1.0f, mv);
      const float f0r = add(mul(F0_DIELECTRIC, one_minus_m), mul(ar, mv));
      const float f0g = add(mul(F0_DIELECTRIC, one_minus_m), mul(ag, mv));
      const float f0b = add(mul(F0_DIELECTRIC, one_minus_m), mul(ab, mv));
      const float omf0r = sub(1.0f, f0r);
      const float omf0g = sub(1.0f, f0g);
      const float omf0b = sub(1.0f, f0b);
      const float a = mul(rv, rv);
      const float a2 = mul(a, a);
      const float kk = mul(mul(add(rv, 1.0f), add(rv, 1.0f)), 0.125f);
      const float one_minus_k = sub(1.0f, kk);
      const float gv = div(ndotv, add(mul(ndotv, one_minus_k), kk));
      const float cs = div(mul(mul(a2, gv), 0.25f), ndotv);
      const float a2m1 = sub(a2, 1.0f);
      const float dbr = mul(mul(one_minus_m, ar), INV_PI_F);
      const float dbg = mul(mul(one_minus_m, ag), INV_PI_F);
      const float dbb = mul(mul(one_minus_m, ab), INV_PI_F);
      float acc_r, acc_g, acc_b;
      if (!CHUNKED || chunk == 0) {
        acc_r = mul(ar, ambient);
        acc_g = mul(ag, ambient);
        acc_b = mul(ab, ambient);
      } else {
        acc_r = out[idx];
        acc_g = out[plane + idx];
        acc_b = out[2 * plane + idx];
      }

      // The chunk's listed lights in id order (_tiled_light_kernel
      // :161-201).
      for (int s = 0; s < count; ++s) {
        const float4 lp = s_pos[s];
        const float2 lc = s_gb[s];
        const float dx = sub(lp.x, wx);
        const float dy = sub(lp.y, wy);
        const float dz = sub(lp.z, wz);
        const float inv_d =
            rsqrt_rn(vmax(dot3(dx, dx, dy, dy, dz, dz), EPS_LEN));
        const float lxn = mul(dx, inv_d), lyn = mul(dy, inv_d);
        const float lzn = mul(dz, inv_d);
        const float nl_raw = dot3(nx, lxn, ny, lyn, nz, lzn);
        const float ndotl = vmax(nl_raw, 0.0f);
        const float ldotv = dot3(lxn, vx, lyn, vy, lzn, vz);
        const float inv_h =
            rsqrt_rn(vmax(add(2.0f, mul(2.0f, ldotv)), EPS_LEN));
        const float ndoth = vmax(mul(add(nl_raw, nv_raw), inv_h), 0.0f);
        const float vdoth = vmax(mul(add(1.0f, ldotv), inv_h), 0.0f);
        const float dterm = add(mul(mul(ndoth, ndoth), a2m1), 1.0f);
        const float denom = mul(vmax(mul(mul(PI_F, dterm), dterm), EPS_D),
                                add(mul(ndotl, one_minus_k), kk));
        const float recip =
            div(1.0f, __bfloat162float(__float2bfloat16_rn(denom)));
        const float spec = mul(cs, recip);
        const float t = vmin(vmax(sub(1.0f, vdoth), 0.0f), 1.0f);
        const float t2 = mul(t, t);
        const float t5 = mul(mul(t2, t2), t);
        const float rad = mul(ndotl, mul(inv_d, inv_d));
        const float fr = add(f0r, mul(omf0r, t5));
        const float fg = add(f0g, mul(omf0g, t5));
        const float fb = add(f0b, mul(omf0b, t5));
        acc_r = add(acc_r,
                    mul(add(dbr, mul(fr, sub(spec, dbr))), mul(lp.w, rad)));
        acc_g = add(acc_g,
                    mul(add(dbg, mul(fg, sub(spec, dbg))), mul(lc.x, rad)));
        acc_b = add(acc_b,
                    mul(add(dbb, mul(fb, sub(spec, dbb))), mul(lc.y, rad)));
      }
      out[idx] = acc_r;
      out[plane + idx] = acc_g;
      out[2 * plane + idx] = acc_b;
    }
    __syncthreads();  // the next chunk rewrites the staged lights
  }
}

}  // namespace light
}  // namespace zr

// K7 on the current stream.  bf16 != 0: the planes are bfloat16.
extern "C" int zr_light_tiled(const void* planes, int bf16, const int* mask,
                              const int* bounds, const float* lights,
                              int num_lights, const float* consts,
                              int row_offset, float* out, int height,
                              int width, void* stream) {
  using namespace zr::light;
  if (num_lights < 0 || height % TILE_H || width % TILE_W)
    return (int)cudaErrorInvalidValue;
  const int num_tiles = (height / TILE_H) * (width / TILE_W);
  if (num_tiles == 0) return (int)cudaSuccess;
  const int blocks = num_tiles * ITEMS_PER_TILE;
  cudaStream_t s = (cudaStream_t)stream;
  const bool chunked = num_lights > MAX_LIGHTS;
  if (bf16) {
    auto kernel = chunked ? light_tiled_kernel<__nv_bfloat16, true>
                          : light_tiled_kernel<__nv_bfloat16, false>;
    kernel<<<blocks, THREADS, 0, s>>>(
        (const __nv_bfloat16*)planes, mask, bounds, lights, num_lights,
        consts, row_offset, out, width, height);
  } else {
    auto kernel = chunked ? light_tiled_kernel<float, true>
                          : light_tiled_kernel<float, false>;
    kernel<<<blocks, THREADS, 0, s>>>(
        (const float*)planes, mask, bounds, lights, num_lights, consts,
        row_offset, out, width, height);
  }
  return (int)cudaGetLastError();
}
