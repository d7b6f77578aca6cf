// K8 and K8b: the 2D overlay pass (stats line, imgui windows), the layered
// raster and its atlas composite.
//
// K8 replaces rasterize_overlay_pallas (zrenderer_tpu/ops/overlay_raster.py,
// its pallas_call and _overlay_kernel_body).  Inputs, from the host setup
// (ops/overlay.py setup_overlay_triangles):
//   ti (T, 20) int32: snapped corners, edge deltas, fill-rule biases, the
//      pixel rect (triangle bbox ∩ scissor ∩ viewport), valid;
//   tf (T, 24) f32: per-vertex u, v, r, g, b, a numerators (attr / area).
// Outputs, each (H, W): the count clamped to K, the overflow max(c - K, 0),
// and K layers of (u f32, v f32, RGBA8 col as u32 bits), oldest first;
// layers past a pixel's count stay 0.  Triangles go in submission order;
// a covered pixel takes slot c (its running count) while c < K, so draws
// beyond K are dropped newest first and only the count grows.
//
// One block owns a 32x8 pixel rectangle, one thread a pixel, whose count
// and K-deep stack (3K words) stay in registers for the whole list.  The
// list is staged through shared memory in chunks of 256 triangles, in
// order: each thread tests one triangle's pixel rect against the block's
// rectangle (the bbox ∩ scissor skip of the Pallas kernel, per block) and
// the hits are compacted with a warp ballot and a per-warp prefix, so the
// staged list keeps submission order; then every thread walks the staged
// triangles (block-uniform loop, broadcast shared loads).  Rows with valid
// == 0 are skipped, as the reference's XLA form does; the setup gives such
// rows an empty rect (jmin = 1 > jmax = 0), so the Pallas kernel, which
// reads only the rect, covers nothing with them either.
//
// K8b replaces the XLA composite of the same file (sample_atlas_bilinear,
// composite_layers): per pixel, for the layers k < count in order, the
// bilinear WRAP sample of the packed RGBA8 atlas at (u, v) (texels
// unpacked to f32 / 255 before the lerp), modulated by the layer's colour,
// blended src*a + dst*(1-a) in f32; then quantized with alpha 255.  A
// layer past the count blends with a = 0 in the reference, which leaves
// dst's bits unchanged, so K8b skips it, and a pixel with no live layer
// (about 95% of a --ui frame) is the frame's word with alpha 255, no
// divide, layer read or sample.  K8b takes four consecutive pixels a
// thread: the frame and the count as one 16-byte load each, the output as
// one 16-byte store, a scalar tail for num_pixels % 4.
//
// Numerics: the bits of the plain versions (ops/overlay.py).  Edge
// functions wrap like int32 (raster_common.cuh edge_fn); every
// interpolation is ((e0*c0) + (e1*c1)) + e2*c2 and every lerp and blend is
// rounded after each op with __fmul_rn/__fadd_rn/__fsub_rn in the
// reference's order (-fmad=false backs it up); the frame's u8 -> f32 is an
// IEEE divide by 255 (__fdiv_rn, a 256-entry table a block), texels and
// colours multiply by float32(1/255).
//
// What bounds them on the H100.  K8: bytes at 1080p, 26 planes of 4 bytes
// written (216 MB, 0.064 ms at 3.35 TB/s); the coverage tests of the
// (tile, triangle) pairs are far below that for a UI.  The simple design
// writes each plane once, coalesced along rows; each block reads every
// row's rect once per chunk (L2 traffic that grows as blocks x rows, the
// first thing to cut when the list is long).  K8b: bytes, the frame, the
// count and the live layers read once and the frame written once; the
// atlas (32 KB) stays in L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace zr {
namespace overlay {

constexpr int BW = 32;                // block rectangle: 32 columns
constexpr int BH = 8;                 // by 8 rows, one thread a pixel
constexpr int THREADS = BW * BH;      // 256 = one chunk of triangles
constexpr int WARPS = THREADS / 32;
constexpr int NI32_2D = 20;           // overlay.NI32_2D
constexpr int NF32_2D = 24;           // overlay.NF32_2D
constexpr int STAGED_I = I_IMAX + 1;  // columns I_X0 .. I_IMAX
constexpr int STAGED_F = 18;          // F2_U0 .. F2_A2
constexpr int F2_U0 = 0, F2_V0 = 3, F2_R0 = 6, F2_G0 = 9, F2_B0 = 12,
              F2_A0 = 15;
constexpr float INV255 = 0x1.010102p-8f;  // float32(1 / 255)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// floor(clip(c, 0, 1) * 255 + 0.5) as u32 (_quantize_channel).
__device__ __forceinline__ uint32_t quantize_channel(float c) {
  c = fminf(fmaxf(c, 0.0f), 1.0f);
  return (uint32_t)(int)floorf(add(mul(c, 255.0f), 0.5f));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    overlay_raster_kernel(const int* __restrict__ ti,
                          const float* __restrict__ tf, int num_tris,
                          int* __restrict__ cnt_out,
                          int* __restrict__ over_out,
                          float* __restrict__ lu_out,
                          float* __restrict__ lv_out,
                          uint32_t* __restrict__ lc_out, int width,
                          int height) {
  __shared__ int s_i[STAGED_I][THREADS];
  __shared__ float s_f[STAGED_F][THREADS];
  __shared__ int s_warp[WARPS];

  const int col0 = blockIdx.x * BW;
  const int row0 = blockIdx.y * BH;
  const int j = col0 + threadIdx.x % BW;
  const int i = row0 + threadIdx.x / BW;
  const int px = j * SUBPIXEL + HALF;
  const int py = i * SUBPIXEL + HALF;
  const int last_col = min(col0 + BW, width) - 1;
  const int last_row = min(row0 + BH, height) - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int c = 0;
  float lu[K], lv[K];
  uint32_t lc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lu[k] = 0.0f;
    lv[k] = 0.0f;
    lc[k] = 0u;
  }

  for (int base = 0; base < num_tris; base += THREADS) {
    // Stage the chunk's triangles whose rect meets this block, in order.
    const int t = base + threadIdx.x;
    const int* row = ti + (size_t)t * NI32_2D;
    bool hit = false;
    if (t < num_tris) {
      const int jmin = row[I_JMIN], jmax = row[I_JMAX];
      const int imin = row[I_IMIN], imax = row[I_IMAX];
      hit = row[I_VALID] > 0 && jmin <= jmax && imin <= imax &&
            jmax >= col0 && jmin <= last_col && imax >= row0 &&
            imin <= last_row;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int slot = 0, count = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int n = s_warp[w];
      slot += w < warp ? n : 0;
      count += n;
    }
    if (hit) {
      slot += __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
      for (int q = 0; q < STAGED_I; ++q) s_i[q][slot] = row[q];
      const float* frow = tf + (size_t)t * NF32_2D;
#pragma unroll
      for (int q = 0; q < STAGED_F; ++q) s_f[q][slot] = frow[q];
    }
    __syncthreads();

    for (int s = 0; s < count; ++s) {
      const int e0 = edge_fn(s_i[I_DX0][s], s_i[I_DY0][s], s_i[I_X1][s],
                             s_i[I_Y1][s], px, py);
      const int e1 = edge_fn(s_i[I_DX1][s], s_i[I_DY1][s], s_i[I_X2][s],
                             s_i[I_Y2][s], px, py);
      const int e2 = edge_fn(s_i[I_DX2][s], s_i[I_DY2][s], s_i[I_X0][s],
                             s_i[I_Y0][s], px, py);
      const bool inside = e0 >= s_i[I_BIAS0][s] && e1 >= s_i[I_BIAS1][s] &&
                          e2 >= s_i[I_BIAS2][s] && j >= s_i[I_JMIN][s] &&
                          j <= s_i[I_JMAX][s] && i >= s_i[I_IMIN][s] &&
                          i <= s_i[I_IMAX][s];
      if (!inside) continue;
      if (c < K) {
        const float ef0 = (float)e0, ef1 = (float)e1, ef2 = (float)e2;
        const float u = interp3(ef0, ef1, ef2, s_f[F2_U0][s],
                                s_f[F2_U0 + 1][s], s_f[F2_U0 + 2][s]);
        const float v = interp3(ef0, ef1, ef2, s_f[F2_V0][s],
                                s_f[F2_V0 + 1][s], s_f[F2_V0 + 2][s]);
        const uint32_t col =
            quantize_channel(interp3(ef0, ef1, ef2, s_f[F2_R0][s],
                                     s_f[F2_R0 + 1][s], s_f[F2_R0 + 2][s])) |
            (quantize_channel(interp3(ef0, ef1, ef2, s_f[F2_G0][s],
                                      s_f[F2_G0 + 1][s], s_f[F2_G0 + 2][s]))
             << 8) |
            (quantize_channel(interp3(ef0, ef1, ef2, s_f[F2_B0][s],
                                      s_f[F2_B0 + 1][s], s_f[F2_B0 + 2][s]))
             << 16) |
            (quantize_channel(interp3(ef0, ef1, ef2, s_f[F2_A0][s],
                                      s_f[F2_A0 + 1][s], s_f[F2_A0 + 2][s]))
             << 24);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (c == k) {
            lu[k] = u;
            lv[k] = v;
            lc[k] = col;
          }
        }
      }
      ++c;
    }
    __syncthreads();  // the next chunk rewrites s_warp and the staging
  }

  if (j >= width || i >= height) return;
  const size_t plane = (size_t)width * height;
  const size_t idx = (size_t)i * width + j;
  cnt_out[idx] = c < K ? c : K;
  over_out[idx] = c > K ? c - K : 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lu_out[k * plane + idx] = lu[k];
    lv_out[k * plane + idx] = lv[k];
    lc_out[k * plane + idx] = lc[k];
  }
}

__device__ __forceinline__ int wrap(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float channel(uint32_t texel, int ch) {
  return mul((float)((texel >> (8 * ch)) & 0xFFu), INV255);
}

// K8b's block: 256 threads, one pixel quad each.  Timed on the H100 at
// 1080p (PERF.md): a grid-stride loop over 2-8 blocks an SM and blocks
// of 128 threads came within the runs' spread of this form.
constexpr int COMPOSITE_THREADS = 256;

// One pixel of K8b: frame word f (RGBA8, R in the low byte) under its
// live layers.  A pixel with no live layer is the frame with alpha 255:
// floor(clip(f32(x) / 255, 0, 1) * 255 + 0.5) == x for every byte x
// (tests/test_torch_overlay.py test_count_zero_round_trip_is_exact), so
// it needs no divide, no layer and no sample.  Otherwise dst starts from
// the table inv[x] = __fdiv_rn(x, 255) (the plain version's frame / 255).
__device__ __forceinline__ uint32_t composite_pixel(
    uint32_t f, int count, int idx, const float* __restrict__ inv,
    const float* __restrict__ lu, const float* __restrict__ lv,
    const uint32_t* __restrict__ lc, int K,
    const uint32_t* __restrict__ atlas, int atlas_h, int atlas_w,
    int num_pixels) {
  const int live = min(count, K);
  if (live <= 0) return f | 0xFF000000u;
  float dst[3] = {inv[f & 0xFFu], inv[(f >> 8) & 0xFFu],
                  inv[(f >> 16) & 0xFFu]};
  const float aw = (float)atlas_w, ah = (float)atlas_h;
  for (int k = 0; k < live; ++k) {
    const size_t at = (size_t)k * num_pixels + idx;
    // sample_atlas_bilinear: WRAP addressing, texels / 255 before the lerp.
    const float x = sub(mul(__ldg(lu + at), aw), 0.5f);
    const float y = sub(mul(__ldg(lv + at), ah), 0.5f);
    const int x0 = (int)floorf(x);
    const int y0 = (int)floorf(y);
    const float fx = sub(x, (float)x0);
    const float fy = sub(y, (float)y0);
    const float omfx = sub(1.0f, fx), omfy = sub(1.0f, fy);
    const int ix0 = wrap(x0, atlas_w), ix1 = wrap(x0 + 1, atlas_w);
    const int iy0 = wrap(y0, atlas_h), iy1 = wrap(y0 + 1, atlas_h);
    const uint32_t t00 = __ldg(atlas + iy0 * atlas_w + ix0);
    const uint32_t t10 = __ldg(atlas + iy0 * atlas_w + ix1);
    const uint32_t t01 = __ldg(atlas + iy1 * atlas_w + ix0);
    const uint32_t t11 = __ldg(atlas + iy1 * atlas_w + ix1);
    float tex[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      const float top = add(mul(channel(t00, ch), omfx),
                            mul(channel(t10, ch), fx));
      const float bot = add(mul(channel(t01, ch), omfx),
                            mul(channel(t11, ch), fx));
      tex[ch] = add(mul(top, omfy), mul(bot, fy));
    }
    // composite_layers: modulate, then src*a + dst*(1-a).
    const uint32_t col = __ldg(lc + at);
    const float a = mul(channel(col, 3), tex[3]);
    const float oma = sub(1.0f, a);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float src = mul(channel(col, ch), tex[ch]);
      dst[ch] = add(mul(src, a), mul(dst[ch], oma));
    }
  }
  return quantize_channel(dst[0]) | (quantize_channel(dst[1]) << 8) |
         (quantize_channel(dst[2]) << 16) | 0xFF000000u;
}

// K8b: four consecutive pixels a thread (pixel quad q: the frame and the
// count read as 16 bytes each, the output written as 16); the thread of
// the quad past the last full one writes the num_pixels % 4 tail, pixel
// by pixel.  frame, cnt and out are 16-byte aligned (the wrapper checks).
__global__ void __launch_bounds__(COMPOSITE_THREADS)
    overlay_composite_kernel(const uint32_t* __restrict__ frame,
                             const int* __restrict__ cnt,
                             const float* __restrict__ lu,
                             const float* __restrict__ lv,
                             const uint32_t* __restrict__ lc, int K,
                             const uint32_t* __restrict__ atlas,
                             int atlas_h, int atlas_w,
                             uint32_t* __restrict__ out, int num_pixels) {
  __shared__ float inv[256];
  for (int i = threadIdx.x; i < 256; i += COMPOSITE_THREADS)
    inv[i] = __fdiv_rn((float)i, 255.0f);
  __syncthreads();
  const int quads = num_pixels / 4;
  const int q = blockIdx.x * COMPOSITE_THREADS + threadIdx.x;
  if (q < quads) {
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(frame) + q);
    const int4 c = __ldg(reinterpret_cast<const int4*>(cnt) + q);
    const int p = 4 * q;
    uint4 o;
    o.x = composite_pixel(f.x, c.x, p, inv, lu, lv, lc, K, atlas, atlas_h,
                          atlas_w, num_pixels);
    o.y = composite_pixel(f.y, c.y, p + 1, inv, lu, lv, lc, K, atlas,
                          atlas_h, atlas_w, num_pixels);
    o.z = composite_pixel(f.z, c.z, p + 2, inv, lu, lv, lc, K, atlas,
                          atlas_h, atlas_w, num_pixels);
    o.w = composite_pixel(f.w, c.w, p + 3, inv, lu, lv, lc, K, atlas,
                          atlas_h, atlas_w, num_pixels);
    reinterpret_cast<uint4*>(out)[q] = o;
  } else if (q == quads) {
    for (int p = 4 * quads; p < num_pixels; ++p)
      out[p] = composite_pixel(__ldg(frame + p), __ldg(cnt + p), p, inv, lu,
                               lv, lc, K, atlas, atlas_h, atlas_w,
                               num_pixels);
  }
}

}  // namespace overlay
}  // namespace zr

// K8 on the current stream; k is the layer depth (2 or 8).
extern "C" int zr_overlay_raster(const int* ti, const float* tf,
                                 int num_tris, int k, int* cnt, int* over,
                                 float* lu, float* lv, uint32_t* lc,
                                 int height, int width, void* stream) {
  using namespace zr::overlay;
  if (num_tris < 0 || height <= 0 || width <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((width + BW - 1) / BW, (height + BH - 1) / BH);
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 2:
      overlay_raster_kernel<2><<<grid, THREADS, 0, s>>>(
          ti, tf, num_tris, cnt, over, lu, lv, lc, width, height);
      break;
    case 8:
      overlay_raster_kernel<8><<<grid, THREADS, 0, s>>>(
          ti, tf, num_tris, cnt, over, lu, lv, lc, width, height);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8b on the current stream: frame and out (H, W, 4) u8, the count and K
// layers of (H, W) planes, the packed atlas (atlas_h, atlas_w).
extern "C" int zr_overlay_composite(const void* frame, const int* cnt,
                                    const float* lu, const float* lv,
                                    const uint32_t* lc, int k,
                                    const uint32_t* atlas, int atlas_h,
                                    int atlas_w, void* out, int height,
                                    int width, void* stream) {
  using namespace zr::overlay;
  if (height <= 0 || width <= 0 || k < 1 || atlas_h <= 0 || atlas_w <= 0)
    return (int)cudaErrorInvalidValue;
  const int n = height * width;
  const int quads = n / 4 + 1;  // the full quads and the tail's thread
  overlay_composite_kernel<<<(quads + COMPOSITE_THREADS - 1) /
                                 COMPOSITE_THREADS,
                             COMPOSITE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)frame, cnt, lu, lv, lc, k, atlas, atlas_h, atlas_w,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
