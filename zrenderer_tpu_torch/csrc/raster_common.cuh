// Shared pieces of the flat and G-buffer raster kernels (raster_small.cu,
// raster_hier.cu, raster_binned.cu, and the experiments raster_group8.cu,
// raster_vec.cu, raster_vis.cu and raster_twoclass.cu).
//
// Layout contract with zrenderer_tpu/ops/geometry.py: setup rows are
// (R, NI32) int32 + (R, NF32) float32, row-major; bbox tables are (n, 8)
// int32 [jmin, jmax, imin, imax, any_valid, 0, 0, 0].  Output planes are
// (H, W) row-major: packed RGBA8 as u32 bits in int32, and f32 depth; a
// G-buffer kernel writes GBUF_PLANES such planes back to back (color bits,
// depth, u, v, nx, ny, nz, metallic, roughness, emissive r/g/b, layer); a
// depth-only kernel (the shadow-map pass) writes the depth plane alone.
//
// A band kernel (K3b, K9, K9g, K9d) rasterizes the band_h rows from global
// row row_base: the pixel math uses global rows, and the stores write
// band-local rows (global row minus row_base).
//
// The register body (TileState, below): one CUDA block rasterizes one
// 32x128 screen tile.  Its 256 threads each own one column and 16 rows of
// the tile (rows r0, r0 + 2, ...), and keep the tile state for those
// pixels in registers across the whole triangle loop: depth and the
// winning row id, resolving every latch from the winner in the epilogue.
// Every triangle is evaluated by all threads of the block (the loops and
// their bbox skips are block-uniform), so the per-triangle setup reads are
// broadcast loads.
//
// Numerics (docs/RASTER_SPEC.md §2-§5), the bits the plain torch version
// produces:
// * edge functions wrap like the reference's int32 arithmetic; signed
//   overflow is undefined in C++, so they are computed in uint32_t;
// * every interpolation is ((e0*c0 + e1*c1) + e2*c2), rounded after each
//   op: __fmul_rn/__fadd_rn cannot be contracted into FMA (the build also
//   passes -fmad=false);
// * the resolve divides once per pixel with an IEEE-rounded 1/den.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace zr {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROW_STEP = THREADS / TILE_W;            // 2
constexpr int PIX = TILE_H * TILE_W / THREADS;         // 16 pixels a thread
constexpr int SUBPIXEL = 8;
constexpr int HALF = SUBPIXEL / 2;
constexpr int NI32 = 20;
constexpr int NF32 = 40;
constexpr int RASTER_BLOCK = 128;
constexpr int SUPER_BLOCK = 32;
constexpr int INT_MAX32 = 0x7fffffff;

// Integer setup columns (geometry.I_*).
enum : int {
  I_X0 = 0, I_Y0, I_X1, I_Y1, I_X2, I_Y2,
  I_DX0, I_DY0, I_DX1, I_DY1, I_DX2, I_DY2,
  I_BIAS0, I_BIAS1, I_BIAS2,
  I_JMIN, I_JMAX, I_IMIN, I_IMAX, I_VALID
};
// Float setup columns (geometry.F_*): three per interpolant, then the
// per-triangle constants F_MET..F_TEX.
enum : int {
  F_ZA0 = 0, F_RW0 = 3, F_CR0 = 6, F_CG0 = 9, F_CB0 = 12,
  F_U0 = 15, F_V0 = 18, F_NX0 = 21, F_NY0 = 24, F_NZ0 = 27, F_MET = 30
};
constexpr int GBUF_INTERP = 5;  // u, v, nx, ny, nz (from F_U0, 3 apart)
constexpr int GBUF_CONSTS = 6;  // metallic, roughness, emissive rgb, layer
constexpr int GBUF_PLANES = 2 + GBUF_INTERP + GBUF_CONSTS;

__device__ __forceinline__ int edge_fn(int dx, int dy, int x, int y,
                                       int px, int py) {
  // dx*(py - y) - dy*(px - x) with int32 wrap-around.
  uint32_t a = (uint32_t)dx * ((uint32_t)py - (uint32_t)y);
  uint32_t b = (uint32_t)dy * ((uint32_t)px - (uint32_t)x);
  return (int)(a - b);
}

__device__ __forceinline__ float interp3(float e0, float e1, float e2,
                                         float c0, float c1, float c2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(e0, c0), __fmul_rn(e1, c1)),
                   __fmul_rn(e2, c2));
}

__device__ __forceinline__ bool tile_overlap(int jmin, int jmax, int imin,
                                             int imax, int row0, int col0) {
  return jmax >= col0 && jmin < col0 + TILE_W && imax >= row0 &&
         imin < row0 + TILE_H && jmin <= jmax && imin <= imax;
}

__device__ __forceinline__ uint32_t quantize(float numer, bool covered,
                                             float inv) {
  float c = covered ? __fmul_rn(numer, inv) : 0.0f;
  c = fminf(fmaxf(c, 0.0f), 1.0f);
  return (uint32_t)(int)floorf(__fadd_rn(__fmul_rn(c, 255.0f), 0.5f));
}

// RGBA8 of the colour numerators (cr, cg, cb) times inv where covered,
// alpha 255.
__device__ __forceinline__ uint32_t pack_rgba(float cr, float cg, float cb,
                                              bool covered, float inv) {
  return quantize(cr, covered, inv) | (quantize(cg, covered, inv) << 8) |
         (quantize(cb, covered, inv) << 16) | 0xFF000000u;
}

// Exclusive prefix of v over the block's NWARPS warps of 32 threads;
// total gets the sum.  Every thread calls it.
template <int NWARPS = THREADS / 32>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const int c = warp_sums[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  __syncthreads();
  total = sum;
  return before + x - v;
}

// The winner resolve of one pixel, shared by TileState::store_gbuffer (the
// register bodies' epilogue) and the keyed bodies' stores (raster_keyed.cuh
// WinnerKeys, raster_twoclass.cu ScanKeys): row t of ti/tf (strides RI and RF; INT_MAX32 where no row
// won) re-evaluated at the pixel centre (px, py) in subpixels, its edge
// functions, 1/w and colour interpolated, one IEEE divide, RGBA8 packed
// into color[idx] and z into depth[idx]: the given z, or with EVAL_Z the
// winner's z re-evaluated (its -0.0 kept, or with pos_zero stored plus
// 0.0f, -0.0 as +0.0; z stays as given where none won).  With PLANES also uv and normal times 1/den and the row's
// constants into the GBUF_PLANES - 2 planes from extra, plane floats
// apart.  MASKED_INV picks the divide's form, which the reference's
// kernels differ in (sign of zero, NaN when a row passed with den <= 0):
// buf * (covered ? inv : 0) for K2g, K4g, K5g and K10g8g, covered ? buf *
// inv : 0 for K3g and K10vecg.
template <bool MASKED_INV, bool PLANES, bool EVAL_Z = false, int RI = NI32,
          int RF = NF32>
__device__ __forceinline__ void resolve_winner(
    const int* __restrict__ ti, const float* __restrict__ tf, int t, float z,
    int px, int py, int* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ extra, size_t idx, size_t plane,
    bool pos_zero = false) {
  float d = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  float g[GBUF_INTERP] = {}, c[GBUF_CONSTS] = {};
  if (t != INT_MAX32) {
    const int* r = ti + (size_t)t * RI;
    const float* f = tf + (size_t)t * RF;
    const float f0 = __int2float_rn(
        edge_fn(__ldg(r + I_DX0), __ldg(r + I_DY0), __ldg(r + I_X1),
                __ldg(r + I_Y1), px, py));
    const float f1 = __int2float_rn(
        edge_fn(__ldg(r + I_DX1), __ldg(r + I_DY1), __ldg(r + I_X2),
                __ldg(r + I_Y2), px, py));
    const float f2 = __int2float_rn(
        edge_fn(__ldg(r + I_DX2), __ldg(r + I_DY2), __ldg(r + I_X0),
                __ldg(r + I_Y0), px, py));
    if constexpr (EVAL_Z)
      z = interp3(f0, f1, f2, __ldg(f + F_ZA0), __ldg(f + F_ZA0 + 1),
                  __ldg(f + F_ZA0 + 2));
    d = interp3(f0, f1, f2, __ldg(f + F_RW0), __ldg(f + F_RW0 + 1),
                __ldg(f + F_RW0 + 2));
    cr = interp3(f0, f1, f2, __ldg(f + F_CR0), __ldg(f + F_CR0 + 1),
                 __ldg(f + F_CR0 + 2));
    cg = interp3(f0, f1, f2, __ldg(f + F_CG0), __ldg(f + F_CG0 + 1),
                 __ldg(f + F_CG0 + 2));
    cb = interp3(f0, f1, f2, __ldg(f + F_CB0), __ldg(f + F_CB0 + 1),
                 __ldg(f + F_CB0 + 2));
    if constexpr (PLANES) {
#pragma unroll
      for (int i = 0; i < GBUF_INTERP; ++i) {
        const float* fc = f + F_U0 + 3 * i;
        g[i] = interp3(f0, f1, f2, __ldg(fc), __ldg(fc + 1), __ldg(fc + 2));
      }
#pragma unroll
      for (int i = 0; i < GBUF_CONSTS; ++i) c[i] = __ldg(f + F_MET + i);
    }
  }
  const bool covered = d > 0.0f;
  const float inv = covered ? __fdiv_rn(1.0f, d) : 1.0f;
  color[idx] = (int)pack_rgba(cr, cg, cb, covered, inv);
  depth[idx] = pos_zero ? __fadd_rn(z, 0.0f) : z;
  if constexpr (PLANES) {
#pragma unroll
    for (int i = 0; i < GBUF_INTERP; ++i) {
      float v;
      if constexpr (MASKED_INV) {
        v = __fmul_rn(g[i], covered ? inv : 0.0f);
      } else {
        v = covered ? __fmul_rn(g[i], inv) : 0.0f;
      }
      extra[i * plane + idx] = v;
    }
#pragma unroll
    for (int i = 0; i < GBUF_CONSTS; ++i)
      extra[(GBUF_INTERP + i) * plane + idx] = c[i];
  }
}

// Per-thread tile state of the register body (K2g and K9g; the other
// kernels run the keyed body, raster_keyed.cuh, or K1's sub-tile blocks),
// under the order-free depth test (z, row id).
//
// K4g, K6g, K3g, K5g, K10g8g and K10vecg run the keyed body with the same
// resolve.  Latching 11 more planes the way the reference does would take
// 17 values a pixel, 272 registers a thread for 16 pixels: over the 255
// cap.  Every latched value is a pure function of (row, pixel), so the
// loops keep only z and the winning row id, and resolve re-evaluates the
// winner's edge functions and interpolants with the same interp3: the same
// bits, two values a pixel.
struct TileState {
  float z[PIX];
  int tid[PIX];  // the winning row id
  int px;   // this thread's pixel-centre x, in subpixels
  int py0;  // pixel-centre y of its first row, in subpixels
  int row0, col0;

  __device__ __forceinline__ void init(int tile_row0, int tile_col0) {
    row0 = tile_row0;
    col0 = tile_col0;
    px = (col0 + (int)(threadIdx.x % TILE_W)) * SUBPIXEL + HALF;
    py0 = (row0 + (int)(threadIdx.x / TILE_W)) * SUBPIXEL + HALF;
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      z[k] = 1.0f;
      tid[k] = INT_MAX32;
    }
  }

  // Pixel-centre y of this thread's pixel k, in subpixels.
  __device__ __forceinline__ int py(int k) const {
    return py0 + k * ROW_STEP * SUBPIXEL;
  }

  // The (z, row id) test of row t at covered pixel k with depth zz; on a
  // pass it keeps zz and t.
  __device__ __forceinline__ void depth_test(int k, float zz, int t) {
    if (zz >= 0.0f && (zz < z[k] || (zz == z[k] && t < tid[k]))) {
      z[k] = zz;
      tid[k] = t;
    }
  }

  // Coverage and depth test of setup row t at this thread's pixels.
  __device__ __forceinline__ void eval(const int* __restrict__ ti,
                                       const float* __restrict__ tf, int t) {
    eval_row(ti + (size_t)t * NI32, tf + (size_t)t * NF32, t);
  }

  // The same for one setup record (r: NI32 ints, f: NF32 floats) whose
  // tie-break id is t.
  __device__ __forceinline__ void eval_row(const int* __restrict__ r,
                                           const float* __restrict__ f,
                                           int t) {
    const int x0 = __ldg(r + I_X0), y0 = __ldg(r + I_Y0);
    const int x1 = __ldg(r + I_X1), y1 = __ldg(r + I_Y1);
    const int x2 = __ldg(r + I_X2), y2 = __ldg(r + I_Y2);
    const int dx0 = __ldg(r + I_DX0), dy0 = __ldg(r + I_DY0);
    const int dx1 = __ldg(r + I_DX1), dy1 = __ldg(r + I_DY1);
    const int dx2 = __ldg(r + I_DX2), dy2 = __ldg(r + I_DY2);
    const int b0 = __ldg(r + I_BIAS0);
    const int b1 = __ldg(r + I_BIAS1);
    const int b2 = __ldg(r + I_BIAS2);
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int e0 = edge_fn(dx0, dy0, x1, y1, px, py(k));
      const int e1 = edge_fn(dx1, dy1, x2, y2, px, py(k));
      const int e2 = edge_fn(dx2, dy2, x0, y0, px, py(k));
      if (e0 < b0 || e1 < b1 || e2 < b2) continue;
      const float zz = interp3(__int2float_rn(e0), __int2float_rn(e1),
                               __int2float_rn(e2), __ldg(f + F_ZA0),
                               __ldg(f + F_ZA0 + 1), __ldg(f + F_ZA0 + 2));
      depth_test(k, zz, t);
    }
  }

  // Superblock -> block -> row scan with block-uniform bbox skips, rows in
  // submission order (the reference's _scan_groups over the tables), over
  // superblocks [0, num_supers).
  __device__ __forceinline__ void scan_hierarchy(
      const int* __restrict__ supers, int num_supers,
      const int* __restrict__ blocks, const int* __restrict__ ti,
      const float* __restrict__ tf) {
    for (int s = 0; s < num_supers; ++s) {
      const int* sb = supers + (size_t)s * 8;
      if (!tile_overlap(__ldg(sb), __ldg(sb + 1), __ldg(sb + 2),
                        __ldg(sb + 3), row0, col0))
        continue;
      for (int b = s * SUPER_BLOCK; b < (s + 1) * SUPER_BLOCK; ++b) {
        const int* bb = blocks + (size_t)b * 8;
        if (!tile_overlap(__ldg(bb), __ldg(bb + 1), __ldg(bb + 2),
                          __ldg(bb + 3), row0, col0))
          continue;
        for (int t = b * RASTER_BLOCK; t < (b + 1) * RASTER_BLOCK; ++t) {
          const int* r = ti + (size_t)t * NI32;
          if (tile_overlap(__ldg(r + I_JMIN), __ldg(r + I_JMAX),
                           __ldg(r + I_IMIN), __ldg(r + I_IMAX), row0,
                           col0))
            eval(ti, tf, t);
        }
      }
    }
  }

  // The G-buffer resolve (ti/tf: the rows tid indexes) of this thread's
  // pixels through resolve_winner, z as the loops left it, into out's
  // GBUF_PLANES planes of plane floats each (color bits, depth, then the
  // rest).  The output's first row is global row row_base.
  template <bool MASKED_INV>
  __device__ __forceinline__ void store_gbuffer(
      const int* __restrict__ ti, const float* __restrict__ tf,
      float* __restrict__ out, int width, size_t plane,
      int row_base = 0) const {
    const int col = col0 + (int)(threadIdx.x % TILE_W);
    const int rbase = row0 - row_base + (int)(threadIdx.x / TILE_W);
#pragma unroll
    for (int k = 0; k < PIX; ++k)
      resolve_winner<MASKED_INV, true>(
          ti, tf, tid[k], z[k], px, py(k), reinterpret_cast<int*>(out),
          out + plane, out + 2 * plane,
          (size_t)(rbase + k * ROW_STEP) * width + col, plane);
  }
};

}  // namespace zr
