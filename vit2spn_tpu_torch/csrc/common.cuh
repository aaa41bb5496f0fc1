// Building blocks shared by the port's Hopper kernels (sm_90a): warp
// reductions, the gelu forms, LayerNorm forward and backward, mma.sync on
// staged attention tiles, the mma.sync GEMM with its fused epilogues, and the
// fixed-order reduction of per-block partial sums. Each csrc/<name>.cu
// includes this header and compiles into its own shared library with a plain
// C interface.
//
// Numerics follow vit2spn_tpu/ops/fused_block.py: bf16 GEMM operands with
// fp32 accumulation, fp32 LayerNorm statistics, the A&S erf and the fast cdf
// rational for gelu, and their derivatives. The LayerNorms, the epilogues and
// the split reductions are templated on the element type T (bf16, or float
// for compute_dtype=float32, where every rounding point to T is the
// identity); the GEMM is mma.sync for bf16 and a CUDA-core (SIMT) kernel
// for fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)

// return a failing launch's code at once, naming it on stderr
#define LAUNCH(call)                                                          \
  do {                                                                        \
    int e_ = (call);                                                          \
    if (e_ != 0) {                                                            \
      fprintf(stderr, "vit2spn: %s:%d: %s failed (%d)\n", __FILE__, __LINE__, \
              #call, e_);                                                     \
      return e_;                                                              \
    }                                                                         \
  } while (0)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// gelu and its derivative, both forms
// ---------------------------------------------------------------------------

// Abramowitz-Stegun 7.1.26 rational erf (|err| < 1.5e-7), as _erf_exact.
__device__ __forceinline__ float erf_exact(float x) {
  float sign = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  float ax = fabsf(x);
  float t = 1.0f / (1.0f + 0.3275911f * ax);
  float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
               t * (-1.453152027f + t * 1.061405429f))));
  return sign * (1.0f - poly * expf(-ax * ax));
}

// Direct cdf rational, as _gelu_fast: only Phi's argument is clamped.
__device__ __forceinline__ float gelu_fast(float m) {
  float xc = fminf(fmaxf(m, -4.6f), 4.6f);
  float s = xc * xc;
  float p = 3.303320889057693e-05f;
  p = 0.003819241585880179f + s * p;
  p = 0.027416247095983802f + s * p;
  p = 0.3989386549977406f + s * p;
  float q = 0.0011597711855913715f;
  q = 0.023787000484733943f + s * q;
  q = 0.23538129451100157f + s * q;
  q = 1.0f + s * q;
  return m * (0.5f + xc * (p / q));
}

__device__ __forceinline__ float gelu(float m, int fast) {
  if (fast) return gelu_fast(m);
  return 0.5f * m * (1.0f + erf_exact(m * 0.7071067811865476f));
}

// gelu'(x) = Phi(x) + x phi(x), as _gelu_grad_exact; or the odd rational
// 0.5 + x P4(x^2) / Q3(x^2) clamped at |x| <= 4.6, as _gelu_grad_fast.
__device__ __forceinline__ float gelu_grad(float m, int fast) {
  if (fast) {
    float xc = fminf(fmaxf(m, -4.6f), 4.6f);
    float s = xc * xc;
    float p = 1.8219220945499694e-06f;
    p = -1.2033074181130153e-05f + s * p;
    p = 0.013759530274157408f + s * p;
    p = -0.03544238930343691f + s * p;
    p = 0.7981352003862573f + s * p;
    float q = 0.003771008302941207f;
    q = 0.036972201734621915f + s * q;
    q = 0.2904124253896315f + s * q;
    q = 1.0f + s * q;
    return 0.5f + xc * p / q;
  }
  const float phi = expf(-0.5f * m * m) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.0f + erf_exact(m * 0.7071067811865476f));
  return cdf + m * phi;
}

// ---------------------------------------------------------------------------
// PTX wrappers: cp.async, ldmatrix, mma.sync m16n8k16
// ---------------------------------------------------------------------------

#define GEMM_STAGES 3

// 16-byte asynchronous copy global -> shared; `pred` false fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
// 4-byte asynchronous copy global -> shared; `pred` false fills zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
// 8-byte asynchronous copy global -> shared; `pred` false fills zeros.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_stages() {  // all but the newest
  asm volatile("cp.async.wait_group %0;\n" ::"n"(GEMM_STAGES - 2));
}
__device__ __forceinline__ void cp_async_wait_all() {  // every copy this thread issued
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16 x 8, fp32) += a (16 x 16, row-major) b (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8 x 8 bf16 matrix held one pair per lane (lane 4g + t:
// row g, columns 2t and 2t + 1), in the same layout
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two neighbouring elements of T as floats, and back (rounded to T)
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
// a value rounded to T, as the Pallas body's astype(dtype): bf16, or none
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) return bf16_round(v);
  return v;
}

// ---------------------------------------------------------------------------
// mma.sync on attention tiles: rows of DH bf16 (DH = head_dim: 16, 32, 48,
// 64 or 80) staged in shared memory tile_ld<DH>() = DH + 8 elements apart
// (conflict-free ldmatrix at every DH: the rows of an 8 x 8 matrix start
// DH / 2 + 4 words apart), fp32 C tiles of 16 x 8 (lane 4g + t holds rows g
// and g + 8, columns 2t and 2t + 1). The A operand of a 16-row tile is DH /
// 16 fragments (k-steps of 16), an accumulator of 16 x DH is DH / 8 C tiles.
// ---------------------------------------------------------------------------

#define TILE_DH 64
#define TILE_LD (TILE_DH + 8)

template <int DH>
__host__ __device__ constexpr int tile_ld() {
  return DH + 8;
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t r[2], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// c (16 x 8) = A (16 x DH, fragments a[DH / 16][4]) times the 8 staged rows
// at `rows` (DH columns each), transposed: each row is one column of the
// result. The k-steps in ascending order (DH = 48: three of them).
template <int DH = TILE_DH>
__device__ __forceinline__ void mma_rows_t(float c[4], const uint32_t a[][4], const bf16* rows,
                                           int lane) {
  constexpr int LD = tile_ld<DH>(), KS = DH / 16;
  uint32_t kb[KS][2];
  const bf16* p = rows + (size_t)(lane & 7) * LD + (lane >> 3) * 8;
#pragma unroll
  for (int ks = 0; ks + 1 < KS; ks += 2) {  // two k-steps a load
    uint32_t r[4];
    ldmatrix_x4(r, p + ks * 16);
    kb[ks][0] = r[0];
    kb[ks][1] = r[1];
    kb[ks + 1][0] = r[2];
    kb[ks + 1][1] = r[3];
  }
  if constexpr (KS & 1)
    ldmatrix_x2(kb[KS - 1], rows + (size_t)(lane & 7) * LD + (KS - 1) * 16 + ((lane >> 3) & 1) * 8);
  c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) mma_bf16(c, a[ks], kb[ks][0], kb[ks][1]);
}

// the 16 staged rows at `rows` (DH columns) as A operand fragments
template <int DH = TILE_DH>
__device__ __forceinline__ void load_a_rows(uint32_t a[][4], const bf16* rows, int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(a[ks], rows + (size_t)(lane & 15) * tile_ld<DH>() + ks * 16 + (lane >> 4) * 8);
}

// acc (16 x DH) += a (16 x 16) times the 16 staged rows at `rows` (DH
// columns), read as the B operand [row][column]
template <int DH = TILE_DH>
__device__ __forceinline__ void mma_rows(float acc[][4], const uint32_t a[4], const bf16* rows,
                                         int lane) {
  const bf16* p = rows + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * tile_ld<DH>() +
                  (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + np * 16);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// two 16 x 8 fp32 tiles side by side as one 16 x 16 bf16 A operand
__device__ __forceinline__ void pack_a(uint32_t a[4], const float x0[4], const float x1[4]) {
  a[0] = pack_f32(x0[0], x0[1]);
  a[1] = pack_f32(x0[2], x0[3]);
  a[2] = pack_f32(x1[0], x1[1]);
  a[3] = pack_f32(x1[2], x1[3]);
}

// rows r and r + 8 of a 16 x DH fp32 tile, times `mul`, as bf16 into `out`
// (row stride ld); rows >= S are not written
template <int DH = TILE_DH>
__device__ __forceinline__ void store_rows(bf16* out, size_t ld, const float acc[][4], float mul,
                                           int r0, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (r0 + g < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + g) * ld + n * 8 + 2 * t) =
          pack_f32(acc[n][0] * mul, acc[n][1] * mul);
    if (r0 + g + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)(r0 + g + 8) * ld + n * 8 + 2 * t) =
          pack_f32(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// 1 / sqrt(dh) as an fp32 value: the JAX bodies' Python-float scale, rounded
// once to fp32 (exactly 0.125 at head_dim 64)
static inline float attention_scale(int dh) { return (float)(1.0 / sqrt((double)dh)); }

// ---------------------------------------------------------------------------
// The geometry the kernels take (ops/fused_block.py geometry_route says the
// same in Python): head_dim 16, 32, 48, 64 or 80, D = H head_dim a multiple
// of 32 up to LN_MAX_D, mlp a multiple of 32, any S. Head_dim 64 with D and
// mlp multiples of 64 keeps every route it had; any other geometry takes the
// general route: the seven-launch forward layer on the mma.sync GEMMs, the
// *_bwd_seq sequences, the attention kernels instantiated on head_dim (up to
// FA_MAX_S keys those that hold a row of scores in registers, above it the
// multi-pass routes: csrc/general_long.cuh in bf16, flash_f32.cuh's in fp32,
// and at head_dim 64 long_attention.cuh's; at head_dim 80 the multi-pass
// routes at every S: streamed_head_dim). The bf16 backward core takes S <=
// long_core_max_seq() at head_dim 16-64 (csrc/long_attention.cuh) and less
// at 80 (csrc/general_long.cuh gl_core_max_seq), which its launcher checks.
// ---------------------------------------------------------------------------

// the longest S whose row of scores the S <= 256 attention kernels (bf16
// and flash_f32.cuh's fp32 ones) hold in registers; above it the multi-pass
// routes
#define FA_MAX_S 256

static bool head_dim_ok(int dh) {
  return dh == 16 || dh == 32 || dh == 48 || dh == 64 || dh == 80;
}

// head_dims with no register-row attention kernel (ViT-Huge/14's 80): their
// attention takes the multi-pass routes at every S, S <= FA_MAX_S too
// (csrc/general_long.cuh in bf16, flash_f32.cuh's multi-pass route in fp32)
__host__ __device__ constexpr bool streamed_head_dim(int dh) { return dh > 64; }

static bool general_route(int D, int H, int MLP) {
  return D % 64 || MLP % 64 || H <= 0 || D != H * 64;
}

// The bf16 S <= 256 attention kernels (mma.sync) hold a row of scores in
// registers and are instantiated per key-tile count NT (SP = 8 NT staged
// keys, pad keys masked). At head_dim 64 NT follows S in steps of 16;
// at the general route's head_dims only these counts (S rounded up to 16,
// 32, 64, 128, 208 or 256), so that three more head_dims keep the build time
// bounded.
#define GENERAL_KEY_TILES(X) X(2) X(4) X(8) X(16) X(26) X(32)

static int general_key_tiles(int S) {
  const int nt = (S + 7) / 8;
  const int tiles[] = {2, 4, 8, 16, 26, 32};
  for (int t : tiles)
    if (nt <= t) return t;
  return 0;
}

// ---------------------------------------------------------------------------
// LayerNorm forward: one warp per row, the row's D / 32 values per lane in
// registers, at most PL of them: LN_PL_NARROW up to D = 768 (ViT-Base),
// LN_PL_WIDE up to 1024 (ViT-Large), LN_PL_HUGE above it up to LN_MAX_D =
// 1280 (ViT-Huge). The kernels are instantiated on PL and launched by D, so
// the narrower widths keep the code and the registers they had; one kernel
// at the largest count for every D would hold registers the narrow widths
// never use.
// ---------------------------------------------------------------------------

#define LN_PL_NARROW 24
#define LN_PL_WIDE 32
#define LN_PL_HUGE 40
#define LN_MAX_D (32 * LN_PL_HUGE)
#define LN_WARPS 8

// the per-lane count of a row of D values
__host__ __device__ constexpr int ln_per_lane(int D) {
  return D <= 32 * LN_PL_NARROW ? LN_PL_NARROW : D <= 32 * LN_PL_WIDE ? LN_PL_WIDE : LN_PL_HUGE;
}

// B images of S tokens at width D, H heads, mlp MLP: what every layer
// kernel takes (the attention-only entries skip MLP with MLP = 64)
static bool geometry_ok(int B, int S, int D, int H, int MLP) {
  return B > 0 && S > 0 && H > 0 && D % H == 0 && head_dim_ok(D / H) && D % 32 == 0 &&
         D <= LN_MAX_D && MLP > 0 && MLP % 32 == 0;
}

// 16 bytes of x as floats: 8 bf16 or 4 fp32
__device__ __forceinline__ void unpack16(const uint4& u, float* f, const bf16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float* f, const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// y = TO((x - mean) * rsqrt(var + eps) * scale + bias): fp32 mean, then
// the mean of squared deviations, as _ln_fwd. One warp per row: each lane
// loads 16-byte chunks of the row (D * sizeof(T) a multiple of 16).
template <typename T, typename TO = bf16, int PL = LN_PL_NARROW>
__device__ __forceinline__ void layernorm_row(const T* __restrict__ x,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ bias,
                                              TO* __restrict__ y, int row, int D, float eps,
                                              int lane) {
  constexpr int EPC = 16 / sizeof(T);  // elements per chunk
  constexpr int CPL = PL / EPC;        // chunks per lane, at most
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  const int chunks = D / EPC;
  float v[CPL][EPC];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      unpack16(xr[ch], v[i], x);
#pragma unroll
      for (int e = 0; e < EPC; ++e) s += v[i][e];
    }
  }
  const float mean = warp_sum(s) / (float)D;
  float var = 0.0f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (lane + 32 * i < chunks) {
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const float d = v[i][e] - mean;
        var += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(var) / (float)D + eps);
  TO* yr = y + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
#pragma unroll
      for (int e = 0; e < EPC; e += 2) {
        const int c = ch * EPC + e;
        const float y0 = (v[i][e] - mean) * rstd * scale[c] + bias[c];
        const float y1 = (v[i][e + 1] - mean) * rstd * scale[c + 1] + bias[c + 1];
        store2(yr + c, y0, y1);
      }
    }
  }
}

template <typename T, typename TO, int PL>
__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, TO* __restrict__ y, int M, int D,
                 float eps) {
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row < M) layernorm_row<T, TO, PL>(x, scale, bias, y, row, D, eps, threadIdx.x & 31);
}

template <typename T, typename TO = bf16>
static int launch_layernorm(const T* x, const float* scale, const float* bias, TO* y,
                            int M, int D, float eps, cudaStream_t st) {
  const int blocks = (M + LN_WARPS - 1) / LN_WARPS;
  if (ln_per_lane(D) == LN_PL_NARROW)
    layernorm_kernel<T, TO, LN_PL_NARROW><<<blocks, LN_WARPS * 32, 0, st>>>(x, scale, bias, y,
                                                                           M, D, eps);
  else if (ln_per_lane(D) == LN_PL_WIDE)
    layernorm_kernel<T, TO, LN_PL_WIDE><<<blocks, LN_WARPS * 32, 0, st>>>(x, scale, bias, y, M,
                                                                         D, eps);
  else
    layernorm_kernel<T, TO, LN_PL_HUGE><<<blocks, LN_WARPS * 32, 0, st>>>(x, scale, bias, y, M,
                                                                         D, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// LayerNorm backward, as _ln_bwd, fused with the residual add:
//
//   xhat = (x - mean) * rstd                 recomputed from the bf16 input
//   dxhat = dy * scale
//   out = T(resid + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))
//
// x, resid and out in T (bf16 or fp32). One warp per row, rows strided over
// a grid whose size depends only on M;
// each block also writes its partial sums of dy * xhat (the scale gradient)
// and dy (the bias gradient) over its rows, to partial[blockIdx.x][2 D], for
// reduce_partials_kernel to add in a fixed order.
// ---------------------------------------------------------------------------

#define LNB_WARPS 4
#define LNB_MAX_BLOCKS 1056  // eight per SM of an H100

static int lnb_blocks(int M) {
  const int b = (M + LNB_WARPS - 1) / LNB_WARPS;
  return b < LNB_MAX_BLOCKS ? b : LNB_MAX_BLOCKS;
}

// PL as layernorm_row's: a lane holds D / 64 pairs of columns, rounded up,
// at most PL / 2 (D <= 32 PL). The block's static partials `red` take
// LNB_WARPS x 64 PL floats: 24 KB at LN_PL_NARROW, 32 KB at LN_PL_WIDE, 40
// KB at LN_PL_HUGE, under the 48 KB of static shared memory a block may have
template <typename T, int PL>
__global__ void __launch_bounds__(LNB_WARPS * 32)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dy,
              const T* __restrict__ resid, const float* __restrict__ scale,
              T* __restrict__ out, float* __restrict__ partial, int M, int D,
              float eps) {
  constexpr int LNB_MAX_PAIRS = PL / 2;
  __shared__ float red[LNB_WARPS][64 * PL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // pair i of the lane: columns 64 i + 2 lane and the next, while below D
  // (D a multiple of 32: every pair of the last 64 columns, or the first half)
  float gs[LNB_MAX_PAIRS][2], gb[LNB_MAX_PAIRS][2];
#pragma unroll
  for (int i = 0; i < LNB_MAX_PAIRS; ++i) gs[i][0] = gs[i][1] = gb[i][0] = gb[i][1] = 0.0f;

  for (int row = blockIdx.x * LNB_WARPS + warp; row < M; row += gridDim.x * LNB_WARPS) {
    const size_t base = (size_t)row * D;
    float xv[LNB_MAX_PAIRS][2], dv[LNB_MAX_PAIRS][2];
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < LNB_MAX_PAIRS; ++i) {
      const int c = 64 * i + 2 * lane;
      if (c < D) {
        const float2 xx = load2(x + base + c);
        const float2 dd = *reinterpret_cast<const float2*>(dy + base + c);
        xv[i][0] = xx.x;
        xv[i][1] = xx.y;
        dv[i][0] = dd.x;
        dv[i][1] = dd.y;
        s += xx.x + xx.y;
      }
    }
    const float mean = warp_sum(s) / (float)D;
    float var = 0.0f;
#pragma unroll
    for (int i = 0; i < LNB_MAX_PAIRS; ++i) {
      if (64 * i + 2 * lane < D) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = xv[i][e] - mean;
          var += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / (float)D + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < LNB_MAX_PAIRS; ++i) {
      const int c = 64 * i + 2 * lane;
      if (c < D) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xh = (xv[i][e] - mean) * rstd;
          const float dxh = dv[i][e] * scale[c + e];
          gs[i][e] += dv[i][e] * xh;
          gb[i][e] += dv[i][e];
          xv[i][e] = xh;   // xhat from here on
          dv[i][e] = dxh;  // dxhat from here on
          s1 += dxh;
          s2 += dxh * xh;
        }
      }
    }
    const float m1 = warp_sum(s1) / (float)D;
    const float m2 = warp_sum(s2) / (float)D;
#pragma unroll
    for (int i = 0; i < LNB_MAX_PAIRS; ++i) {
      const int c = 64 * i + 2 * lane;
      if (c < D) {
        const float2 r = load2(resid + base + c);
        const float d0 = rstd * (dv[i][0] - m1 - xv[i][0] * m2);
        const float d1 = rstd * (dv[i][1] - m1 - xv[i][1] * m2);
        store2(out + base + c, r.x + d0, r.y + d1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < LNB_MAX_PAIRS; ++i) {
    const int c = 64 * i + 2 * lane;
    if (c < D) {
      red[warp][c] = gs[i][0];
      red[warp][c + 1] = gs[i][1];
      red[warp][D + c] = gb[i][0];
      red[warp][D + c + 1] = gb[i][1];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * D; j += blockDim.x) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) v += red[w][j];
    partial[(size_t)blockIdx.x * 2 * D + j] = v;
  }
}

// A sum of split partials still to be taken: out0[j] (j < n0) or
// out1[j - n0] = sum over p of partial[p][j], p in order, for j < n. With
// tcols > 0 the first n0 entries are a row-major (n0 / tcols, tcols) matrix
// that out0 receives transposed. tree: reduce_all_kernel takes it as a tree
// (for many parts; see there), else part by part.
struct Reduction {
  const float* partial;
  int parts, n, n0;
  float* out0;
  float* out1;
  int tcols;
  int tree;
};

__device__ __forceinline__ void reduce_one(const Reduction& r, int j) {
  float s = 0.0f;
#pragma unroll 4
  for (int p = 0; p < r.parts; ++p) s += r.partial[(size_t)p * r.n + j];
  if (j >= r.n0)
    r.out1[j - r.n0] = s;
  else if (r.tcols)
    r.out0[(size_t)(j % r.tcols) * (r.n0 / r.tcols) + j / r.tcols] = s;
  else
    r.out0[j] = s;
}

__global__ void reduce_partials_kernel(Reduction r) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < r.n) reduce_one(r, j);
}

static int launch_reduce(const Reduction& r, cudaStream_t st) {
  reduce_partials_kernel<<<(r.n + 255) / 256, 256, 0, st>>>(r);
  return (int)cudaGetLastError();
}

// Reductions collected to be taken by one launch (reduce_all_kernel).
#define MAX_REDUCTIONS 8
struct Reductions {
  Reduction r[MAX_REDUCTIONS];
  int count;
};

// Add `r` to the reductions that one reduce_all launch will take.
static int defer_reduction(Reductions* rs, const Reduction& r) {
  if (rs->count == MAX_REDUCTIONS) return (int)cudaErrorInvalidValue;
  rs->r[rs->count++] = r;
  return 0;
}

// One launch for every collected reduction. A reduction takes a thread per
// output, its parts in order (reduce_one, the order reduce_partials_kernel
// takes, so the same bits), or, with `tree` (many parts: the row-block
// kernels' per-warp LayerNorm partials), a block per 32 outputs: warp w sums
// parts w, w + 8, ... in four interleaved chains, then warp 0 adds the 8
// warps' sums in order. Either order is fixed, so two runs give the same
// bits.
#define REDUCE_THREADS 256

__host__ __device__ static int reduce_blocks(const Reduction& r) {
  return r.tree ? (r.n + 31) / 32 : (r.n + REDUCE_THREADS - 1) / REDUCE_THREADS;
}

__device__ __forceinline__ void reduce_tree(const Reduction& r, int j0, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, j = j0 + lane;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (j < r.n)
    for (int p = w, k = 0; p < r.parts; p += 8, k = (k + 1) & 3)
      a[k] += r.partial[(size_t)p * r.n + j];
  red[w * 32 + lane] = (a[0] + a[1]) + (a[2] + a[3]);
  __syncthreads();
  if (w == 0 && j < r.n) {
    float s = 0.0f;
    for (int i = 0; i < 8; ++i) s += red[i * 32 + lane];
    if (j >= r.n0)
      r.out1[j - r.n0] = s;
    else if (r.tcols)
      r.out0[(size_t)(j % r.tcols) * (r.n0 / r.tcols) + j / r.tcols] = s;
    else
      r.out0[j] = s;
  }
}

__global__ void __launch_bounds__(REDUCE_THREADS) reduce_all_kernel(Reductions rs) {
  __shared__ float red[REDUCE_THREADS];
  int b = blockIdx.x;
  for (int i = 0; i < rs.count; ++i) {
    const Reduction& r = rs.r[i];
    const int nb = reduce_blocks(r);
    if (b < nb) {
      if (!r.tree) {
        const int j = b * REDUCE_THREADS + threadIdx.x;
        if (j < r.n) reduce_one(r, j);
      } else {
        reduce_tree(r, b * 32, red);
      }
      return;
    }
    b -= nb;
  }
}

static int launch_reduce_all(const Reductions& rs, cudaStream_t st) {
  int nb = 0;
  for (int i = 0; i < rs.count; ++i) nb += reduce_blocks(rs.r[i]);
  reduce_all_kernel<<<nb, REDUCE_THREADS, 0, st>>>(rs);
  return (int)cudaGetLastError();
}

// LayerNorm backward plus the reduction of its parameter gradients.
template <typename T>
static int launch_ln_bwd(const T* x, const float* dy, const T* resid,
                         const float* scale, T* out, float* ws, float* gscale,
                         float* gbias, int M, int D, float eps, cudaStream_t st) {
  const int nb = lnb_blocks(M);
  if (ln_per_lane(D) == LN_PL_NARROW)
    ln_bwd_kernel<T, LN_PL_NARROW><<<nb, LNB_WARPS * 32, 0, st>>>(x, dy, resid, scale, out, ws,
                                                                  M, D, eps);
  else if (ln_per_lane(D) == LN_PL_WIDE)
    ln_bwd_kernel<T, LN_PL_WIDE><<<nb, LNB_WARPS * 32, 0, st>>>(x, dy, resid, scale, out, ws, M,
                                                                D, eps);
  else
    ln_bwd_kernel<T, LN_PL_HUGE><<<nb, LNB_WARPS * 32, 0, st>>>(x, dy, resid, scale, out, ws, M,
                                                                D, eps);
  LAUNCH((int)cudaGetLastError());
  return launch_reduce({ws, nb, 2 * D, D, gscale, gbias, 0, 0}, st);
}

// ---------------------------------------------------------------------------
// GEMM: C[M, N] = op(A) op(B), T operands (bf16 or fp32), fp32 accumulation,
// fused epilogue. Operand layouts (row-major in device memory):
//
//   AT = false: A is (M, K)         AT = true: A is (K, M - 1), and C = A^T B
//   BT = false: B is (K, N)         BT = true: B is (N, K), and C = A B^T
//
// AT is the weight-gradient form: the reduction runs over K token rows, which
// need not be a multiple of BK, and split over gridDim.z blocks that each
// write an fp32 partial (C + z M N) for reduce_partials_kernel. Its last
// output row M - 1 multiplies B by a column of ones in A, so it holds B's
// column sums: the bias gradient comes out of the same pass.
//
// N a multiple of 32: the last column tile may be half outside, its
// columns past N read as zeros and never written.
//
// bf16: mma.sync m16n8k16, 128x64x32 block tiles, 4 warps of 64x32 fed by
// ldmatrix (.trans for the operands stored with the reduction index
// outermost), a 3-stage cp.async pipeline, the epilogue applied to the
// accumulator registers. fp32 (gemm_f32_kernel, below): CUDA-core FMAs,
// each output one chain in ascending k over the same split of K.
// ---------------------------------------------------------------------------

#define BM 128
#define BN 64
#define BK 32
#define GEMM_THREADS 128  // 4 warps: 2 along M x 2 along N, 64 x 32 each

// bf16 elements per row of a staged tile: rows stay 16-byte aligned and
// ldmatrix reads them without bank conflicts
template <bool AT> __host__ __device__ constexpr int a_ld() { return AT ? BM + 8 : BK + 8; }
template <bool AT> __host__ __device__ constexpr int a_tile() { return AT ? BK * a_ld<AT>() : BM * a_ld<AT>(); }
template <bool BT> __host__ __device__ constexpr int b_ld() { return BT ? BK + 8 : BN + 8; }
template <bool BT> __host__ __device__ constexpr int b_tile() { return BT ? BN * b_ld<BT>() : BK * b_ld<BT>(); }
template <bool AT, bool BT> __host__ __device__ constexpr int gemm_smem() {
  return GEMM_STAGES * (a_tile<AT>() + b_tile<BT>()) * 2;  // bytes
}

enum {
  EPI_BIAS = 0,   // out = T(acc + bias)
  EPI_RESID = 1,  // x2 = resid + acc + bias (fp32), with the xs / x2s stacks
  EPI_GELU = 2,   // out = T(gelu(acc + bias))
  EPI_OUT = 3,    // out = T(x2 + acc + bias)
  EPI_STORE = 4,  // out = T(acc)
  EPI_F32 = 5,    // f32[z M N + i] = acc (split partials when gridDim.z > 1)
  EPI_GELU2 = 6,  // m = T(acc + bias); out = T(gelu(m)), out2 = T(gelu'(m))
  EPI_DM1 = 7,    // out = T(T(acc) * aux), in place over aux allowed
  EPI_LNBWD = 8,  // rowblock_gemm_kernel only: LayerNorm backward of full rows
};

template <typename T>
struct EpiArgsT {
  const T* bias;   // (N,)
  T* out;          // (M, N) result
  T* out2;         // EPI_GELU2: gelu'
  const T* aux;    // EPI_DM1: the factor
  float* f32;      // EPI_F32: fp32 result; EPI_RESID writes and EPI_OUT reads x2
  const T* resid;  // EPI_RESID: the layer input (M, N)
  T* xs;           // EPI_RESID, optional: copy of the layer input
  T* x2s;          // EPI_RESID, optional: T(x2)
  int fast_gelu;
};
typedef EpiArgsT<bf16> EpiArgs;

// The epilogue of one output pair: row gr, columns gc and gc + 1, with
// their fp32 sums a0, a1.
template <int EPI, typename T>
__device__ __forceinline__ void epilogue_pair(const EpiArgsT<T>& ep, int M, int N, int gr,
                                              int gc, float a0, float a1) {
  const size_t idx = (size_t)gr * N + gc;
  T* out = ep.out + idx;
  if (EPI == EPI_STORE) {
    store2(out, a0, a1);
    return;
  }
  if (EPI == EPI_F32) {
    *reinterpret_cast<float2*>(ep.f32 + (size_t)blockIdx.z * M * N + idx) = make_float2(a0, a1);
    return;
  }
  if (EPI == EPI_DM1) {
    const float2 f = load2(ep.aux + idx);
    store2(out, rnd<T>(a0) * f.x, rnd<T>(a1) * f.y);
    return;
  }
  const float b0 = to_f(ep.bias[gc]);
  const float b1 = to_f(ep.bias[gc + 1]);
  if (EPI == EPI_BIAS) {
    store2(out, a0 + b0, a1 + b1);
  } else if (EPI == EPI_RESID) {
    const float2 x = load2(ep.resid + idx);
    const float2 x2 = make_float2((x.x + a0) + b0, (x.y + a1) + b1);
    *reinterpret_cast<float2*>(ep.f32 + idx) = x2;
    if (ep.xs) store2(ep.xs + idx, x.x, x.y);
    if (ep.x2s) store2(ep.x2s + idx, x2.x, x2.y);
  } else if (EPI == EPI_GELU) {
    store2(out, gelu(a0 + b0, ep.fast_gelu), gelu(a1 + b1, ep.fast_gelu));
  } else if (EPI == EPI_GELU2) {
    const float m0 = rnd<T>(a0 + b0), m1 = rnd<T>(a1 + b1);
    store2(out, gelu(m0, ep.fast_gelu), gelu(m1, ep.fast_gelu));
    store2(ep.out2 + idx, gelu_grad(m0, ep.fast_gelu), gelu_grad(m1, ep.fast_gelu));
  } else {  // EPI_OUT
    const float2 x2 = *reinterpret_cast<const float2*>(ep.f32 + idx);
    store2(out, (x2.x + a0) + b0, (x2.y + a1) + b1);
  }
}

template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, int M, int N, int K,
            int kt_per_split, EpiArgs ep) {
  constexpr int ALD = a_ld<AT>(), BLD = b_ld<BT>();
  constexpr int ATILE = a_tile<AT>(), BTILE = b_tile<BT>();
  extern __shared__ __align__(128) bf16 gsm[];
  bf16* As = gsm;
  bf16* Bs = gsm + GEMM_STAGES * ATILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 64;
  const int wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kt_all = (K + BK - 1) / BK;
  const int kt_n = min(kt_per_split, kt_all - kt0);

  // stage `buf` of the pipeline: reduction indices k0..k0+BK of A and B
  auto load_stage = [&](int buf, int k0) {
    bf16* as = As + buf * ATILE;
    bf16* bs = Bs + buf * BTILE;
    if (!AT) {
      for (int i = tid; i < BM * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8);
        const int c8 = (i % (BK / 8)) * 8;
        const int gr = m0 + r;
        // rows past M read row 0 (any valid address) and are zero-filled
        cp_async16(&as[r * ALD + c8], A + (size_t)(gr < M ? gr : 0) * K + k0 + c8, gr < M);
      }
    } else {
      const int ma = M - 1;  // A's columns; column ma is the ones column
      for (int i = tid; i < BK * (BM / 8); i += GEMM_THREADS) {
        const int r = i / (BM / 8);
        const int c8 = (i % (BM / 8)) * 8;
        const int gk = k0 + r;
        const int gc = m0 + c8;
        bf16* dst = &as[r * ALD + c8];
        if (gc == ma) {  // bf16 1.0 (0x3f80) in the first of the 8 lanes
          *reinterpret_cast<uint4*>(dst) = make_uint4(gk < K ? 0x3f80u : 0u, 0u, 0u, 0u);
        } else {
          const bool ok = gk < K && gc < ma;
          cp_async16(dst, A + (ok ? (size_t)gk * ma + gc : 0), ok);
        }
      }
    }
    if (!BT) {
      for (int i = tid; i < BK * (BN / 8); i += GEMM_THREADS) {
        const int r = i / (BN / 8);
        const int c8 = (i % (BN / 8)) * 8;
        const int gk = k0 + r;
        const bool ok = gk < K && n0 + c8 < N;
        cp_async16(&bs[r * BLD + c8], ok ? B + (size_t)gk * N + n0 + c8 : B, ok);
      }
    } else {
      for (int i = tid; i < BN * (BK / 8); i += GEMM_THREADS) {
        const int r = i / (BK / 8);
        const int c8 = (i % (BK / 8)) * 8;
        const bool ok = n0 + r < N;
        cp_async16(&bs[r * BLD + c8], ok ? B + (size_t)(n0 + r) * K + k0 + c8 : B, ok);
      }
    }
  };

  // acc[mi][ni]: rows wm + 16 mi + {g, g + 8}, columns wn + 8 ni + {2t, 2t + 1}
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < GEMM_STAGES - 1; ++st) {
    if (st < kt_n) load_stage(st, (kt0 + st) * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait_stages();  // stage kt has landed (for this thread) ...
    __syncthreads();         // ... for every thread; stage kt - 1 is consumed
    // refill the buffer stage kt - 1 used; empty groups keep the count even
    const int next = kt + GEMM_STAGES - 1;
    if (next < kt_n) load_stage(next % GEMM_STAGES, (kt0 + next) * BK);
    cp_async_commit();

    const bf16* as = As + (kt % GEMM_STAGES) * ATILE;
    const bf16* bs = Bs + (kt % GEMM_STAGES) * BTILE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (!AT)
          ldmatrix_x4(a[mi], &as[(wm + mi * 16 + (lane & 15)) * ALD + kk + (lane >> 4) * 8]);
        else
          ldmatrix_x4_trans(a[mi], &as[(kk + (lane & 7) + (lane >> 4) * 8) * ALD + wm +
                                       mi * 16 + ((lane >> 3) & 1) * 8]);
      }
      uint32_t b[2][4];  // b[np]: b0, b1 of column tile 2 np, then of 2 np + 1
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (!BT)
          ldmatrix_x4_trans(b[np], &bs[(kk + (lane & 7) + ((lane >> 3) & 1) * 8) * BLD + wn +
                                       np * 16 + (lane >> 4) * 8]);
        else
          ldmatrix_x4(b[np], &bs[(wn + np * 16 + (lane & 7) + (lane >> 4) * 8) * BLD + kk +
                                 ((lane >> 3) & 1) * 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int gr = m0 + wm + mi * 16 + g;
      const int gc = n0 + wn + ni * 8 + 2 * t;
      if (gc >= N) continue;
      if (gr < M) epilogue_pair<EPI>(ep, M, N, gr, gc, acc[mi][ni][0], acc[mi][ni][1]);
      if (gr + 8 < M) epilogue_pair<EPI>(ep, M, N, gr + 8, gc, acc[mi][ni][2], acc[mi][ni][3]);
    }
}


// The fp32 GEMM on the CUDA cores (the tensor cores take no fp32 operand;
// TF32 would be another function). What bounds it is the FMA rate (67
// TFLOP/s on an H100 SXM), so the design keeps the FMA pipes fed:
//
//   * 64 x 16 TN block tiles (TN = 12, 8 or 4: 192, 128 or 64 columns, the
//     widest that divides N; 192 divides every N of ViT-Tiny's layer; at N a
//     multiple of 32 only, 64 with the last tile's columns past N zeros in
//     and never written), 128
//     threads as 8 x 16, thread (ty, tx) summing 8 rows (4 ty + 0..3 and
//     32 + 4 ty + 0..3) by TN columns: 8 TN FMAs per k step against 2 + TN / 4
//     float4 shared reads. At 168 registers or fewer three blocks share an
//     SM; 64-row tiles keep the grid at about a whole number of waves of
//     three blocks per SM on the 25,216 token rows of a B = 128 microbatch;
//   * A and B staged by 16-byte cp.async in a ring of GEMM_STAGES tiles of
//     F32_BK k steps (two tiles in flight while one is summed), each in the
//     layout it has in device memory, so nothing is transposed on the way
//     in: A as [row][k] (AT false) or [k][row] (AT true), B as [k][col] (BT
//     false) or [col][k] (BT true). A thread reads each operand as float4,
//     along k where k is the fast index (four k steps at a time), else along
//     rows or columns. Where k is fast, rows are F32_KLD floats apart and a
//     warp's reads meet no bank conflict: A's two row groups per warp land
//     20 float4 apart, and with B as [col][k] a thread's columns are
//     16 j + tx, consecutive across a half-warp (with B as [k][col] they are
//     the float4 groups 64 j + 4 tx);
//   * the sums leave through shared memory (the ring, reused), so the
//     epilogue runs as a loop with coalesced stores;
//   * every output is one fmaf chain over k in ascending order from 0,
//     over the split of K that the bf16 kernel takes (kt_per_split tiles of
//     BK), so the bits do not depend on this geometry;
//   * AT (the weight gradients): row M - 1 of the product, A's column of
//     ones, is B's column sums, the bias gradient. The blocks of the first
//     row tile take it apart from the tiles: thread t < 8 TN adds columns
//     2 t and 2 t + 1 of each staged B row in order (fmaf(1, b, s) is s + b),
//     so the row tiles cover A's K1 columns exactly.

#define F32_BM 64
#define F32_BK 16
#define F32_THREADS 128
#define F32_KLD (F32_BK + 4)  // floats per staged row whose fast index is k

template <bool AT> __host__ __device__ constexpr int f32_a_tile() {
  return AT ? F32_BK * F32_BM : F32_BM * F32_KLD;
}
template <bool BT, int TN> __host__ __device__ constexpr int f32_b_tile() {
  return BT ? 16 * TN * F32_KLD : F32_BK * 16 * TN;
}
template <bool AT, bool BT, int TN> __host__ __device__ constexpr int f32_gemm_smem() {
  const int ring = GEMM_STAGES * (f32_a_tile<AT>() + f32_b_tile<BT, TN>());
  const int tile = F32_BM * (16 * TN + 4);  // the epilogue's staged sums
  return (ring > tile ? ring : tile) * 4;   // bytes
}

template <bool AT, bool BT, int EPI, int TN>
__global__ void __launch_bounds__(F32_THREADS, 3)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N, int K,
                int k_per_split, EpiArgsT<float> ep) {
  constexpr int BNF = 16 * TN;
  constexpr int ATILE = f32_a_tile<AT>(), STAGE = ATILE + f32_b_tile<BT, TN>();
  static_assert(!(AT && BT), "the weight-gradient form reads B as [k][col]");
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * F32_BM, n0 = blockIdx.x * BNF;
  const int kb = blockIdx.z * k_per_split;
  const int nt = (min(kb + k_per_split, K) - kb + F32_BK - 1) / F32_BK;
  const int rows = AT ? M - 1 : M;  // rows of the product from A (AT: A's columns)
  const bool sums = AT && blockIdx.y == 0 && tid < BNF / 2 && n0 + 2 * tid < N;  // B's column sums

  // tile k0 .. k0 + F32_BK of A and B into ring slot `buf`; what lies past
  // K, M or A's columns is zero-filled (K, N and A's row length are
  // multiples of 4, so a 16-byte chunk is all in or all out)
  auto load = [&](int buf, int k0) {
    float* as = fsm + buf * STAGE;
    float* bs = as + ATILE;
    if constexpr (!AT) {
      for (int i = tid; i < F32_BM * (F32_BK / 4); i += F32_THREADS) {
        const int r = i / (F32_BK / 4), c = (i % (F32_BK / 4)) * 4;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(as + r * F32_KLD + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
      }
    } else {
      for (int i = tid; i < F32_BK * (F32_BM / 4); i += F32_THREADS) {
        const int r = i / (F32_BM / 4), c = (i % (F32_BM / 4)) * 4;
        const bool ok = k0 + r < K && m0 + c < rows;
        cp_async16(as + r * F32_BM + c, ok ? A + (size_t)(k0 + r) * rows + m0 + c : A, ok);
      }
    }
    if constexpr (!BT) {
      for (int i = tid; i < F32_BK * (BNF / 4); i += F32_THREADS) {
        const int r = i / (BNF / 4), c = (i % (BNF / 4)) * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(bs + r * BNF + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
      }
    } else {
      for (int i = tid; i < BNF * (F32_BK / 4); i += F32_THREADS) {
        const int r = i / (F32_BK / 4), c = (i % (F32_BK / 4)) * 4;
        const bool ok = k0 + c < K && n0 + r < N;
        cp_async16(bs + r * F32_KLD + c, ok ? B + (size_t)(n0 + r) * K + k0 + c : B, ok);
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float bsum0 = 0.0f, bsum1 = 0.0f;

#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < nt) load(s, kb + s * F32_BK);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait_stages();  // tile t has landed (for this thread) ...
    __syncthreads();      // ... for every thread; tile t - 1 is summed
    const int next = t + GEMM_STAGES - 1;
    if (next < nt) load(next % GEMM_STAGES, kb + next * F32_BK);
    cp_async_commit();  // empty groups keep the count even

    const float* as = fsm + (t % GEMM_STAGES) * STAGE;
    const float* bs = as + ATILE;
#pragma unroll
    for (int k4 = 0; k4 < F32_BK; k4 += 4) {
      float a[8][4];  // a[i][kk]: row i of the thread, k step k4 + kk
      if constexpr (!AT) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              as + (4 * ty + (i & 3) + 32 * (i >> 2)) * F32_KLD + k4);
          a[i][0] = v.x;
          a[i][1] = v.y;
          a[i][2] = v.z;
          a[i][3] = v.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 lo = *reinterpret_cast<const float4*>(as + (k4 + kk) * F32_BM + 4 * ty);
          const float4 hi =
              *reinterpret_cast<const float4*>(as + (k4 + kk) * F32_BM + 32 + 4 * ty);
          a[0][kk] = lo.x;
          a[1][kk] = lo.y;
          a[2][kk] = lo.z;
          a[3][kk] = lo.w;
          a[4][kk] = hi.x;
          a[5][kk] = hi.y;
          a[6][kk] = hi.z;
          a[7][kk] = hi.w;
        }
      }
      if constexpr (!BT) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int jg = 0; jg < TN / 4; ++jg) {
            const float4 b =
                *reinterpret_cast<const float4*>(bs + (k4 + kk) * BNF + 64 * jg + 4 * tx);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][4 * jg] = fmaf(a[i][kk], b.x, acc[i][4 * jg]);
              acc[i][4 * jg + 1] = fmaf(a[i][kk], b.y, acc[i][4 * jg + 1]);
              acc[i][4 * jg + 2] = fmaf(a[i][kk], b.z, acc[i][4 * jg + 2]);
              acc[i][4 * jg + 3] = fmaf(a[i][kk], b.w, acc[i][4 * jg + 3]);
            }
          }
          if constexpr (AT) {
            if (sums) {
              const float2 b = *reinterpret_cast<const float2*>(bs + (k4 + kk) * BNF + 2 * tid);
              bsum0 += b.x;
              bsum1 += b.y;
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(bs + (16 * j + tx) * F32_KLD + k4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][j] = fmaf(a[i][0], b.x, acc[i][j]);
            acc[i][j] = fmaf(a[i][1], b.y, acc[i][j]);
            acc[i][j] = fmaf(a[i][2], b.z, acc[i][j]);
            acc[i][j] = fmaf(a[i][3], b.w, acc[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the block
  __syncthreads();      // every thread is done with the ring: it becomes the tile

  // the block's sums through shared memory ([row][col], rows BNF + 4 floats
  // apart), then the epilogue over it row by row, four columns a thread,
  // consecutive threads on consecutive columns: coalesced stores, and a loop
  // instead of the thread's 8 TN outputs unrolled (unrolled, the gelu /
  // gelu' epilogue took the m1 GEMM at B = 128 from 0.30 to 0.57 ms on an
  // H100 80GB HBM3 at 700 W)
  float* tile = fsm;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = tile + (4 * ty + (i & 3) + 32 * (i >> 2)) * (BNF + 4);
    if constexpr (!BT) {
#pragma unroll
      for (int jg = 0; jg < TN / 4; ++jg)
        *reinterpret_cast<float4*>(row + 64 * jg + 4 * tx) =
            make_float4(acc[i][4 * jg], acc[i][4 * jg + 1], acc[i][4 * jg + 2],
                        acc[i][4 * jg + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) row[16 * j + tx] = acc[i][j];
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int q = tid; q < F32_BM * (BNF / 4); q += F32_THREADS) {
    const int r = q / (BNF / 4), c = (q % (BNF / 4)) * 4, gr = m0 + r;
    if (gr < rows && n0 + c < N) {
      const float4 v = *reinterpret_cast<const float4*>(tile + r * (BNF + 4) + c);
      epilogue_pair<EPI>(ep, M, N, gr, n0 + c, v.x, v.y);
      epilogue_pair<EPI>(ep, M, N, gr, n0 + c + 2, v.z, v.w);
    }
  }
  if constexpr (AT)
    if (sums) epilogue_pair<EPI>(ep, M, N, M - 1, n0 + 2 * tid, bsum0, bsum1);
}

template <bool AT, bool BT, int EPI, int TN>
static int launch_gemm_f32(const float* A, const float* B, int M, int N, int K,
                           int k_per_split, int zsplits, const EpiArgsT<float>& ep,
                           cudaStream_t st) {
  constexpr int smem = f32_gemm_smem<AT, BT, TN>();
  cudaError_t e = cudaFuncSetAttribute(gemm_f32_kernel<AT, BT, EPI, TN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int rows = AT ? M - 1 : M;
  const dim3 grid((N + 16 * TN - 1) / (16 * TN), (rows + F32_BM - 1) / F32_BM, zsplits);
  gemm_f32_kernel<AT, BT, EPI, TN><<<grid, F32_THREADS, smem, st>>>(A, B, M, N, K, k_per_split,
                                                                    ep);
  return (int)cudaGetLastError();
}

// Launch one GEMM (bf16 with its dynamic shared memory, above the 48 KB a
// block gets without asking; fp32 at the widest column tile that divides
// N), the reduction split over `splits` blocks in z.
template <typename T, bool AT, bool BT, int EPI>
static int launch_gemm(const T* A, const T* B, int M, int N, int K, const EpiArgsT<T>& ep,
                       cudaStream_t st, int splits = 1) {
  const int kt_all = (K + BK - 1) / BK;
  const int kps = (kt_all + splits - 1) / splits;
  const int zs = (kt_all + kps - 1) / kps;
  if constexpr (sizeof(T) == 2) {
    constexpr int smem = gemm_smem<AT, BT>();
    cudaError_t e = cudaFuncSetAttribute(gemm_kernel<AT, BT, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, zs);
    gemm_kernel<AT, BT, EPI><<<grid, GEMM_THREADS, smem, st>>>(A, B, M, N, K, kps, ep);
    return (int)cudaGetLastError();
  } else {
    if (N % 192 == 0) return launch_gemm_f32<AT, BT, EPI, 12>(A, B, M, N, K, kps * BK, zs, ep, st);
    if (N % 128 == 0) return launch_gemm_f32<AT, BT, EPI, 8>(A, B, M, N, K, kps * BK, zs, ep, st);
    return launch_gemm_f32<AT, BT, EPI, 4>(A, B, M, N, K, kps * BK, zs, ep, st);
  }
}

// ---------------------------------------------------------------------------
// Weight gradients: [dW; db] = [A | 1]^T B summed over the M token rows, in
// split partials reduced in a fixed order (no atomics, so two runs give the
// same bits). A is (M, K1), B is (M, N); dW is (K1, N), db is (N,), fp32.
// ---------------------------------------------------------------------------

#define WGRAD_TARGET_BLOCKS 528  // four per SM of an H100

// The split count: enough blocks to fill the card about four times, at least one
// BK step of token rows each. It depends only on the shapes.
static int wgrad_splits(int K1, int N, int M) {
  const int tiles = ((N + BN - 1) / BN) * ((K1 + 1 + BM - 1) / BM);
  const int kt_all = (M + BK - 1) / BK;
  int s = (WGRAD_TARGET_BLOCKS + tiles - 1) / tiles;
  if (s > kt_all) s = kt_all;
  const int kps = (kt_all + s - 1) / s;
  return (kt_all + kps - 1) / kps;
}

static size_t wgrad_workspace_floats(int K1, int N, int M) {
  return (size_t)wgrad_splits(K1, N, M) * (K1 + 1) * N;
}

template <typename T>
static int launch_wgrad(const T* A, const T* B, int K1, int N, int M, float* ws,
                        float* dw, float* db, cudaStream_t st) {
  const int splits = wgrad_splits(K1, N, M);
  EpiArgsT<T> ep = {};
  ep.f32 = ws;
  LAUNCH((launch_gemm<T, true, false, EPI_F32>(A, B, K1 + 1, N, M, ep, st, splits)));
  return launch_reduce({ws, splits, (K1 + 1) * N, K1 * N, dw, db, 0, 0}, st);
}

extern "C" const char* vit2spn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
