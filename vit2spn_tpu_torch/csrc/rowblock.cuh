// The row-block GEMM kit of the port's Hopper (sm_90a) layer kernels: the
// mbarrier weight ring, LayerNorm into a resident swizzled A tile, and
// rowblock_gemm_kernel, a wgmma GEMM whose block owns ROWS = 64 WG rows for
// the whole of its work, with its operands streamed by TMA and its
// epilogues fused. csrc/layer_fwd.cuh runs it for the forward layer,
// csrc/mlp_bwd.cuh and csrc/attn_bwd.cuh for the backward halves.

#pragma once

#include <type_traits>

#include "hopper.cuh"

// a bf16 pair (low half first) as floats, exactly
__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// a quad's (lanes 4 g .. 4 g + 3) sum: the four lanes that hold one row of
// a wgmma fragment
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// gelu of the row-block kernels' epilogues (the forward's MLP, the MLP
// backward's recompute): common.cuh's two forms, each division taken as
// __fdividef (within 2 ulp, the divisor is in [1, 32]); the IEEE division
// made the forward's gelu epilogue more than half of its kernel's time
template <int FAST>
__device__ __forceinline__ float gelu_fwd(float m) {
  if constexpr (FAST) {
    const float xc = fminf(fmaxf(m, -4.6f), 4.6f);
    const float s = xc * xc;
    float p = 3.303320889057693e-05f;
    p = 0.003819241585880179f + s * p;
    p = 0.027416247095983802f + s * p;
    p = 0.3989386549977406f + s * p;
    float q = 0.0011597711855913715f;
    q = 0.023787000484733943f + s * q;
    q = 0.23538129451100157f + s * q;
    q = 1.0f + s * q;
    return m * (0.5f + xc * __fdividef(p, q));
  }
  const float x = m * 0.7071067811865476f;
  const float sign = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * ax);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  return 0.5f * m * (1.0f + sign * (1.0f - poly * expf(-ax * ax)));
}

// ---------------------------------------------------------------------------
// The weight ring: stages filled by the producer warp's TMA loads in the
// order the consumers take them; a stage is free again once every consumer
// warp has released it.
// ---------------------------------------------------------------------------

struct Ring {
  uint64_t* full;   // count 1: the producer's expect_tx, then the bytes
  uint64_t* empty;  // count: the consumer warps
  uint8_t* base;
  int stage_bytes, stages, it;

  // producer: the next stage, once free, expecting `bytes`
  __device__ __forceinline__ uint8_t* fill(uint32_t bytes, uint64_t** bar) {
    const int s = it % stages;
    mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
    mbar_expect_tx(&full[s], bytes);
    ++it;
    *bar = &full[s];
    return base + s * stage_bytes;
  }
  // consumer: the next stage, once loaded; returns its index
  __device__ __forceinline__ int take() {
    const int s = it % stages;
    mbar_wait(&full[s], (it / stages) & 1);
    ++it;
    return s;
  }
  __device__ __forceinline__ const uint8_t* at(int s) const { return base + s * stage_bytes; }
  // consumer: done with stage s (lane 0 speaks for its warp)
  __device__ __forceinline__ void release(int s, int lane) const {
    if (lane == 0) mbar_arrive(&empty[s]);
  }
};

__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int stages,
                                          int consumer_warps) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);
    mbar_init(&empty[s], consumer_warps);
  }
}

// ---------------------------------------------------------------------------
// Row-block GEMM on wgmma: C[ROWS, N] = A[ROWS, K] B[K, N] with a fused
// epilogue (common.cuh's epilogue_pair, or one of its own). A is LayerNorm of
// the rows of x, computed once into a resident K-major tile (bf16 x arrives
// there by TMA and is normalized in place; fp32 x2 is read from device
// memory), or is streamed by TMA beside B. B is streamed in stages of 64 K
// rows x NT columns: from a row-major (K, N) weight (TB = 1), or, for the
// product with a row-major (N, K) weight's transpose, from its rows, K-major
// (TB = 0). The warpgroups walk every NT-column tile of N, one k-chunk's
// products in flight while the next is issued.
// ---------------------------------------------------------------------------

enum { A_LN_BF16 = 0, A_LN_F32 = 1, A_TMA = 2 };


#ifndef GEMM_RING
#define GEMM_RING 4  // weight stages in flight
#endif
#define SMEM_LIMIT 232448  // dynamic shared memory a block may have

template <int WG, int NT, int ASRC>
__host__ __device__ constexpr int rb_stage_bytes() {
  return (ASRC == A_TMA ? WG * TMA_BOX_BYTES : 0) + (NT / 64) * TMA_BOX_BYTES;
}

// the bias epilogue (the QKV product) leaves through a staged tile and TMA
// stores; the others store from the registers
template <int WG, int NT, int EPI>
__host__ __device__ constexpr int rb_out_bytes() {
  return (EPI == EPI_BIAS || EPI == EPI_DM1 ? 1 : EPI == EPI_GELU2 ? 2 : 0) * WG * (NT / 64) *
         TMA_BOX_BYTES;
}

// weight stages in flight: two where the epilogue stages two output tiles
template <int EPI>
__host__ __device__ constexpr int rb_ring() {
  return EPI == EPI_GELU2 ? 2 : GEMM_RING;
}

template <int WG, int NT, int ASRC, int EPI>
static int rb_smem_bytes(int K) {
  return 1024 + (ASRC == A_TMA ? 0 : K * WG * 64 * 2) + rb_out_bytes<WG, NT, EPI>() +
         rb_ring<EPI>() * rb_stage_bytes<WG, NT, ASRC>();
}

// LayerNorm in place of rows lr0 .. lr0 + 15 of a K-major bf16 tile (D / 64
// regions of `rows` rows), D <= 256: four rows at a time, eight lanes per
// row, each lane up to four 8-column chunks; fp32 mean, then the mean of
// squared deviations.
__device__ __forceinline__ void ln_tile_rows(uint8_t* a, int rows, int lr0,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias, int D, float eps,
                                             int lane) {
  const int sub = lane >> 3, cp = lane & 7, chunks = D >> 3;
  float sc[4][8], bi[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = (cp + 8 * j) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[j][e] = c < D ? scale[c + e] : 0.0f;
      bi[j][e] = c < D ? bias[c + e] : 0.0f;
    }
  }
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int lr = lr0 + 4 * pass + sub;
    float v[4][8];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = cp + 8 * j;
      if (ch < chunks) {
        unpack16(*reinterpret_cast<const uint4*>(a + (ch >> 3) * rows * 128 + sw128(lr, (ch & 7) * 8)),
                 v[j], static_cast<const bf16*>(nullptr));
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[j][e];
      }
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / (float)D;
    float var = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (cp + 8 * j < chunks)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[j][e] - mean;
          var += d * d;
        }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
    const float rstd = rsqrtf(var / (float)D + eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = cp + 8 * j;
      if (ch < chunks) {
        uint32_t p[4];
#pragma unroll
        for (int e = 0; e < 8; e += 2)
          p[e / 2] = pack_f32((v[j][e] - mean) * rstd * sc[j][e] + bi[j][e],
                              (v[j][e + 1] - mean) * rstd * sc[j][e + 1] + bi[j][e + 1]);
        *reinterpret_cast<uint4*>(a + (ch >> 3) * rows * 128 + sw128(lr, (ch & 7) * 8)) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
  }
}

// LayerNorm of one row (D values) as bf16 into row `lr` of a K-major A tile
// (D / 64 regions of `rows` rows); the statistics as common.cuh's
// layernorm_row: fp32 mean, then the mean of squared deviations, one warp per
// row. IN_TILE: the bf16 row is already in the tile (normalized in place);
// else it is row `row` of x in device memory (zeros past M).
template <typename T, bool IN_TILE>
__device__ __forceinline__ void ln_row_to_tile(const T* __restrict__ x,
                                               const float* __restrict__ scale,
                                               const float* __restrict__ bias, uint8_t* a,
                                               int rows, int lr, int row, int M, int D, float eps,
                                               int lane) {
  constexpr int EPC = 16 / sizeof(T);         // elements per 16-byte chunk
  constexpr int CPL = LN_MAX_PER_LANE / EPC;  // chunks per lane, at most
  const int chunks = D / EPC;
  auto at = [&](int c) { return a + (c >> 6) * rows * 128 + sw128(lr, c & 63); };
  if (!IN_TILE && row >= M) {
    for (int ch = lane; ch < chunks; ch += 32) {
      if constexpr (EPC == 8)
        *reinterpret_cast<uint4*>(at(ch * EPC)) = make_uint4(0u, 0u, 0u, 0u);
      else
        *reinterpret_cast<uint2*>(at(ch * EPC)) = make_uint2(0u, 0u);
    }
    return;
  }
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  float v[CPL][EPC];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      unpack16(IN_TILE ? *reinterpret_cast<const uint4*>(at(ch * EPC)) : xr[ch], v[i], x);
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
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int ch = lane + 32 * i;
    if (ch < chunks) {
      const int c = ch * EPC;
      uint32_t p[EPC / 2];
#pragma unroll
      for (int e = 0; e < EPC; e += 2)
        p[e / 2] = pack_f32((v[i][e] - mean) * rstd * scale[c + e] + bias[c + e],
                            (v[i][e + 1] - mean) * rstd * scale[c + e + 1] + bias[c + e + 1]);
      if constexpr (EPC == 8)
        *reinterpret_cast<uint4*>(at(c)) = make_uint4(p[0], p[1], p[2], p[3]);
      else
        *reinterpret_cast<uint2*>(at(c)) = make_uint2(p[0], p[1]);
    }
  }
}

// gelu' with its divisions taken as __fdividef, as gelu_fwd takes them
template <int FAST>
__device__ __forceinline__ float gelu_grad_fdiv(float m) {
  if constexpr (FAST) {
    const float xc = fminf(fmaxf(m, -4.6f), 4.6f);
    const float s = xc * xc;
    float p = 1.8219220945499694e-06f;
    p = -1.2033074181130153e-05f + s * p;
    p = 0.013759530274157408f + s * p;
    p = -0.03544238930343691f + s * p;
    p = 0.7981352003862573f + s * p;
    float q = 0.003771008302941207f;
    q = 0.036972201734621915f + s * q;
    q = 0.2904124253896315f + s * q;
    q = 1.0f + s * q;
    return 0.5f + xc * __fdividef(p, q);
  }
  const float x = m * 0.7071067811865476f;
  const float sign = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, 1.0f + 0.3275911f * ax);
  const float poly = t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f +
                     t * (-1.453152027f + t * 1.061405429f))));
  const float e = expf(-ax * ax);  // exp(-m^2 / 2)
  return 0.5f * (1.0f + sign * (1.0f - poly * e)) + m * e * 0.3989422804014327f;
}

// EPI_GELU2 from this warp's 16 rows of a 64 x NT fragment (register i: row
// lr + 8 ((i / 2) % 2) of the warpgroup's 64, column 8 (i / 4) + 2 t4 + i % 2)
// at column c0 of N: m = bf16(acc + b1), g = bf16(gelu(m)) and gg =
// bf16(gelu'(m)) into the staged tiles gt and ggt (NT / 64 swizzled boxes)
template <int NT, int FAST>
__device__ __forceinline__ void epi_gelu2(const float* acc, const bf16* __restrict__ bias,
                                          uint8_t* gt, uint8_t* ggt, int lr, int c0, int t4) {
#pragma unroll
  for (int i = 0; i < NT / 2; i += 2) {
    const int c = 8 * (i >> 2) + 2 * t4;
    const float2 bb = load2(bias + c0 + c);
    const float m0 = bf16_round(acc[i] + bb.x), m1 = bf16_round(acc[i + 1] + bb.y);
    const uint32_t off = (c >> 6) * TMA_BOX_BYTES + sw128(lr + 8 * ((i >> 1) & 1), c & 63);
    *reinterpret_cast<uint32_t*>(gt + off) = pack_f32(gelu_fwd<FAST>(m0), gelu_fwd<FAST>(m1));
    *reinterpret_cast<uint32_t*>(ggt + off) =
        pack_f32(gelu_grad_fdiv<FAST>(m0), gelu_grad_fdiv<FAST>(m1));
  }
}

// EPI_LNBWD: the LayerNorm backward of whole rows (N = NT = D) from dy = the
// 64 x D fragment, as _ln_bwd with the residual add:
//
//   xhat = (x - mean) * rstd                 fp32 statistics of the bf16 x rows
//   dxhat = dy * scale
//   out = bf16(resid + rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)))
//
// A row's D values lie on the four lanes of a quad. The column sums of dy *
// xhat and dy over the warp's 16 rows go to partial[part][0 .. 2 D) (part =
// the warp's index in the grid) for a fixed-order reduction.
template <int D>
__device__ __forceinline__ void epi_ln_bwd(const float* acc, const bf16* __restrict__ x,
                                           const float* __restrict__ scale, const EpiArgs& ep,
                                           int r0, int lane, int part, int M, float eps) {
  const int t4 = lane & 3;
  // register pair i / 2 of row r0 + 8 hs: x at its two columns (rows past M
  // read as zeros), read from L1 again in each pass rather than held
  auto xv = [&](int i) {
    const int gr = r0 + 8 * ((i >> 1) & 1), gc = 8 * (i >> 2) + 2 * t4;
    return gr < M ? bf2_to_f2(ld_b32(x + (size_t)gr * D + gc)) : make_float2(0.0f, 0.0f);
  };
  float s[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const float2 v = xv(i);
    s[(i >> 1) & 1] += v.x + v.y;
  }
  float mean[2], rstd[2], var[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) mean[hs] = quad_sum(s[hs]) / (float)D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hs = (i >> 1) & 1;
    const float2 v = xv(i);
    const float d0 = v.x - mean[hs], d1 = v.y - mean[hs];
    var[hs] += d0 * d0 + d1 * d1;
  }
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) rstd[hs] = rsqrtf(quad_sum(var[hs]) / (float)D + eps);
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int hs = (i >> 1) & 1, gc = 8 * (i >> 2) + 2 * t4;
    const float2 v = xv(i);
    const float2 sc = *reinterpret_cast<const float2*>(scale + gc);
    const float h0 = (v.x - mean[hs]) * rstd[hs], h1 = (v.y - mean[hs]) * rstd[hs];
    const float e0 = acc[i] * sc.x, e1 = acc[i + 1] * sc.y;
    s1[hs] += e0 + e1;
    s2[hs] += e0 * h0 + e1 * h1;
  }
  float m1[2], m2[2];
#pragma unroll
  for (int hs = 0; hs < 2; ++hs) {
    m1[hs] = quad_sum(s1[hs]) / (float)D;
    m2[hs] = quad_sum(s2[hs]) / (float)D;
  }
  float* pr = ep.f32 + (size_t)part * 2 * D;
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {  // columns gc, gc + 1 of rows r0 and r0 + 8
    const int gc = 8 * (i >> 2) + 2 * t4;
    const float2 sc = *reinterpret_cast<const float2*>(scale + gc);
    float gs[2] = {0.0f, 0.0f}, gb[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hs = 0; hs < 2; ++hs) {
      const int j = i + 2 * hs, gr = r0 + 8 * hs;
      const float2 v = xv(j);
      const float h0 = (v.x - mean[hs]) * rstd[hs], h1 = (v.y - mean[hs]) * rstd[hs];
      gs[0] += acc[j] * h0;
      gs[1] += acc[j + 1] * h1;
      gb[0] += acc[j];
      gb[1] += acc[j + 1];
      if (gr < M) {
        const size_t idx = (size_t)gr * D + gc;
        const float2 r = load2(ep.resid + idx);
        const float d0 = rstd[hs] * (acc[j] * sc.x - m1[hs] - h0 * m2[hs]);
        const float d1 = rstd[hs] * (acc[j + 1] * sc.y - m1[hs] - h1 * m2[hs]);
        store2(ep.out + idx, r.x + d0, r.y + d1);
      }
    }
    // over the warp's 8 row pairs: lanes 4 g + t4, g = 0 .. 7, in a fixed order
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        gs[e] += __shfl_xor_sync(0xffffffffu, gs[e], o);
        gb[e] += __shfl_xor_sync(0xffffffffu, gb[e], o);
      }
    if (lane < 4) {
      *reinterpret_cast<float2*>(pr + gc) = make_float2(gs[0], gs[1]);
      *reinterpret_cast<float2*>(pr + D + gc) = make_float2(gb[0], gb[1]);
    }
  }
}

// Block: WG consumer warpgroups (64 rows each) and one producer warp.
// `layer` selects the matrix of a stacked weight map; `amap` is x's map
// (A_LN_BF16) or A's (A_TMA); `omap` the output's where it leaves by TMA
// stores (EPI_BIAS; EPI_GELU2: g, with gg through `o2map`; EPI_DM1: dm1,
// read as gg through `o2map`, the same matrix). STORE_A (A_LN_BF16): the
// normalized tile also goes out through `ymap` (the recompute's y for a
// weight gradient). EPI_LNBWD (A_TMA, N = NT): x and ln_scale are the
// LayerNorm's input and scale; ep.resid the residual, ep.out the result,
// ep.f32 the per-warp partials (gridDim.x * WG * 4 parts).
template <int WG, int NT, int ASRC, int EPI, int TB = 1, bool STORE_A = false>
__global__ void __launch_bounds__(WG * 128 + 32, 1)
rowblock_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap omap,
                     const __grid_constant__ CUtensorMap o2map,
                     const __grid_constant__ CUtensorMap ymap, const void* __restrict__ x,
                     const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                     int layer, int M, int N, int K, float eps, EpiArgs ep) {
  using T = typename std::conditional<ASRC == A_LN_F32, float, bf16>::type;
  constexpr int ROWS = WG * 64;
  constexpr int STAGE = rb_stage_bytes<WG, NT, ASRC>();
  constexpr int B_OFF = ASRC == A_TMA ? WG * TMA_BOX_BYTES : 0;
  constexpr int RING = rb_ring<EPI>();
  constexpr int OBOX = (NT / 64) * TMA_BOX_BYTES;  // one warpgroup's staged output tile
  __shared__ uint64_t full[RING], empty[RING], a_full, aux_full[WG], aux_empty[WG];
  extern __shared__ uint8_t raw[];
  uint8_t* tile = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);  // A (LN modes)
  uint8_t* otile = tile + (ASRC == A_TMA ? 0 : K * ROWS * 2);        // staged outputs
  Ring ring{full, empty, otile + rb_out_bytes<WG, NT, EPI>(), STAGE, RING, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * ROWS;
  const int kch = K / 64, ntiles = N / NT;
  if (tid == 0) {
    ring_init(full, empty, RING, WG * 4);
    mbar_init(&a_full, 1);
    for (int w = 0; w < WG; ++w) {
      mbar_init(&aux_full[w], 1);
      mbar_init(&aux_empty[w], 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG * 4) {  // producer: one lane issues every load
    if (lane == 0) {
      if (ASRC == A_LN_BF16) {  // the rows of x, into the tile as they are
        mbar_expect_tx(&a_full, kch * WG * TMA_BOX_BYTES);
        for (int kc = 0; kc < kch; ++kc)
          for (int w = 0; w < WG; ++w)
            tma_load(tile + kc * ROWS * 128 + w * TMA_BOX_BYTES, &amap, &a_full, kc * 64,
                     m0 + w * 64, 0);
      }
      for (int nt = 0; nt < ntiles; ++nt) {
        for (int kc = 0; kc < kch; ++kc) {
          uint64_t* bar;
          uint8_t* st = ring.fill(STAGE, &bar);
          if (ASRC == A_TMA)
            for (int w = 0; w < WG; ++w)
              tma_load(st + w * TMA_BOX_BYTES, &amap, bar, kc * 64, m0 + w * 64, 0);
          for (int j = 0; j < NT / 64; ++j) {
            if (TB)
              tma_load(st + B_OFF + j * TMA_BOX_BYTES, &bmap, bar, nt * NT + j * 64, kc * 64, layer);
            else
              tma_load(st + B_OFF + j * TMA_BOX_BYTES, &bmap, bar, kc * 64, nt * NT + j * 64, layer);
          }
        }
        // EPI_DM1: the tile's gg rows, once the previous tile's dm1 has left
        if (EPI == EPI_DM1)
          for (int w = 0; w < WG; ++w) {
            if (nt > 0) mbar_wait(&aux_empty[w], (nt - 1) & 1);
            mbar_expect_tx(&aux_full[w], OBOX);
            for (int j = 0; j < NT / 64; ++j)
              tma_load(otile + w * OBOX + j * TMA_BOX_BYTES, &o2map, &aux_full[w],
                       nt * NT + j * 64, m0 + w * 64, 0);
          }
      }
    }
    return;
  }

  const int w = warp >> 2, wl = warp & 3;  // warpgroup, warp in it
  if (ASRC != A_TMA) {
    if (ASRC == A_LN_BF16) mbar_wait(&a_full, 0);
    if (ASRC == A_LN_BF16 && K <= 256)
      ln_tile_rows(tile, ROWS, w * 64 + wl * 16, ln_scale, ln_bias, K, eps, lane);
    else
      for (int r = wl * 16; r < wl * 16 + 16; ++r)
        ln_row_to_tile<T, ASRC == A_LN_BF16>(static_cast<const T*>(x), ln_scale, ln_bias, tile,
                                             ROWS, w * 64 + r, m0 + w * 64 + r, M, K, eps, lane);
    fence_async_smem();
    named_sync(1 + w, 128);
    if (STORE_A && wl == 0 && lane == 0) {
      for (int kc = 0; kc < kch; ++kc)
        tma_store(&ymap, tile + kc * ROWS * 128 + w * TMA_BOX_BYTES, kc * 64, m0 + w * 64, 0);
      bulk_commit();
    }
  }
  float acc[NT / 2];
  const int r0 = m0 + w * 64 + wl * 16 + (lane >> 2);
  for (int nt = 0; nt < ntiles; ++nt) {
    int prev = -1;
    for (int kc = 0; kc < kch; ++kc) {
      const int s = ring.take();
      const uint8_t* st = ring.at(s);
      const uint8_t* a =
          ASRC == A_TMA ? st + w * TMA_BOX_BYTES : tile + kc * ROWS * 128 + w * TMA_BOX_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = TB ? b_desc(st + B_OFF + ks * 2048, TMA_BOX_BYTES)
                               : k_desc(st + B_OFF + ks * 32);
        Wgmma<NT>::template mma<0, 0, TB>(acc, a_desc(a + ks * 32), db, kc | ks);
      }
      wgmma_commit();
      fence_regs<NT / 2>(acc);
      if (prev >= 0) {  // the previous k-chunk's products are done with their stage
        wgmma_wait<1>();
        ring.release(prev, lane);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs<NT / 2>(acc);
    ring.release(prev, lane);
    if constexpr (EPI == EPI_BIAS) {
      // bf16(acc + bias) into this warpgroup's staged tile, once its last
      // TMA stores have read it, then out by TMA stores
      uint8_t* ot = otile + w * (NT / 64) * TMA_BOX_BYTES;
      const bool issuer = wl == 0 && lane == 0;
      if (issuer) bulk_wait_read();
      named_sync(1 + w, 128);
      const int lr = wl * 16 + (lane >> 2);
#pragma unroll
      for (int i = 0; i < NT / 2; i += 2) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3);
        const float2 bb = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ep.bias + nt * NT + c));
        *reinterpret_cast<uint32_t*>(ot + (c >> 6) * TMA_BOX_BYTES +
                                     sw128(lr + 8 * ((i >> 1) & 1), c & 63)) =
            pack_f32(acc[i] + bb.x, acc[i + 1] + bb.y);
      }
      fence_async_smem();
      named_sync(1 + w, 128);
      if (issuer) {
        for (int j = 0; j < NT / 64; ++j)
          tma_store(&omap, ot + j * TMA_BOX_BYTES, nt * NT + j * 64, m0 + w * 64, 0);
        bulk_commit();
      }
    } else if constexpr (EPI == EPI_GELU2) {
      // g and gg into this warpgroup's two staged tiles, once their last TMA
      // stores have read them, then out by TMA stores
      uint8_t* gt = otile + w * 2 * OBOX;
      const bool issuer = wl == 0 && lane == 0;
      if (issuer) bulk_wait_read();
      named_sync(1 + w, 128);
      const int lr = wl * 16 + (lane >> 2);
      if (ep.fast_gelu)
        epi_gelu2<NT, 1>(acc, ep.bias, gt, gt + OBOX, lr, nt * NT, lane & 3);
      else
        epi_gelu2<NT, 0>(acc, ep.bias, gt, gt + OBOX, lr, nt * NT, lane & 3);
      fence_async_smem();
      named_sync(1 + w, 128);
      if (issuer) {
        for (int j = 0; j < NT / 64; ++j) {
          tma_store(&omap, gt + j * TMA_BOX_BYTES, nt * NT + j * 64, m0 + w * 64, 0);
          tma_store(&o2map, gt + OBOX + j * TMA_BOX_BYTES, nt * NT + j * 64, m0 + w * 64, 0);
        }
        bulk_commit();
      }
    } else if constexpr (EPI == EPI_DM1) {
      // dm1 = bf16(bf16(acc) * gg) over gg in the staged tile, out by TMA
      // stores; the tile is free for the next gg once they have read it
      uint8_t* at = otile + w * OBOX;
      mbar_wait(&aux_full[w], nt & 1);
      const int lr = wl * 16 + (lane >> 2);
#pragma unroll
      for (int i = 0; i < NT / 2; i += 2) {
        const int c = 8 * (i >> 2) + 2 * (lane & 3);
        uint32_t* p = reinterpret_cast<uint32_t*>(at + (c >> 6) * TMA_BOX_BYTES +
                                                  sw128(lr + 8 * ((i >> 1) & 1), c & 63));
        const float2 f = bf2_to_f2(*p);
        *p = pack_f32(bf16_round(acc[i]) * f.x, bf16_round(acc[i + 1]) * f.y);
      }
      fence_async_smem();
      named_sync(1 + w, 128);
      if (wl == 0 && lane == 0) {
        for (int j = 0; j < NT / 64; ++j)
          tma_store(&omap, at + j * TMA_BOX_BYTES, nt * NT + j * 64, m0 + w * 64, 0);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(&aux_empty[w]);
      }
    } else if constexpr (EPI == EPI_LNBWD) {
      epi_ln_bwd<NT>(acc, static_cast<const bf16*>(x), ln_scale, ep, r0, lane,
                     (blockIdx.x * WG + w) * 4 + wl, M, eps);
    } else {
#pragma unroll
      for (int i = 0; i < NT / 2; i += 2) {
        const int gr = r0 + 8 * ((i >> 1) & 1);
        const int gc = nt * NT + 8 * (i >> 2) + 2 * (lane & 3);
        if (gr < M) epilogue_pair<EPI>(ep, M, N, gr, gc, acc[i], acc[i + 1]);
      }
    }
  }
  if ((EPI == EPI_BIAS || EPI == EPI_GELU2 || STORE_A) && wl == 0 && lane == 0) bulk_wait_read();
}

template <int WG, int NT, int ASRC, int EPI, int TB = 1, bool STORE_A = false>
static int launch_rowblock(const CUtensorMap& amap, const CUtensorMap& bmap,
                           const CUtensorMap& omap, const CUtensorMap& o2map,
                           const CUtensorMap& ymap, const void* x,
                           const float* ln_scale, const float* ln_bias, int layer, int M, int N,
                           int K, float eps, const EpiArgs& ep, cudaStream_t st) {
  if (N % NT || K % 64 || (EPI == EPI_LNBWD && N != NT)) return (int)cudaErrorInvalidValue;
  const int smem = rb_smem_bytes<WG, NT, ASRC, EPI>(K);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = rowblock_gemm_kernel<WG, NT, ASRC, EPI, TB, STORE_A>;
  LAUNCH((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  kernel<<<(M + WG * 64 - 1) / (WG * 64), WG * 128 + 32, smem, st>>>(
      amap, bmap, omap, o2map, ymap, x, ln_scale, ln_bias, layer, M, N, K, eps, ep);
  return (int)cudaGetLastError();
}

// the number of row blocks (and of EPI_LNBWD's partial sets, x WG * 4)
template <int WG>
static int rowblocks(int M) { return (M + WG * 64 - 1) / (WG * 64); }
