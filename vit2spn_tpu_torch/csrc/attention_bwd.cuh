// The attention core of one ViT layer's backward for Hopper (sm_90a), shared
// by csrc/attn_bwd.cu and csrc/merged_bwd.cu: from qkv and datt = dO, one
// block per (image, head) recomputes P and emits the attention output att
// and dqkv, as _attention and _attention_bwd (vit2spn_tpu/ops/fused_block.py)
// compute them:
//
//   P    = softmax(q k^T / sqrt(dh)), fp32; att = bf16(bf16(P) v)
//   dV   = bf16(P)^T datt;  dP = datt v^T
//   dS   = bf16(P * (dP - rowsum(dP * P)))     the row sum over all keys
//   dQ   = dS k / sqrt(dh);  dK = dS^T q / sqrt(dh);  dqkv = bf16(dQ|dK|dV)
//
// One block per (image, head) stages all of its Q, K, V and dO rows in
// shared memory (4 x 208 x 72 bf16 = 120 KB at S = 197). Phase 1: each warp
// takes 16 queries and computes their scores against every key once, into
// registers (the kernel is instantiated per S rounded up to 16), then the
// softmax statistics (row max, then the sum, as _attention) and P in place;
// dP = dO V^T one 16-key chunk at a time for rowsum(dP * P) and the attention
// output, then again for dS and dQ; it leaves the row statistics in shared
// memory. Phase 2: each warp takes 16 keys and walks every query: it
// recomputes P^T and dP^T for its keys, and accumulates dV and dK for them
// in registers. Every sum over queries of a key's gradient stays inside one
// warp, so nothing is added across blocks or by atomics and two runs give
// the same bits. Keys >= S get probability exactly 0 and queries >= S are
// masked out of dK and dV (the Pallas kernel's -1e30 key mask and qmask);
// pad rows are never written.
//
// What bounds it: the tensor-core issue rate of one block of AB_WARPS warps
// per SM (its shared memory admits one): 6 products of 2 S^2 64 per (image,
// head) that the function needs, plus the recomputed scores (once in phase
// 1, once in phase 2) and dP (twice in phase 1, once in phase 2). Holding
// the scores in registers took phase 1 from four score passes to one (the
// same sums in the same order, so the same bits).

#pragma once

#include "common.cuh"

#define DH 64
#ifndef AB_WARPS
// warps per (image, head) block: 16 queries, then 16 keys, each. 16 warps
// (128 registers, some spills) beat 8 (255 registers): 0.166 against 0.203
// ms at ViT-Tiny B=128 (tools/bwd_tile_sweep.py, PERF.md)
#define AB_WARPS 16
#endif
#define AB_LD TILE_LD  // bf16 elements per staged row (the tile helpers' stride)
#define AB_MAX_S 256

static size_t attention_bwd_smem(int S) {
  const int sp = (S + 15) / 16 * 16;
  return (size_t)4 * sp * AB_LD * sizeof(bf16) + (size_t)3 * sp * sizeof(float);
}

// NT = SP / 8 key tiles: the kernel is instantiated per tile count so that a
// warp's 16 x SP scores, then probabilities, stay in registers through phase
// 1 (4 NT per lane), as the forward's attention_kernel keeps them.
template <int NT>
__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                     bf16* __restrict__ att, bf16* __restrict__ dqkv, int S, int D,
                     float scale) {
  constexpr int SP = 8 * NT;
  extern __shared__ __align__(128) bf16 sm[];
  bf16* Qs = sm;
  bf16* Ks = Qs + SP * AB_LD;
  bf16* Vs = Ks + SP * AB_LD;
  bf16* Os = Vs + SP * AB_LD;  // dO = datt
  float* rmax = reinterpret_cast<float*>(Os + SP * AB_LD);
  float* rsum = rmax + SP;
  float* rdot = rsum + SP;  // rowsum(dP * P)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ld = 3 * D;
  const bf16* img = qkv + (size_t)b * S * ld + h * DH;
  const bf16* dimg = datt + (size_t)b * S * D + h * DH;

  for (int i = threadIdx.x; i < SP * (DH / 8); i += blockDim.x) {
    const int r = i / (DH / 8);
    const int c8 = (i % (DH / 8)) * 8;
    uint4 q = make_uint4(0u, 0u, 0u, 0u), k = q, v = q, o = q;
    if (r < S) {
      const bf16* row = img + (size_t)r * ld + c8;
      q = *reinterpret_cast<const uint4*>(row);
      k = *reinterpret_cast<const uint4*>(row + D);
      v = *reinterpret_cast<const uint4*>(row + 2 * D);
      o = *reinterpret_cast<const uint4*>(dimg + (size_t)r * D + c8);
    }
    *reinterpret_cast<uint4*>(&Qs[r * AB_LD + c8]) = q;
    *reinterpret_cast<uint4*>(&Ks[r * AB_LD + c8]) = k;
    *reinterpret_cast<uint4*>(&Vs[r * AB_LD + c8]) = v;
    *reinterpret_cast<uint4*>(&Os[r * AB_LD + c8]) = o;
  }
  __syncthreads();

  // ---- phase 1: 16 queries per warp ----------------------------------------
  for (int q0 = warp * 16; q0 < SP; q0 += AB_WARPS * 16) {
    uint32_t qa[4][4], oa[4][4];
    load_a_rows(qa, Qs + (size_t)q0 * AB_LD, lane);
    load_a_rows(oa, Os + (size_t)q0 * AB_LD, lane);
    // P of rows g and g + 8 against every key tile j, in registers: scaled
    // scores (keys >= S at -1e30), the row max over the 4 lanes of a row
    // group, exp(s - max), their sum, then the division
    float p[NT][4];
    float mx[2] = {-3.0e38f, -3.0e38f}, den[2] = {0.0f, 0.0f}, dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mma_rows_t(p[j], qa, Ks + (size_t)8 * j * AB_LD, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = (8 * j + 2 * t + (e & 1) < S) ? p[j][e] * scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], p[j][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) den[e >> 1] += expf(p[j][e] - mx[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
      den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = expf(p[j][e] - mx[e >> 1]) / den[e >> 1];
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    // rowsum(dP * P) with dP = dO V^T, and att = bf16(P) V, 16 keys at a time
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float dp[4];
        mma_rows_t(dp, oa, Vs + (size_t)8 * (2 * i + hh) * AB_LD, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[e >> 1] += dp[e] * p[2 * i + hh][e];
      }
      uint32_t pa[4];
      pack_a(pa, p[2 * i], p[2 * i + 1]);
      mma_rows(acc, pa, Vs + (size_t)16 * i * AB_LD, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
    }
    store_rows(att + (size_t)b * S * D + h * DH, D, acc, 1.0f, q0, S, lane);
    // dS = bf16(P * (dP - rowsum)), dP recomputed; dQ = dS K
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      float ds[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mma_rows_t(ds[hh], oa, Vs + (size_t)8 * (2 * i + hh) * AB_LD, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[hh][e] = p[2 * i + hh][e] * (ds[hh][e] - dot[e >> 1]);
      }
      uint32_t da[4];
      pack_a(da, ds[0], ds[1]);
      mma_rows(acc, da, Ks + (size_t)16 * i * AB_LD, lane);
    }
    store_rows(dqkv + (size_t)b * S * ld + h * DH, ld, acc, scale, q0, S, lane);
    if (t == 0) {
      rmax[q0 + g] = mx[0];
      rmax[q0 + g + 8] = mx[1];
      rsum[q0 + g] = den[0];
      rsum[q0 + g + 8] = den[1];
      rdot[q0 + g] = dot[0];
      rdot[q0 + g + 8] = dot[1];
    }
  }
  __syncthreads();

  // ---- phase 2: 16 keys per warp, every query ---------------------------
  for (int k0 = warp * 16; k0 < SP; k0 += AB_WARPS * 16) {
    uint32_t ka[4][4], va[4][4];
    load_a_rows(ka, Ks + (size_t)k0 * AB_LD, lane);
    load_a_rows(va, Vs + (size_t)k0 * AB_LD, lane);
    float dk[8][4], dv[8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.0f;
    for (int i = 0; i < SP / 16; ++i) {
      // P^T and dS^T of keys k0.., queries 16 i + 8 hh.. (rows key, columns query)
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qj = 2 * i + hh;
        mma_rows_t(pt[hh], ka, Qs + (size_t)8 * qj * AB_LD, lane);
        mma_rows_t(dst[hh], va, Os + (size_t)8 * qj * AB_LD, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + g + 8 * (e >> 1);
          const int q = 8 * qj + 2 * t + (e & 1);
          const float p = (key < S && q < S)
                              ? expf(pt[hh][e] * scale - rmax[q]) / rsum[q] : 0.0f;
          pt[hh][e] = p;
          dst[hh][e] = p * (dst[hh][e] - rdot[q]);
        }
      }
      uint32_t pa[4], da[4];
      pack_a(pa, pt[0], pt[1]);
      pack_a(da, dst[0], dst[1]);
      mma_rows(dv, pa, Os + (size_t)16 * i * AB_LD, lane);
      mma_rows(dk, da, Qs + (size_t)16 * i * AB_LD, lane);
    }
    store_rows(dqkv + (size_t)b * S * ld + D + h * DH, ld, dk, scale, k0, S, lane);
    store_rows(dqkv + (size_t)b * S * ld + 2 * D + h * DH, ld, dv, 1.0f, k0, S, lane);
  }
}

static int launch_attention_bwd(const bf16* qkv, const bf16* datt, bf16* att, bf16* dqkv,
                                int B, int S, int H, int D, cudaStream_t st) {
  const size_t smem = attention_bwd_smem(S);
  const dim3 grid(H, B);
  const float scale = 1.0f / sqrtf((float)DH);
  switch ((S + 15) / 16 * 2) {
#define AB_CASE(nt)                                                                       \
  case nt:                                                                                \
    if (cudaFuncSetAttribute(attention_bwd_kernel<nt>,                                    \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))     \
      return (int)cudaGetLastError();                                                     \
    attention_bwd_kernel<nt><<<grid, AB_WARPS * 32, smem, st>>>(qkv, datt, att, dqkv, S, D, \
                                                                scale);                   \
    break;
    AB_CASE(2) AB_CASE(4) AB_CASE(6) AB_CASE(8) AB_CASE(10) AB_CASE(12) AB_CASE(14)
    AB_CASE(16) AB_CASE(18) AB_CASE(20) AB_CASE(22) AB_CASE(24) AB_CASE(26) AB_CASE(28)
    AB_CASE(30) AB_CASE(32)
#undef AB_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
