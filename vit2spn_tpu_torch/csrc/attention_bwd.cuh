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
// See csrc/attn_bwd.cu for the design.

#pragma once

#include "common.cuh"

#define DH 64
#define AB_WARPS 8
#define AB_LD TILE_LD  // bf16 elements per staged row (the tile helpers' stride)
#define AB_MAX_S 256

static size_t attention_bwd_smem(int S) {
  const int sp = (S + 15) / 16 * 16;
  return (size_t)4 * sp * AB_LD * sizeof(bf16) + (size_t)3 * sp * sizeof(float);
}

__global__ void __launch_bounds__(AB_WARPS * 32)
attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                     bf16* __restrict__ att, bf16* __restrict__ dqkv, int S, int D,
                     float scale) {
  const int SP = (S + 15) / 16 * 16;
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
    // scaled scores of key tile j (8 keys), keys >= S at -1e30
    auto scores = [&](float s[4], int j) {
      mma_rows_t(s, qa, Ks + (size_t)8 * j * AB_LD, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = (8 * j + 2 * t + (e & 1) < S) ? s[e] * scale : NEG_INF;
    };
    // rows g and g + 8: max, then the sum of exp(s - max), over the 4 lanes
    // of a row group
    float mx[2] = {-3.0e38f, -3.0e38f}, den[2] = {0.0f, 0.0f}, dot[2] = {0.0f, 0.0f};
    for (int j = 0; j < SP / 8; ++j) {
      float s[4];
      scores(s, j);
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[e]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    for (int j = 0; j < SP / 8; ++j) {
      float s[4];
      scores(s, j);
#pragma unroll
      for (int e = 0; e < 4; ++e) den[e >> 1] += expf(s[e] - mx[e >> 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
      den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
    }
    // P and dP = dO V^T of key tile j
    auto probs = [&](float p[4], float dp[4], int j) {
      scores(p, j);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(p[e] - mx[e >> 1]) / den[e >> 1];
      mma_rows_t(dp, oa, Vs + (size_t)8 * j * AB_LD, lane);
    };
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    // rowsum(dP * P) and att = bf16(P) V, 16 keys at a time
    for (int i = 0; i < SP / 16; ++i) {
      float p[2][4], dp[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        probs(p[hh], dp[hh], 2 * i + hh);
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[e >> 1] += dp[hh][e] * p[hh][e];
      }
      uint32_t pa[4];
      pack_a(pa, p[0], p[1]);
      mma_rows(acc, pa, Vs + (size_t)16 * i * AB_LD, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
    }
    store_rows(att + (size_t)b * S * D + h * DH, D, acc, 1.0f, q0, S, lane);
    // dS = bf16(P * (dP - rowsum)), dQ = dS K
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    for (int i = 0; i < SP / 16; ++i) {
      float p[2][4], dp[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        probs(p[hh], dp[hh], 2 * i + hh);
#pragma unroll
        for (int e = 0; e < 4; ++e) p[hh][e] *= dp[hh][e] - dot[e >> 1];
      }
      uint32_t da[4];
      pack_a(da, p[0], p[1]);
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
  cudaError_t e = cudaFuncSetAttribute(attention_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attention_bwd_kernel<<<dim3(H, B), AB_WARPS * 32, smem, st>>>(
      qkv, datt, att, dqkv, S, D, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

