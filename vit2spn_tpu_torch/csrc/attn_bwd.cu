// Attention half of one ViT layer's backward for Hopper (sm_90a), bf16 in /
// bf16 out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_attn_bwd_kernel (the Pallas TPU
// kernel run by _layer_bwd for every layer of _backbone_vjp_bwd, after
// _mlp_bwd_kernel), which recomputes LN1, QKV and attention from the layer
// input x and emits dx and the LN1 / attention weight gradients. Per layer it
// computes what _attn_bwd_math and _attention_bwd compute, over the
// M = B * S token rows:
//
//   y1   = bf16(LN1(x));  qkv = bf16(y1 @ Wqkv + bqkv)
//   P    = softmax(q k^T / sqrt(dh)), fp32; att = bf16(bf16(P) v)
//   dWo  = att^T dx2,  dbo = sum(dx2);  datt = bf16(dx2 @ Wo^T)
//   dV   = bf16(P)^T datt;  dP = datt v^T
//   dS   = bf16(P * (dP - rowsum(dP * P)))     the row sum over all keys
//   dQ   = dS k / sqrt(dh);  dK = dS^T q / sqrt(dh);  dqkv = bf16(dQ|dK|dV)
//   dWqkv = y1^T dqkv,  dbqkv = sum(dqkv)
//   dx   = bf16(dx2 + LN1_bwd(dqkv @ Wqkv^T)),  dln1_scale, dln1_bias
//
// What bounds it on this card: operations. The function needs three GEMMs of
// 2 S D 3D (the qkv recompute, dWqkv, dqkv Wqkv^T), two of 2 S D^2 (datt,
// dWo) and six attention products of 2 S^2 D (Q K^T, P V, dP, dV, dQ, dK):
// about 249 MFLOP per image per layer at ViT-Tiny, against a few bf16 (M, D)
// activations.
//
// The attention backward runs one block per (image, head) with all of its
// Q, K, V and dO rows staged in shared memory (4 x 208 x 72 bf16 = 120 KB at
// S = 197). Phase 1: each warp takes 16 queries, computes their softmax
// statistics (row max, then the sum, as _attention), then P and dP one
// 16-key chunk at a time for rowsum(dP * P) and the attention output, then
// again for dS and dQ; it leaves the row statistics in shared memory. Phase
// 2: each warp takes 16 keys and walks every query: it recomputes P^T and
// dP^T for its keys, and accumulates dV and dK for them in registers. Every
// sum over queries of a key's gradient stays inside one warp, so nothing is
// added across blocks or by atomics and two runs give the same bits. Keys
// >= S get probability exactly 0 and queries >= S are masked out of dK and
// dV (the Pallas kernel's -1e30 key mask and qmask); pad rows are never
// written. Scores are recomputed rather than stored: four Q K^T passes in
// phase 1, one in phase 2.
//
// The weight gradients split the token rows over blocks that write fp32
// partials added in a fixed order (common.cuh). Eleven launches on the
// caller's stream:
//
//   1. layernorm_kernel<bf16>              y1
//   2. gemm NN, EPI_BIAS                   qkv
//   3. gemm NT, EPI_STORE                  datt = dx2 Wo^T
//   4. attention_bwd_kernel                att, dqkv
//   5. gemm TN split + reduce              dWo, dbo
//   6. gemm TN split + reduce              dWqkv, dbqkv
//   7. gemm NT, EPI_F32                    dy1 = dqkv Wqkv^T, fp32
//   8. ln_bwd_kernel + reduce              dx, dln1_scale, dln1_bias
//
// Limits: head_dim 64, S <= 256, D <= 768, bf16 activations and matmul
// weights, fp32 LN parameters.

#include "common.cuh"

#define DH 64
#define AB_WARPS 8
#define AB_LD (DH + 8)  // bf16 elements per staged row
#define AB_MAX_S 256
#define ATTN_BWD_LAUNCHES 11

static size_t attention_bwd_smem(int S) {
  const int sp = (S + 15) / 16 * 16;
  return (size_t)4 * sp * AB_LD * sizeof(bf16) + (size_t)3 * sp * sizeof(float);
}

// c (16 x 8) = A (16 x 64, fragments a[4][4]) times the 8 staged rows at
// `rows` (64 columns each), transposed: each row is one column of the result
__device__ __forceinline__ void mma_rows_t(float c[4], const uint32_t a[4][4],
                                           const bf16* rows, int lane) {
  uint32_t kb[2][4];
  const bf16* p = rows + (size_t)(lane & 7) * AB_LD + (lane >> 3) * 8;
  ldmatrix_x4(kb[0], p);
  ldmatrix_x4(kb[1], p + 32);
  c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    mma_bf16(c, a[ks], kb[ks >> 1][(ks & 1) * 2], kb[ks >> 1][(ks & 1) * 2 + 1]);
}

// the 16 staged rows at `rows` (64 columns) as A operand fragments
__device__ __forceinline__ void load_a_rows(uint32_t a[4][4], const bf16* rows, int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(a[ks], rows + (size_t)(lane & 15) * AB_LD + ks * 16 + (lane >> 4) * 8);
}

// acc (16 x 64) += a (16 x 16) times the 16 staged rows at `rows` (64
// columns), read as the B operand [row][column]
__device__ __forceinline__ void mma_rows(float acc[8][4], const uint32_t a[4],
                                         const bf16* rows, int lane) {
  const bf16* p = rows + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * AB_LD + (lane >> 4) * 8;
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

// rows r and r + 8 of a 16 x 64 fp32 tile, times `mul`, as bf16 into `out`
// (row stride ld); rows >= S are not written
__device__ __forceinline__ void store_rows(bf16* out, size_t ld, const float acc[8][4],
                                           float mul, int r0, int S, int lane) {
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

// fp32 scratch the wrapper allocates for the split partials
extern "C" long long vit2spn_attn_bwd_workspace_floats(int M, int D) {
  size_t w = wgrad_workspace_floats(D, D, M);
  const size_t w1 = wgrad_workspace_floats(D, 3 * D, M);
  const size_t ln = (size_t)lnb_blocks(M) * 2 * D;
  if (w1 > w) w = w1;
  if (ln > w) w = ln;
  return (long long)w;
}

extern "C" int vit2spn_attn_bwd_launches() { return ATTN_BWD_LAUNCHES; }

// x, dx2, dx: (B * S, D) bf16. Gradients fp32: gwqkv (D, 3D), gbqkv (3D),
// gwo (D, D), gbo (D), gln1_scale, gln1_bias (D). Scratch: y1, datt, att
// (M, D) bf16, qkv and dqkv (M, 3D) bf16, dy (M, D) fp32, ws
// (workspace_floats) fp32.
extern "C" int vit2spn_attn_bwd(
    const void* x, const void* dx2, const void* ln1_scale, const void* ln1_bias,
    const void* wqkv, const void* bqkv, const void* wo,
    void* dx, void* gln1_scale, void* gln1_bias, void* gwqkv, void* gbqkv, void* gwo, void* gbo,
    void* y1_buf, void* qkv_buf, void* datt_buf, void* att_buf, void* dqkv_buf, void* dy_buf,
    void* ws_buf, int B, int S, int D, int H, float eps, void* stream) {
  if (B <= 0 || S <= 0 || S > AB_MAX_S || H <= 0 || D != H * DH || D > LN_MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* dX2 = static_cast<const bf16*>(dx2);
  bf16* y1 = static_cast<bf16*>(y1_buf);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* datt = static_cast<bf16*>(datt_buf);
  bf16* att = static_cast<bf16*>(att_buf);
  bf16* dqkv = static_cast<bf16*>(dqkv_buf);
  float* dy = static_cast<float*>(dy_buf);
  float* ws = static_cast<float*>(ws_buf);
  const bf16* Wqkv = static_cast<const bf16*>(wqkv);

  LAUNCH(launch_layernorm<bf16>(X, static_cast<const float*>(ln1_scale),
                                static_cast<const float*>(ln1_bias), y1, M, D, eps, st));
  EpiArgs e1 = {};
  e1.bias = static_cast<const bf16*>(bqkv);
  e1.out = qkv;
  LAUNCH((launch_gemm<false, false, EPI_BIAS>(y1, Wqkv, M, 3 * D, D, e1, st)));

  EpiArgs e2 = {};
  e2.out = datt;
  LAUNCH((launch_gemm<false, true, EPI_STORE>(dX2, static_cast<const bf16*>(wo), M, D, D,
                                              e2, st)));

  LAUNCH(launch_attention_bwd(qkv, datt, att, dqkv, B, S, H, D, st));

  LAUNCH(launch_wgrad(att, dX2, D, D, M, ws, static_cast<float*>(gwo),
                      static_cast<float*>(gbo), st));
  LAUNCH(launch_wgrad(y1, dqkv, D, 3 * D, M, ws, static_cast<float*>(gwqkv),
                      static_cast<float*>(gbqkv), st));

  EpiArgs e3 = {};
  e3.f32 = dy;
  LAUNCH((launch_gemm<false, true, EPI_F32>(dqkv, Wqkv, M, D, 3 * D, e3, st)));

  return launch_ln_bwd(X, dy, dX2, static_cast<const float*>(ln1_scale),
                       static_cast<bf16*>(dx), ws, static_cast<float*>(gln1_scale),
                       static_cast<float*>(gln1_bias), M, D, eps, st);
}
