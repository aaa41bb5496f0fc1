// Whole-backbone ViT forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_backbone_fwd_kernel (reached
// through _backbone_fwd_impl and fused_backbone), the Pallas TPU kernel that
// runs all L pre-LN blocks over a tile of images with the activation tile
// resident in VMEM. Per layer it computes what _block_fwd_math computes:
//
//   y1  = bf16(LN1(x))                      fp32 statistics, eps as given
//   qkv = bf16(y1 @ Wqkv + bqkv)            fp32 accumulation
//   att = bf16(concat_h(bf16(softmax(q k^T / sqrt(dh))) @ v))
//                                           fp32 scores, pad keys -1e30
//   x2  = x + att @ Wo + bo                 fp32, stays fp32 across stages
//   g   = bf16(gelu(bf16(LN2(x2)) @ W1 + b1))   exact A&S erf or fast rational
//   out = bf16(x2 + g @ W2 + b2)            the residual stream is bf16
//
// What bounds it on this card: operations. One layer over one image is
// 204 MFLOP of tensor-core work against ~0.15 MB of unavoidable residual
// traffic, far above the H100's ~295 bf16 FLOP per byte ridge. The TPU
// kernel keeps a 16-image tile (~40 MB) in VMEM for a whole layer; a Hopper
// block has 227 KB of shared memory, so the layer is cut into seven stages
// that pass bf16 (or, for x2, fp32) activations through L2 and device memory:
//
//   1. layernorm_kernel<bf16>             y1 = bf16(LN1(x))
//   2. gemm_kernel<EPI_BIAS>              QKV GEMM + bias
//   3. attention_kernel                   one warp per 16 queries of one
//                                         (image, head) on mma.sync: scores
//                                         in registers, two passes (max and
//                                         sum, then P.V); V staged in shared
//                                         memory per 4-warp block
//   4. gemm_kernel<EPI_RESID>             Wo GEMM + residual -> fp32 x2
//                                         (and the xs / x2s residual stacks)
//   5. layernorm_kernel<float>            y2 = bf16(LN2(x2))
//   6. gemm_kernel<EPI_GELU>              W1 GEMM + bias + gelu
//   7. gemm_kernel<EPI_OUT>               W2 GEMM + residual -> bf16 out
//
// The GEMMs run on the tensor cores through mma.sync m16n8k16 (bf16 inputs,
// fp32 accumulation): 128x64x32 block tiles, 4 warps of 64x32 fed by
// ldmatrix, a 3-stage cp.async pipeline, and bias / gelu / residual applied
// to the accumulator registers, so no fp32 GEMM output and no pre-gelu
// activation reaches device memory. LayerNorm is its own memory-bound pass,
// one warp per row, because normalizing inside each GEMM column block
// repeated it N / 64 times on a serial path (measured: the LN-prologue
// GEMMs ran at half the rate of the plain ones). Attention holds each
// warp's scores in registers and computes them twice rather than keep a
// score tile in shared memory, so many blocks share an SM (measured: a
// shared-memory score tile capped it at 16 warps per SM and ran 1.4x
// slower). This is the simple, correct first form: wgmma, TMA pipelines and
// a single persistent launch per backbone are later work.
//
// The sequence is not padded in device memory. Attention zero-fills V to a
// multiple of 16 rows in shared memory and gives keys >= S probability 0
// (the Pallas kernel's -1e30 mask); it reads Q and K in 16-row steps, for
// which the qkv buffer carries 16 zeroed rows past its end. Pad queries are
// never written, so nothing reaches the token mean. Limits: head_dim 64,
// S <= 256, D <= 768.

#include "common.cuh"

// ---------------------------------------------------------------------------
// Attention: one warp per 16 queries of one (image, head), four per block,
// on mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the scores in
// registers
// ---------------------------------------------------------------------------

#define DH 64
#define ATT_WARPS 4
#define QCHUNK (ATT_WARPS * 16)
#define ATT_MAX_S 256    // K and V of one (image, head) staged in <= 72 KB
#define VS_LD (DH + 8)  // bf16 elements per staged V row
// Q and K are read straight from the qkv buffer in 16-row steps, so the last
// image's last step reads up to 15 rows past it: the buffer carries this
// many zeroed rows after its M rows.
#define QKV_PAD_ROWS 16

// NT = SP / 8 key tiles: the kernel is instantiated per tile count so that
// the warp's 16 x SP scores stay in registers (4 * NT per lane).
template <int NT>
__global__ void __launch_bounds__(ATT_WARPS * 32)
attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ att, int S, int D,
                 float scale) {
  constexpr int SP = 8 * NT;
  extern __shared__ __align__(128) bf16 Ks[];  // K then V, SP x VS_LD each,
  bf16* Vs = Ks + SP * VS_LD;                  // rows >= S zeroed
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * QCHUNK + warp * 16;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ld = 3 * D;
  const bf16* img = qkv + (size_t)b * S * ld;

  for (int i = threadIdx.x; i < SP * (DH / 8); i += blockDim.x) {
    const int r = i / (DH / 8);
    const int c8 = (i % (DH / 8)) * 8;
    uint4 k = make_uint4(0u, 0u, 0u, 0u), v = k;
    if (r < S) {
      k = *reinterpret_cast<const uint4*>(img + (size_t)r * ld + D + h * DH + c8);
      v = *reinterpret_cast<const uint4*>(img + (size_t)r * ld + 2 * D + h * DH + c8);
    }
    *reinterpret_cast<uint4*>(&Ks[r * VS_LD + c8]) = k;
    *reinterpret_cast<uint4*>(&Vs[r * VS_LD + c8]) = v;
  }
  __syncthreads();
  if (q0 >= S) return;  // from here on every warp works alone

  // Q as the A operand: rows g and g + 8 of the warp's 16 queries
  uint32_t qa[DH / 16][4];
  const bf16* qg = img + (size_t)(q0 + g) * ld + h * DH + 2 * t;
  const bf16* qg8 = qg + (size_t)8 * ld;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    qa[ks][0] = ld_b32(qg + ks * 16);
    qa[ks][1] = ld_b32(qg8 + ks * 16);
    qa[ks][2] = ld_b32(qg + ks * 16 + 8);
    qa[ks][3] = ld_b32(qg8 + ks * 16 + 8);
  }
  // K rows as the B operand: ldmatrix of keys 8j..8j+7, dims 8m..8m+7 gives
  // lane 4g + t the pair K[8j + g][8m + 2t, +1], i.e. b0 / b1 of key step m / 2
  const bf16* klane = Ks + (size_t)(lane & 7) * VS_LD + (lane >> 3) * 8;

  // scores (fp32) * 1/sqrt(dh), keys >= S at -1e30; row max of rows g, g + 8
  float sc[NT][4];
  float mx[2] = {-3.0e38f, -3.0e38f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t kb[2][4];
    ldmatrix_x4(kb[0], klane + (size_t)8 * j * VS_LD);
    ldmatrix_x4(kb[1], klane + (size_t)8 * j * VS_LD + 32);
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      mma_bf16(sc[j], qa[ks], kb[ks >> 1][(ks & 1) * 2], kb[ks >> 1][(ks & 1) * 2 + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = (8 * j + 2 * t + (e & 1) < S) ? sc[j][e] * scale : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
  }
  // the 4 lanes of a row group share rows g and g + 8
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = expf(sc[j][e] - mx[e >> 1]);  // exactly 0 for masked keys
      sum[e >> 1] += sc[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  // out = bf16(p) V with p = exp(s - max) / sum: the score tiles 2i and
  // 2i + 1 are the A operand of key step i as they lie
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  const bf16* vlane = Vs + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * VS_LD +
                      (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const float* p0 = sc[2 * i];
    const float* p1 = sc[2 * i + 1];
    const uint32_t pa[4] = {pack_f32(p0[0] / sum[0], p0[1] / sum[0]),
                            pack_f32(p0[2] / sum[1], p0[3] / sum[1]),
                            pack_f32(p1[0] / sum[0], p1[1] / sum[0]),
                            pack_f32(p1[2] / sum[1], p1[3] / sum[1])};
    // V rows 16i..16i+15 as the B operand, two 8-dim column tiles per
    // ldmatrix (as the GEMM reads W)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vlane + (size_t)16 * i * VS_LD + np * 16);
      mma_bf16(o[2 * np], pa, vb[0], vb[1]);
      mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
    }
  }

  // rows g and g + 8, dims 8n + 2t and 8n + 2t + 1, as bf16 pairs
  bf16* out = att + ((size_t)b * S + q0 + g) * D + h * DH + 2 * t;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    if (q0 + g < S)
      *reinterpret_cast<uint32_t*>(out + n * 8) = pack_f32(o[n][0], o[n][1]);
    if (q0 + g + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (size_t)8 * D + n * 8) = pack_f32(o[n][2], o[n][3]);
  }
}

// Launch attention for S keys: the instantiation for SP = S rounded up to 16.
static int launch_attention(const bf16* qkv, bf16* att, int B, int S, int H, int D,
                            float scale, cudaStream_t st) {
  const int sp = (S + 15) / 16 * 16;
  const dim3 grid((S + QCHUNK - 1) / QCHUNK, H, B);
  const size_t smem = (size_t)2 * sp * VS_LD * sizeof(bf16);
  switch (sp / 8) {
#define ATT_CASE(nt)                                                                   \
  case nt:                                                                             \
    if (cudaFuncSetAttribute(attention_kernel<nt>,                                     \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))  \
      return (int)cudaGetLastError();                                                  \
    attention_kernel<nt><<<grid, ATT_WARPS * 32, smem, st>>>(qkv, att, S, D, scale); \
    break;
    ATT_CASE(2) ATT_CASE(4) ATT_CASE(6) ATT_CASE(8) ATT_CASE(10) ATT_CASE(12)
    ATT_CASE(14) ATT_CASE(16) ATT_CASE(18) ATT_CASE(20) ATT_CASE(22) ATT_CASE(24)
    ATT_CASE(26) ATT_CASE(28) ATT_CASE(30) ATT_CASE(32)
#undef ATT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host entry: the layer loop, seven launches per layer on the caller's stream
// ---------------------------------------------------------------------------

#define LAUNCHES_PER_LAYER 7

// qkv_buf holds (B * S + QKV_PAD_ROWS) rows of 3 * D; the pad rows are
// zeroed here on every call. att_buf (B * S rows of D) also carries each
// LayerNorm's output to the GEMM after it.
extern "C" int vit2spn_backbone_fwd(
    const void* x, void* out, void* xs, void* x2s,
    const void* ln1_scale, const void* ln1_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* ln2_scale, const void* ln2_bias,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* qkv_buf, void* att_buf, void* x2_buf, void* g_buf,
    int B, int S, int D, int H, int MLP, int L, float eps, int fast_gelu,
    void* stream) {
  if (B <= 0 || S <= 0 || S > ATT_MAX_S || L <= 0 || H <= 0 || D != H * DH ||
      D > LN_MAX_D || D % BN || MLP % BN || D % BK || MLP % BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const int D3 = 3 * D;
  const float scale = 1.0f / sqrtf((float)DH);

  const bf16* xin = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* att = static_cast<bf16*>(att_buf);
  bf16* y = att;  // LN outputs: consumed by the next GEMM before att is written
  float* x2 = static_cast<float*>(x2_buf);
  bf16* g = static_cast<bf16*>(g_buf);
  LAUNCH((int)cudaMemsetAsync(qkv + (size_t)M * D3, 0,
                              (size_t)QKV_PAD_ROWS * D3 * sizeof(bf16), st));

  for (int l = 0; l < L; ++l) {
    // layer 0 reads the caller's input; later layers update `out` in place
    // (the layer input is last read by the Wo epilogue, before W2 writes)
    const bf16* cur = (l == 0) ? xin : o;
    const float* l1s = static_cast<const float*>(ln1_scale) + (size_t)l * D;
    const float* l1b = static_cast<const float*>(ln1_bias) + (size_t)l * D;
    const float* l2s = static_cast<const float*>(ln2_scale) + (size_t)l * D;
    const float* l2b = static_cast<const float*>(ln2_bias) + (size_t)l * D;
    const bf16* Wqkv = static_cast<const bf16*>(wqkv) + (size_t)l * D * D3;
    const bf16* Wo = static_cast<const bf16*>(wo) + (size_t)l * D * D;
    const bf16* W1 = static_cast<const bf16*>(w1) + (size_t)l * D * MLP;
    const bf16* W2 = static_cast<const bf16*>(w2) + (size_t)l * MLP * D;

    LAUNCH(launch_layernorm<bf16>(cur, l1s, l1b, y, M, D, eps, st));
    EpiArgs e1 = {};
    e1.bias = static_cast<const bf16*>(bqkv) + (size_t)l * D3;
    e1.out = qkv;
    LAUNCH((launch_gemm<false, false, EPI_BIAS>(y, Wqkv, M, D3, D, e1, st)));

    LAUNCH(launch_attention(qkv, att, B, S, H, D, scale, st));

    EpiArgs e3 = {};
    e3.bias = static_cast<const bf16*>(bo) + (size_t)l * D;
    e3.f32 = x2;
    e3.resid = cur;
    e3.xs = xs ? static_cast<bf16*>(xs) + (size_t)l * M * D : nullptr;
    e3.x2s = x2s ? static_cast<bf16*>(x2s) + (size_t)l * M * D : nullptr;
    LAUNCH((launch_gemm<false, false, EPI_RESID>(att, Wo, M, D, D, e3, st)));

    LAUNCH(launch_layernorm<float>(x2, l2s, l2b, y, M, D, eps, st));
    EpiArgs e4 = {};
    e4.bias = static_cast<const bf16*>(b1) + (size_t)l * MLP;
    e4.out = g;
    e4.fast_gelu = fast_gelu;
    LAUNCH((launch_gemm<false, false, EPI_GELU>(y, W1, M, MLP, D, e4, st)));

    EpiArgs e5 = {};
    e5.bias = static_cast<const bf16*>(b2) + (size_t)l * D;
    e5.f32 = x2;
    e5.out = o;
    LAUNCH((launch_gemm<false, false, EPI_OUT>(g, W2, M, D, MLP, e5, st)));
  }
  return (int)cudaSuccess;
}

extern "C" int vit2spn_backbone_fwd_qkv_pad_rows() { return QKV_PAD_ROWS; }

extern "C" int vit2spn_backbone_fwd_launches_per_layer() { return LAUNCHES_PER_LAYER; }
