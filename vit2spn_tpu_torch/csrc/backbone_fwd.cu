// Whole-backbone ViT forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_backbone_fwd_kernel (reached
// through _backbone_fwd_impl and fused_backbone), the Pallas TPU kernel that
// runs all L pre-LN blocks over a tile of images with the activation tile
// resident in VMEM. Per layer it computes what _block_fwd_math computes,
// through the layer code of csrc/layer_fwd.cuh (which csrc/layer_fwd.cu runs
// for a single layer):
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

#include "layer_fwd.cuh"

// ---------------------------------------------------------------------------
// Host entry: the layer loop, seven launches per layer on the caller's stream
// ---------------------------------------------------------------------------

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
  if (L <= 0 || !layer_shape_ok(B, S, D, H, MLP)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t M = (size_t)B * S;
  const void* w[12] = {ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2};
  bf16* o = static_cast<bf16*>(out);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  LAUNCH(zero_qkv_pad(qkv, (int)M, D, st));
  for (int l = 0; l < L; ++l) {
    // layer 0 reads the caller's input; later layers update `out` in place
    const bf16* cur = (l == 0) ? static_cast<const bf16*>(x) : o;
    LAUNCH(launch_layer(cur, o, xs ? static_cast<bf16*>(xs) + l * M * D : nullptr,
                        x2s ? static_cast<bf16*>(x2s) + l * M * D : nullptr,
                        layer_weights(w, l, D, MLP), qkv, static_cast<bf16*>(att_buf),
                        static_cast<float*>(x2_buf), static_cast<bf16*>(g_buf), B, S, D, H,
                        MLP, eps, fast_gelu, st));
  }
  return (int)cudaSuccess;
}

extern "C" int vit2spn_backbone_fwd_qkv_pad_rows() { return QKV_PAD_ROWS; }

extern "C" int vit2spn_backbone_fwd_launches_per_layer() { return LAUNCHES_PER_LAYER; }
