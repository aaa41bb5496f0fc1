// One ViT layer's whole backward for Hopper (sm_90a), bf16 or fp32 in and
// out: the MLP half, then the attention half, in one C entry point.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_merged_bwd_kernel (run by
// _layer_bwd with merged=True for every layer of _backbone_vjp_bwd when
// VIT2SPN_MERGED_BWD=1), the Pallas TPU kernel that runs _mlp_bwd_math and
// then _attn_bwd_math in one body, dx2 handed from the first to the second in
// the compute dtype (as the split path hands it through HBM), so its numerics
// are the split kernels' (csrc/mlp_bwd.cu then csrc/attn_bwd.cu):
//
//   (x, x2, dout, the layer's weights) -> (dx, 12 fp32 weight gradients)
//
// What the TPU body bought was one launch per layer instead of two, with dx2
// kept in VMEM. On this card the split path is the MLP half's 10 launches
// and the attention half's 11; what bounds both is operations (69.08 GFLOP
// per layer at ViT-Tiny, B = 128: 37.18 for the MLP half, 31.90 for the
// attention half), so the merge removes launches and passes that move only a
// few bytes, and keeps every product as it is:
//
//   * the two recompute LayerNorms (LN2 of x2, LN1 of x) are one launch;
//   * the six fixed-order reductions of split partials (dW2/db2, dW1/db1,
//     the LN2 parameters, dWo/dbo, dWqkv/dbqkv, the LN1 parameters) are one
//     launch at the end, each partial set in its own workspace. Each sum
//     runs in the order the split kernels' reductions take, so the weight
//     gradients are theirs bit for bit, and two runs give the same bits.
//
// dx2 still crosses in bf16 through device memory (M x D x 2 bytes, 9.7 MB at
// B = 128): a GEMM that reads it is the next launch either way. Fifteen
// launches on the caller's stream:
//
//   1. layernorm_pair_kernel                y2 = LN2(x2), y1 = LN1(x)
//   2. gemm NN, EPI_GELU2                   g, gg
//   3. gemm NT, EPI_DM1                     dm1 (written over gg)
//   4. gemm TN split                        dW2, db2 partials
//   5. gemm TN split                        dW1, db1 partials
//   6. gemm NT, EPI_F32                     dy2 = dm1 W1^T, fp32
//   7. ln_bwd_kernel                        dx2, LN2 partials
//   8. gemm NN, EPI_BIAS                    qkv
//   9. gemm NT, EPI_STORE                   datt = dx2 Wo^T
//  10. attention_bwd_kernel                 att, dqkv
//  11. gemm TN split                        dWo, dbo partials
//  12. gemm TN split                        dWqkv, dbqkv partials
//  13. gemm NT, EPI_F32                     dy1 = dqkv Wqkv^T, fp32
//  14. ln_bwd_kernel                        dx, LN1 partials
//  15. reduce_all_kernel                    the 12 weight gradients
//
// The split kernels' bf16 route at D <= 256 is the wgmma row-block kit
// (csrc/mlp_bwd.cuh, csrc/attn_bwd.cuh), which sums in other orders than
// these mma.sync GEMMs: the merged kernel's bits are no longer theirs, but
// the same function within the same tolerances.
//
// fp32 (compute_dtype=float32): the split kernels' fp32 sequences in a row
// (mlp_bwd_seq<float>, attn_bwd_seq<float>: 23 launches), dx2 crossing in
// fp32.
//
// Limits: head_dim 64, S <= 256, D <= 768, D and mlp multiples of 64,
// activations and matmul weights all bf16 or all fp32, fp32 LN parameters.

#include "attn_bwd.cuh"
#include "mlp_bwd.cuh"

#define MERGED_BWD_LAUNCHES 15

// the six partial sets, in the order they sit in the workspace
static void partial_sizes(int M, int D, int MLP, size_t out[6]) {
  out[0] = wgrad_workspace_floats(MLP, D, M);    // dW2, db2
  out[1] = wgrad_workspace_floats(D, MLP, M);    // dW1, db1
  out[2] = (size_t)lnb_blocks(M) * 2 * D;        // LN2
  out[3] = wgrad_workspace_floats(D, D, M);      // dWo, dbo
  out[4] = wgrad_workspace_floats(D, 3 * D, M);  // dWqkv, dbqkv
  out[5] = (size_t)lnb_blocks(M) * 2 * D;        // LN1
}

// fp32 scratch the wrapper allocates for the split partials
extern "C" long long vit2spn_merged_bwd_workspace_floats(int B, int S, int D, int H, int MLP,
                                                         int fp32) {
  const int M = B * S;
  if (fp32) {
    const size_t m = mlp_seq_workspace(M, D, MLP), a = attn_seq_workspace(B, S, D, H);
    return (long long)(m > a ? m : a);
  }
  size_t sz[6], w = 0;
  partial_sizes(M, D, MLP, sz);
  for (int i = 0; i < 6; ++i) w += sz[i];
  return (long long)w;
}

extern "C" int vit2spn_merged_bwd_launches(int fp32) {
  return fp32 ? MLP_SEQ_LAUNCHES + attn_seq_launches<float>() : MERGED_BWD_LAUNCHES;
}

// x, x2, dout, dx: (B * S, D), all bf16 or (fp32 set) all fp32, as the
// weights wqkv (D, 3D), bqkv (3D), wo (D, D), w1 (D, MLP), b1 (MLP), w2 (MLP,
// D); ln1 / ln2 scale and bias fp32 (D). Gradients fp32, in WEIGHT_NAMES
// order. Scratch in the activations' dtype: y1, y2, datt, att, dx2 (M, D),
// qkv and dqkv (M, 3D), g and gg (M, MLP); dy (M, D) fp32, ws
// (workspace_floats) fp32.
extern "C" int vit2spn_merged_bwd(
    const void* x, const void* x2, const void* dout,
    const void* ln1_scale, const void* ln1_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* ln2_scale, const void* ln2_bias, const void* w1,
    const void* b1, const void* w2,
    void* dx, void* gln1_scale, void* gln1_bias, void* gwqkv, void* gbqkv, void* gwo, void* gbo,
    void* gln2_scale, void* gln2_bias, void* gw1, void* gb1, void* gw2, void* gb2,
    void* y1_buf, void* y2_buf, void* qkv_buf, void* datt_buf, void* att_buf, void* dqkv_buf,
    void* g_buf, void* gg_buf, void* dx2_buf, void* dy_buf, void* ws_buf,
    int B, int S, int D, int H, int MLP, float eps, int fast_gelu, int fp32, void* stream) {
  if (B <= 0 || S <= 0 || S > AB_MAX_S || H <= 0 || D != H * DH || D > LN_MAX_D || D % 64 ||
      MLP <= 0 || MLP % 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  if (fp32) {
    const MlpBwdArgs m = {x2, dout, ln2_scale, ln2_bias, w1, b1, w2, dx2_buf, gln2_scale,
                          gln2_bias, gw1, gb1, gw2, gb2, y2_buf, g_buf, gg_buf, dy_buf, ws_buf,
                          M, D, MLP, eps, fast_gelu};
    LAUNCH(mlp_bwd_seq<float>(m, st));
    const AttnBwdArgs a = {x, dx2_buf, ln1_scale, ln1_bias, wqkv, bqkv, wo, dx, gln1_scale,
                           gln1_bias, gwqkv, gbqkv, gwo, gbo, y1_buf, qkv_buf, datt_buf, att_buf,
                           dqkv_buf, dy_buf, ws_buf, B, S, D, H, eps};
    return attn_bwd_seq<float>(a, st);
  }
  const bf16* X = static_cast<const bf16*>(x);
  const bf16* X2 = static_cast<const bf16*>(x2);
  const bf16* dO = static_cast<const bf16*>(dout);
  const bf16* W1 = static_cast<const bf16*>(w1);
  const bf16* W2 = static_cast<const bf16*>(w2);
  const bf16* Wqkv = static_cast<const bf16*>(wqkv);
  const float* l1s = static_cast<const float*>(ln1_scale);
  const float* l2s = static_cast<const float*>(ln2_scale);
  bf16* y1 = static_cast<bf16*>(y1_buf);
  bf16* y2 = static_cast<bf16*>(y2_buf);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* datt = static_cast<bf16*>(datt_buf);
  bf16* att = static_cast<bf16*>(att_buf);
  bf16* dqkv = static_cast<bf16*>(dqkv_buf);
  bf16* g = static_cast<bf16*>(g_buf);
  bf16* gg = static_cast<bf16*>(gg_buf);
  bf16* dm1 = gg;  // EPI_DM1 reads gg and writes dm1 at the same index
  bf16* dx2 = static_cast<bf16*>(dx2_buf);
  float* dy = static_cast<float*>(dy_buf);  // dy2, then dy1
  size_t sz[6];
  partial_sizes(M, D, MLP, sz);
  float* ws[6];
  ws[0] = static_cast<float*>(ws_buf);
  for (int i = 1; i < 6; ++i) ws[i] = ws[i - 1] + sz[i - 1];
  Reductions red = {};

  LAUNCH(launch_layernorm_pair(X2, l2s, static_cast<const float*>(ln2_bias), y2, X, l1s,
                               static_cast<const float*>(ln1_bias), y1, M, D, eps, st));

  // the MLP half: csrc/mlp_bwd.cu's launches 2-7, reductions deferred
  EpiArgs e1 = {};
  e1.bias = static_cast<const bf16*>(b1);
  e1.out = g;
  e1.out2 = gg;
  e1.fast_gelu = fast_gelu;
  LAUNCH((launch_gemm<bf16, false, false, EPI_GELU2>(y2, W1, M, MLP, D, e1, st)));
  EpiArgs e2 = {};
  e2.aux = gg;
  e2.out = dm1;
  LAUNCH((launch_gemm<bf16, false, true, EPI_DM1>(dO, W2, M, MLP, D, e2, st)));
  LAUNCH(launch_wgrad(g, dO, MLP, D, M, ws[0], static_cast<float*>(gw2),
                      static_cast<float*>(gb2), st, &red));
  LAUNCH(launch_wgrad(y2, dm1, D, MLP, M, ws[1], static_cast<float*>(gw1),
                      static_cast<float*>(gb1), st, &red));
  EpiArgs e3 = {};
  e3.f32 = dy;
  LAUNCH((launch_gemm<bf16, false, true, EPI_F32>(dm1, W1, M, D, MLP, e3, st)));
  LAUNCH(launch_ln_bwd(X2, dy, dO, l2s, dx2, ws[2], static_cast<float*>(gln2_scale),
                       static_cast<float*>(gln2_bias), M, D, eps, st, &red));

  // the attention half: csrc/attn_bwd.cu's launches 2-8, reductions deferred
  EpiArgs e4 = {};
  e4.bias = static_cast<const bf16*>(bqkv);
  e4.out = qkv;
  LAUNCH((launch_gemm<bf16, false, false, EPI_BIAS>(y1, Wqkv, M, 3 * D, D, e4, st)));
  EpiArgs e5 = {};
  e5.out = datt;
  LAUNCH((launch_gemm<bf16, false, true, EPI_STORE>(dx2, static_cast<const bf16*>(wo), M, D, D, e5,
                                              st)));
  LAUNCH(launch_attention_bwd(qkv, datt, att, dqkv, B, S, H, D, st));
  LAUNCH(launch_wgrad(att, dx2, D, D, M, ws[3], static_cast<float*>(gwo),
                      static_cast<float*>(gbo), st, &red));
  LAUNCH(launch_wgrad(y1, dqkv, D, 3 * D, M, ws[4], static_cast<float*>(gwqkv),
                      static_cast<float*>(gbqkv), st, &red));
  EpiArgs e6 = {};
  e6.f32 = dy;
  LAUNCH((launch_gemm<bf16, false, true, EPI_F32>(dqkv, Wqkv, M, D, 3 * D, e6, st)));
  LAUNCH(launch_ln_bwd(X, dy, dx2, l1s, static_cast<bf16*>(dx), ws[5],
                       static_cast<float*>(gln1_scale), static_cast<float*>(gln1_bias), M, D,
                       eps, st, &red));

  return launch_reduce_all(red, st);
}
