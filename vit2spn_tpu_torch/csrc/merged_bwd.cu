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
// kept in VMEM. What bounds both halves on this card is operations (69.08
// GFLOP per layer at ViT-Tiny, B = 128: 37.18 for the MLP half, 31.90 for the
// attention half), so the merge keeps every product as the split halves run
// it and saves only launches. Every route runs the two halves' own code (not
// a copy), the MLP half first, so dx and the 12 weight gradients equal the
// split pair's bit for bit:
//
//   * bf16, D <= 256: the wgmma row-block kit stages (csrc/mlp_bwd.cuh
//     mlp_bwd_hopper, then csrc/attn_bwd.cuh attn_bwd_hopper), their six
//     fixed-order reductions deferred into one reduce_all launch at the
//     end, each half's partials in its own part of the workspace. Ten
//     launches:
//
//        1. LN2 + W1 + gelu / gelu'         g, gg (y2 kept for dW1)
//        2. dout W2^T * gg                  dm1 (written over gg)
//        3. dW2 and dW1                     split partials
//        4. dm1 W1^T + LN2 backward         dx2 (bf16), LN2 partials
//        5. LN1 + QKV                       qkv (y1 kept for dWqkv)
//        6. dx2 Wo^T                        datt
//        7. attention_bwd_kernel            att, dqkv
//        8. dWo and dWqkv                   split partials
//        9. dqkv Wqkv^T + LN1 backward      dx, LN1 partials
//       10. reduce_all_kernel               the 12 weight gradients
//
//   * bf16, D = 384, 768 and 1024: the halves' wide routes the same way
//     (the same functions of csrc/mlp_bwd.cuh and csrc/attn_bwd.cuh),
//     their six reductions in one reduce_all. Thirteen launches: the MLP
//     half's LN2, y2 W1 + gelu, dout W2^T * gg, dW2 and dW1, dm1 W1^T (fp32
//     dy2), ln_bwd_rows (dx2); the attention half's LN1 + QKV, dx2 Wo^T,
//     attention_bwd_kernel, dWo and dWqkv, dqkv Wqkv^T (fp32 dy1),
//     ln_bwd_rows (dx); reduce_all.
//
//   * bf16 at the other widths above D = 256, and fp32
//     (compute_dtype=float32): the split halves' sequences in a row
//     (mlp_bwd_seq<T>, attn_bwd_seq<T>: 21 launches in bf16, 23 in fp32),
//     each taking its reductions as it goes.
//
//   * bf16 at the general geometry (head_dim 16, 32, 48 or 80, or D or mlp not
//     a multiple of 64): each half's own route as the split pair takes it,
//     one after the other with its own reductions: the MLP half's kit (5
//     launches) where D and mlp allow it, else its sequence (10), then the
//     attention half's kit (6, or the wide route's 7) where head_dim is 64
//     and D allows it (mlp not a multiple of 64), else its sequence (11),
//     its core on the head_dim.
//
// dx2 crosses from the MLP half to the attention half through device memory
// in the compute dtype, as the split path hands it over.
//
// Limits: head_dim 16, 32, 48 or 64 at S <= 15,168 in bf16, 80 at S <=
// 13,696 (any in fp32); D a multiple of 32 up to 1280, mlp a multiple of 32,
// activations and matmul weights all bf16 or all fp32, fp32 LN parameters.

#include "attn_bwd.cuh"
#include "mlp_bwd.cuh"

#define MERGED_HOPPER_LAUNCHES (MLP_HOPPER_LAUNCHES + ATTN_HOPPER_LAUNCHES - 1)
#define MERGED_WIDE_LAUNCHES (MLP_WIDE_LAUNCHES + ATTN_WIDE_LAUNCHES - 1)

// fp32 scratch the wrapper allocates for the split partials
extern "C" long long vit2spn_merged_bwd_workspace_floats(int B, int S, int D, int H, int MLP,
                                                         int fp32) {
  MlpBwdArgs m = {};
  AttnBwdArgs a = {};
  m.M = B * S;
  m.D = a.D = D;
  m.MLP = MLP;
  a.B = B;
  a.S = S;
  a.H = H;
  if (H <= 0) return -1;
  if (!hopper_route(D, fp32, MLP, D / H)) {  // one half at a time
    long long wm = (long long)mlp_seq_workspace(m.M, D, MLP);
    if (hopper_route(D, fp32, MLP) && mlp_bwd_hopper(m, 0, true, &wm)) return -1;
    long long wa = (long long)attn_seq_workspace(B, S, D, H);
    if (hopper_route(D, fp32, 64, D / H) && attn_bwd_hopper(a, 0, true, &wa)) return -1;
    return wm > wa ? wm : wa;
  }
  long long nm = 0, na = 0;  // the two halves' kit workspaces side by side
  if (mlp_bwd_hopper(m, 0, true, &nm) || attn_bwd_hopper(a, 0, true, &na)) return -1;
  return nm + na;
}

// CUDA kernel launches one call makes
extern "C" int vit2spn_merged_bwd_launches(int D, int fp32, int H, int MLP) {
  if (H <= 0) return -1;
  if (hopper_route(D, fp32, MLP, D / H))
    return wide_route(D) ? MERGED_WIDE_LAUNCHES : MERGED_HOPPER_LAUNCHES;
  const int mlp = !hopper_route(D, fp32, MLP)  ? MLP_SEQ_LAUNCHES
                  : wide_route(D)              ? MLP_WIDE_LAUNCHES
                                               : MLP_HOPPER_LAUNCHES;
  const int attn = !hopper_route(D, fp32, 64, D / H) ? (fp32 ? attn_seq_launches<float>()
                                                             : attn_seq_launches<bf16>())
                   : wide_route(D)                   ? ATTN_WIDE_LAUNCHES
                                                     : ATTN_HOPPER_LAUNCHES;
  return mlp + attn;
}

// the halves one after the other, each on the route the split pair takes
// (csrc/mlp_bwd.cu and attn_bwd.cu choose them by the same hopper_route)
template <typename T>
static int merged_seq(const MlpBwdArgs& m, const AttnBwdArgs& a, int fp32, cudaStream_t st) {
  if (hopper_route(m.D, fp32, m.MLP))
    LAUNCH(mlp_bwd_hopper(m, st));
  else
    LAUNCH(mlp_bwd_seq<T>(m, st));
  if (hopper_route(a.D, fp32, 64, a.D / a.H)) return attn_bwd_hopper(a, st);
  return attn_bwd_seq<T>(a, st);
}

// x, x2, dout, dx: (B * S, D), all bf16 or (fp32 set) all fp32, as the
// weights wqkv (D, 3D), bqkv (3D), wo (D, D), w1 (D, MLP), b1 (MLP), w2 (MLP,
// D); ln1 / ln2 scale and bias fp32 (D). Gradients fp32, in WEIGHT_NAMES
// order. Scratch in the activations' dtype: y1, y2, datt, att, dx2 (M, D),
// qkv and dqkv (M, 3D), g and gg (M, MLP); dy (M, D) fp32 (null on the bf16
// route at D <= 256); ws (workspace_floats) fp32.
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
  if (!geometry_ok(B, S, D, H, MLP)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MlpBwdArgs m = {x2, dout, ln2_scale, ln2_bias, w1, b1, w2, dx2_buf, gln2_scale, gln2_bias,
                  gw1, gb1, gw2, gb2, y2_buf, g_buf, gg_buf, dy_buf, ws_buf, B * S, D, MLP, eps,
                  fast_gelu};
  AttnBwdArgs a = {x, dx2_buf, ln1_scale, ln1_bias, wqkv, bqkv, wo, dx, gln1_scale, gln1_bias,
                   gwqkv, gbqkv, gwo, gbo, y1_buf, qkv_buf, datt_buf, att_buf, dqkv_buf, dy_buf,
                   ws_buf, B, S, D, H, eps};
  if (!hopper_route(D, fp32, MLP, D / H))
    return fp32 ? merged_seq<float>(m, a, fp32, st) : merged_seq<bf16>(m, a, fp32, st);
  long long mlp_need = 0;  // the attention half's partials after the MLP half's
  LAUNCH(mlp_bwd_hopper(m, st, true, &mlp_need));
  a.ws = static_cast<float*>(ws_buf) + mlp_need;
  Reductions red = {};
  LAUNCH(mlp_bwd_hopper(m, st, false, nullptr, &red));
  LAUNCH(attn_bwd_hopper(a, st, false, nullptr, &red));
  return launch_reduce_all(red, st);
}
