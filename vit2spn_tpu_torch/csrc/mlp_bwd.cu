// MLP half of one ViT layer's backward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_mlp_bwd_kernel (the Pallas TPU
// kernel run by _layer_bwd for every layer of _backbone_vjp_bwd), which
// recomputes LN2 and the MLP from the saved mid-residual x2 and emits dx2 and
// the LN2 / MLP weight gradients. Per layer it computes what _mlp_bwd_math
// computes, over the M = B * S token rows:
//
//   y2  = bf16(LN2(x2))                    fp32 statistics
//   m1  = bf16(y2 @ W1 + b1)               the recompute stores m1 in bf16
//   g   = bf16(gelu(m1)),  gg = bf16(gelu'(m1))      exact or fast form
//   dm1 = bf16(bf16(dout @ W2^T) * gg)
//   dW2 = g^T dout,   db2 = sum(dout)      fp32, over all M rows
//   dW1 = y2^T dm1,   db1 = sum(dm1)
//   dx2 = bf16(dout + LN2_bwd(dm1 @ W1^T)),  dln2_scale, dln2_bias
//
// What bounds it on this card: operations. Five GEMMs of 2 M D MLP each
// (the m1 recompute, dout W2^T, the two weight gradients, dm1 W1^T) against
// a few bf16 (M, MLP) intermediates: about 290 MFLOP per image per layer at
// ViT-Tiny, far above the ~295 FLOP per byte ridge.
//
// The TPU kernel accumulates its weight gradients across a sequential grid
// in one resident block (_accumulate_dw). Hopper runs blocks in parallel in
// no set order, so each weight-gradient GEMM splits the token rows over
// blocks that write fp32 partials, and a second launch adds them in a fixed
// order: no atomics, so two runs give the same bits. The bias gradients come
// out of the same GEMMs (a column of ones beside the left operand), and the
// LayerNorm parameter gradients out of the LayerNorm-backward pass. Ten
// launches on the caller's stream:
//
//   1. layernorm_kernel<bf16>              y2
//   2. gemm NN, EPI_GELU2                  g, gg
//   3. gemm NT, EPI_DM1                    dm1 (written over gg)
//   4. gemm TN split + reduce              dW2, db2
//   5. gemm TN split + reduce              dW1, db1
//   6. gemm NT, EPI_F32                    dy2 = dm1 W1^T, fp32
//   7. ln_bwd_kernel + reduce              dx2, dln2_scale, dln2_bias
//
// Limits: D <= 768, D and mlp multiples of 64, bf16 activations and matmul
// weights, fp32 LN parameters.

#include "common.cuh"

#define MLP_BWD_LAUNCHES 10

// fp32 scratch the wrapper allocates for the split partials
extern "C" long long vit2spn_mlp_bwd_workspace_floats(int M, int D, int MLP) {
  size_t w = wgrad_workspace_floats(MLP, D, M);
  const size_t w1 = wgrad_workspace_floats(D, MLP, M);
  const size_t ln = (size_t)lnb_blocks(M) * 2 * D;
  if (w1 > w) w = w1;
  if (ln > w) w = ln;
  return (long long)w;
}

extern "C" int vit2spn_mlp_bwd_launches() { return MLP_BWD_LAUNCHES; }

// x2, dout, dx2: (M, D) bf16. Gradients fp32: gw1 (D, MLP), gb1 (MLP),
// gw2 (MLP, D), gb2 (D), gln2_scale, gln2_bias (D). Scratch: y2 (M, D) bf16,
// g and gg (M, MLP) bf16, dy (M, D) fp32, ws (workspace_floats) fp32.
extern "C" int vit2spn_mlp_bwd(
    const void* x2, const void* dout, const void* ln2_scale, const void* ln2_bias,
    const void* w1, const void* b1, const void* w2,
    void* dx2, void* gln2_scale, void* gln2_bias, void* gw1, void* gb1, void* gw2, void* gb2,
    void* y2_buf, void* g_buf, void* gg_buf, void* dy_buf, void* ws_buf,
    int M, int D, int MLP, float eps, int fast_gelu, void* stream) {
  if (M <= 0 || D > LN_MAX_D || D % 64 || MLP % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* X2 = static_cast<const bf16*>(x2);
  const bf16* dO = static_cast<const bf16*>(dout);
  const bf16* W1 = static_cast<const bf16*>(w1);
  const bf16* W2 = static_cast<const bf16*>(w2);
  bf16* y2 = static_cast<bf16*>(y2_buf);
  bf16* g = static_cast<bf16*>(g_buf);
  bf16* gg = static_cast<bf16*>(gg_buf);
  bf16* dm1 = gg;  // EPI_DM1 reads gg and writes dm1 at the same index
  float* dy = static_cast<float*>(dy_buf);
  float* ws = static_cast<float*>(ws_buf);

  LAUNCH(launch_layernorm<bf16>(X2, static_cast<const float*>(ln2_scale),
                                static_cast<const float*>(ln2_bias), y2, M, D, eps, st));
  EpiArgs e1 = {};
  e1.bias = static_cast<const bf16*>(b1);
  e1.out = g;
  e1.out2 = gg;
  e1.fast_gelu = fast_gelu;
  LAUNCH((launch_gemm<false, false, EPI_GELU2>(y2, W1, M, MLP, D, e1, st)));

  EpiArgs e2 = {};
  e2.aux = gg;
  e2.out = dm1;
  LAUNCH((launch_gemm<false, true, EPI_DM1>(dO, W2, M, MLP, D, e2, st)));

  LAUNCH(launch_wgrad(g, dO, MLP, D, M, ws, static_cast<float*>(gw2),
                      static_cast<float*>(gb2), st));
  LAUNCH(launch_wgrad(y2, dm1, D, MLP, M, ws, static_cast<float*>(gw1),
                      static_cast<float*>(gb1), st));

  EpiArgs e3 = {};
  e3.f32 = dy;
  LAUNCH((launch_gemm<false, true, EPI_F32>(dm1, W1, M, D, MLP, e3, st)));

  return launch_ln_bwd(X2, dy, dO, static_cast<const float*>(ln2_scale),
                       static_cast<bf16*>(dx2), ws, static_cast<float*>(gln2_scale),
                       static_cast<float*>(gln2_bias), M, D, eps, st);
}
