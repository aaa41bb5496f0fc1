// MLP half of one ViT layer's backward for Hopper (sm_90a): bf16 or fp32 in
// and out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_mlp_bwd_kernel (the Pallas TPU
// kernel run by _layer_bwd for every layer of _backbone_vjp_bwd), which
// recomputes LN2 and the MLP from the saved mid-residual x2 and emits dx2 and
// the LN2 / MLP weight gradients, in whatever dtype its inputs carry. The
// launch sequences, what bounds them and the design: csrc/mlp_bwd.cuh. bf16
// at D <= 256 runs the wgmma row-block kit (five launches), bf16 at D = 384,
// 768 and 1024 its wide route (seven), bf16 at other widths above 256, at D or mlp
// not a multiple of 64 (the general geometry) and fp32 the ten-launch
// sequence.

#include "mlp_bwd.cuh"

// fp32 scratch the wrapper allocates for the split partials
extern "C" long long vit2spn_mlp_bwd_workspace_floats(int M, int D, int MLP, int fp32) {
  if (!hopper_route(D, fp32, MLP)) return (long long)mlp_seq_workspace(M, D, MLP);
  MlpBwdArgs a = {};
  a.M = M;
  a.D = D;
  a.MLP = MLP;
  long long need = 0;
  return mlp_bwd_hopper(a, 0, true, &need) == 0 ? need : -1;
}

// CUDA kernel launches one call makes
extern "C" int vit2spn_mlp_bwd_launches(int D, int fp32, int H, int MLP) {
  (void)H;
  if (!hopper_route(D, fp32, MLP)) return MLP_SEQ_LAUNCHES;
  return wide_route(D) ? MLP_WIDE_LAUNCHES : MLP_HOPPER_LAUNCHES;
}

// x2, dout, dx2: (M, D), all bf16 or (fp32 set) all fp32, as the matmul
// weights w1 (D, MLP), b1 (MLP), w2 (MLP, D); LN parameters fp32 (D).
// Gradients fp32: gw1 (D, MLP), gb1 (MLP), gw2 (MLP, D), gb2 (D), gln2_scale,
// gln2_bias (D). Scratch in the activations' dtype: y2 (M, D), g and gg (M,
// MLP); dy (M, D) fp32 (null on the bf16 route at D <= 256); ws
// (workspace_floats) fp32.
extern "C" int vit2spn_mlp_bwd(
    const void* x2, const void* dout, const void* ln2_scale, const void* ln2_bias,
    const void* w1, const void* b1, const void* w2,
    void* dx2, void* gln2_scale, void* gln2_bias, void* gw1, void* gb1, void* gw2, void* gb2,
    void* y2_buf, void* g_buf, void* gg_buf, void* dy_buf, void* ws_buf,
    int M, int D, int MLP, float eps, int fast_gelu, int fp32, void* stream) {
  if (M <= 0 || D <= 0 || D > LN_MAX_D || D % 32 || MLP <= 0 || MLP % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MlpBwdArgs a = {x2, dout, ln2_scale, ln2_bias, w1, b1, w2, dx2, gln2_scale, gln2_bias,
                        gw1, gb1, gw2, gb2, y2_buf, g_buf, gg_buf, dy_buf, ws_buf, M, D, MLP,
                        eps, fast_gelu};
  if (fp32) return mlp_bwd_seq<float>(a, st);
  if (hopper_route(D, fp32, MLP)) return mlp_bwd_hopper(a, st);
  return mlp_bwd_seq<bf16>(a, st);
}

// The fp32 GEMM of every fp32 route alone (common.cuh gemm_f32_kernel), for
// timing it against a library product: form 0, C (M, N) = A (M, K) B (K, N);
// form 1, C = A B^T with B (N, K); form 2, the weight-gradient form, C (M + 1,
// N) = [A | 1]^T B with A (K, M), the K rows split as the backward splits its
// token rows and the fp32 partials (ws, workspace_floats) reduced in order:
// C's last row is B's column sums.
extern "C" long long vit2spn_gemm_f32_workspace_floats(int M, int N, int K) {
  return (long long)wgrad_workspace_floats(M, N, K);
}

extern "C" int vit2spn_gemm_f32(const void* a, const void* b, void* c, void* ws, int M, int N,
                                int K, int form, void* stream) {
  if (M <= 0 || N <= 0 || N % 64 || K <= 0 || K % 4 || M % 4 || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  EpiArgsT<float> e = {};
  e.out = C;
  if (form == 0) return launch_gemm<float, false, false, EPI_STORE>(A, B, M, N, K, e, st);
  if (form == 1) return launch_gemm<float, false, true, EPI_STORE>(A, B, M, N, K, e, st);
  return launch_wgrad(A, B, M, N, K, static_cast<float*>(ws), C, C + (size_t)M * N, st);
}
