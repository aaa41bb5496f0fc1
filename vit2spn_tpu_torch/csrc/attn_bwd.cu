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

#include "attention_bwd.cuh"

#define ATTN_BWD_LAUNCHES 11

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
