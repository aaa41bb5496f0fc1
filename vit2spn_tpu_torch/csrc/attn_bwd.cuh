// Attention half of one ViT layer's backward for Hopper (sm_90a): the launch
// sequences csrc/attn_bwd.cu runs (and csrc/merged_bwd.cu, for fp32), per
// element type and width. Each computes what _attn_bwd_math and
// _attention_bwd (vit2spn_tpu/ops/fused_block.py) compute over the
// M = B * S token rows:
//
//   y1   = T(LN1(x));  qkv = T(y1 @ Wqkv + bqkv)
//   P    = softmax(q k^T / sqrt(dh)), fp32; att = T(T(P) v)
//   dWo  = att^T dx2,  dbo = sum(dx2);  datt = T(dx2 @ Wo^T)
//   dV   = T(P)^T datt;  dP = datt v^T
//   dS   = T(P * (dP - rowsum(dP * P)))        the row sum over all keys
//   dQ   = dS k / sqrt(dh);  dK = dS^T q / sqrt(dh);  dqkv = T(dQ|dK|dV)
//   dWqkv = y1^T dqkv,  dbqkv = sum(dqkv)
//   dx   = T(dx2 + LN1_bwd(dqkv @ Wqkv^T)),  dln1_scale, dln1_bias
//
// T is bf16, or fp32 under compute_dtype=float32, where every T(.) is the
// identity. What bounds it on this card: operations. The function needs
// three GEMMs of 2 S D 3D (the qkv recompute, dWqkv, dqkv Wqkv^T), two of
// 2 S D^2 (datt, dWo) and six attention products of 2 S^2 D (Q K^T, P V, dP,
// dV, dQ, dK): about 249 MFLOP per image per layer at ViT-Tiny, against a few
// (M, D) activations.
//
// The attention core: bf16, attention_bwd_kernel (csrc/attention_bwd.cuh:
// one block per (image, head) on mma.sync, P and dS in one bf16 term as the
// function rounds them); fp32, the CUDA-core flash kernels of
// csrc/flash_f32.cuh (forward for att, two backward launches for dq, dk, dv
// into the thirds of dqkv), reading q, k, v in place from qkv.
//
// bf16, D <= 256 (attn_bwd_hopper): six launches of the row-block wgmma kit
// (csrc/rowblock.cuh, csrc/wgrad.cuh):
//
//   1. LN1 + QKV                 the forward's stage 1 (x by TMA, LayerNorm in
//                                place, TMA stores of qkv), y1 out by TMA
//                                stores for dWqkv
//   2. dx2 Wo^T                  Wo's rows read K-major
//   3. attention_bwd_kernel      att, dqkv
//   4. dWo and dWqkv in one      split-K wgmma, the tokens M-major; dWqkv as
//      launch                    dqkv^T y1, written transposed by the reduce;
//                                the bias columns summed from the tiles
//   5. dqkv Wqkv^T + LN1         a block owns whole rows: dy1 never leaves the
//      backward                  registers; dx and per-warp LN1 partials
//   6. reduce_all                the three fixed-order reductions
//
// fp32, and bf16 above D = 256 (attn_bwd_seq<T>), the GEMMs common.cuh's:
//
//   1. layernorm_kernel                    y1
//   2. gemm NN, EPI_BIAS                   qkv
//   3. gemm NT, EPI_STORE                  datt = dx2 Wo^T
//   4. the attention core                  att, dqkv (bf16 1 launch, fp32 3)
//   5. gemm TN split + reduce              dWo, dbo
//   6. gemm TN split + reduce              dWqkv, dbqkv
//   7. gemm NT, EPI_F32                    dy1 = dqkv Wqkv^T, fp32
//   8. ln_bwd_kernel + reduce              dx, dln1_scale, dln1_bias
//
// The weight gradients split the token rows into fp32 partials added in a
// fixed order: no atomics, so two runs give the same bits. Limits: head_dim
// 64, S <= 256, D <= 768, activations and matmul weights in T, fp32 LN
// parameters.

#pragma once

#include "attention_bwd.cuh"
#include "flash_f32.cuh"
#include "wgrad.cuh"

#define ATTN_HOPPER_LAUNCHES 6

template <typename T>
static int attn_seq_launches() { return sizeof(T) == 2 ? 11 : 13; }

struct AttnBwdArgs {
  const void *x, *dx2, *ln1_scale, *ln1_bias, *wqkv, *bqkv, *wo;
  void *dx, *gln1_scale, *gln1_bias, *gwqkv, *gbqkv, *gwo, *gbo;
  void *y1, *qkv, *datt, *att, *dqkv, *dy, *ws;  // scratch
  int B, S, D, H;
  float eps;
};

static size_t attn_seq_workspace(int B, int S, int D, int H) {
  const int M = B * S;
  size_t w = wgrad_workspace_floats(D, D, M);
  const size_t w1 = wgrad_workspace_floats(D, 3 * D, M);
  const size_t ln = (size_t)lnb_blocks(M) * 2 * D;
  const size_t stats = (size_t)B * H * S * 3;  // the fp32 flash backward's
  if (w1 > w) w = w1;
  if (ln > w) w = ln;
  if (stats > w) w = stats;
  return w;
}

template <typename T>
static int attn_bwd_seq(const AttnBwdArgs& a, cudaStream_t st) {
  const int B = a.B, S = a.S, D = a.D, H = a.H, M = B * S;
  const T* X = static_cast<const T*>(a.x);
  const T* dX2 = static_cast<const T*>(a.dx2);
  const T* Wqkv = static_cast<const T*>(a.wqkv);
  T* y1 = static_cast<T*>(a.y1);
  T* qkv = static_cast<T*>(a.qkv);
  T* datt = static_cast<T*>(a.datt);
  T* att = static_cast<T*>(a.att);
  T* dqkv = static_cast<T*>(a.dqkv);
  float* dy = static_cast<float*>(a.dy);
  float* ws = static_cast<float*>(a.ws);
  const float* l1s = static_cast<const float*>(a.ln1_scale);

  LAUNCH((launch_layernorm<T, T>(X, l1s, static_cast<const float*>(a.ln1_bias), y1, M, D, a.eps,
                                 st)));
  EpiArgsT<T> e1 = {};
  e1.bias = static_cast<const T*>(a.bqkv);
  e1.out = qkv;
  LAUNCH((launch_gemm<T, false, false, EPI_BIAS>(y1, Wqkv, M, 3 * D, D, e1, st)));
  EpiArgsT<T> e2 = {};
  e2.out = datt;
  LAUNCH((launch_gemm<T, false, true, EPI_STORE>(dX2, static_cast<const T*>(a.wo), M, D, D, e2,
                                                 st)));
  if constexpr (sizeof(T) == 2) {
    LAUNCH(launch_attention_bwd(qkv, datt, att, dqkv, B, S, H, D, st));
  } else {
    const float scale = 1.0f / sqrtf((float)FA_DH);
    const long long ts = 3LL * D, bs = (long long)S * ts;
    LAUNCH(fwd_f32(qkv, qkv + D, qkv + 2 * D, att, B, S, H, bs, ts, scale, st));
    LAUNCH(bwd_f32(qkv, qkv + D, qkv + 2 * D, datt, dqkv, dqkv + D, dqkv + 2 * D, ws, B, S, H, bs,
                   ts, ts, scale, st));
  }
  LAUNCH(launch_wgrad(att, dX2, D, D, M, ws, static_cast<float*>(a.gwo),
                      static_cast<float*>(a.gbo), st));
  LAUNCH(launch_wgrad(y1, dqkv, D, 3 * D, M, ws, static_cast<float*>(a.gwqkv),
                      static_cast<float*>(a.gbqkv), st));
  EpiArgsT<T> e3 = {};
  e3.f32 = dy;
  LAUNCH((launch_gemm<T, false, true, EPI_F32>(dqkv, Wqkv, M, D, 3 * D, e3, st)));
  return launch_ln_bwd(X, dy, dX2, l1s, static_cast<T*>(a.dx), ws,
                       static_cast<float*>(a.gln1_scale), static_cast<float*>(a.gln1_bias), M, D,
                       a.eps, st);
}

// bf16, D <= HOPPER_BWD_MAX_D: the row-block kit
template <int D>
static int attn_bwd_hopper_d(const AttnBwdArgs& a, cudaStream_t st, bool size_only,
                             long long* need) {
  const int M = a.B * a.S;
  const bf16* X = static_cast<const bf16*>(a.x);
  const bf16* dX2 = static_cast<const bf16*>(a.dx2);
  bf16* y1 = static_cast<bf16*>(a.y1);
  bf16* qkv = static_cast<bf16*>(a.qkv);
  bf16* datt = static_cast<bf16*>(a.datt);
  bf16* att = static_cast<bf16*>(a.att);
  bf16* dqkv = static_cast<bf16*>(a.dqkv);
  float* ws = static_cast<float*>(a.ws);
  WgradProblem wp[2];
  const long long pair =
      wgrad_pair<D>(att, dX2, D, 0, dqkv, y1, 3 * D, 1, M, nullptr, wp, st);
  const long long ln = (long long)rowblocks<2>(M) * 8 * 2 * D;
  if (size_only) {
    *need = pair + ln;
    return 0;
  }
  CUtensorMap xm, dx2m, y1m, qkvm, dqkvm, wqkvm, wom;
  LAUNCH(tensor_map(&xm, X, D, M, 1));
  LAUNCH(tensor_map(&dx2m, dX2, D, M, 1));
  LAUNCH(tensor_map(&y1m, y1, D, M, 1));
  LAUNCH(tensor_map(&qkvm, qkv, 3 * D, M, 1));
  LAUNCH(tensor_map(&dqkvm, dqkv, 3 * D, M, 1));
  LAUNCH(tensor_map(&wqkvm, a.wqkv, 3 * D, D, 1));
  LAUNCH(tensor_map(&wom, a.wo, D, D, 1));
  const float* l1s = static_cast<const float*>(a.ln1_scale);

  EpiArgs e1 = {};
  e1.bias = static_cast<const bf16*>(a.bqkv);
  LAUNCH((launch_rowblock<2, 192, A_LN_BF16, EPI_BIAS, 1, true>(
      xm, wqkvm, qkvm, qkvm, y1m, X, l1s, static_cast<const float*>(a.ln1_bias), 0, M, 3 * D, D, a.eps,
      e1, st)));
  EpiArgs e2 = {};
  e2.out = datt;
  LAUNCH((launch_rowblock<2, D, A_TMA, EPI_STORE, 0>(dx2m, wom, dx2m, dx2m, dx2m, nullptr, nullptr,
                                                     nullptr, 0, M, D, D, a.eps, e2, st)));
  LAUNCH(launch_attention_bwd(qkv, datt, att, dqkv, a.B, a.S, a.H, D, st));
  LAUNCH((int)wgrad_pair<D>(att, dX2, D, 0, dqkv, y1, 3 * D, 1, M, ws, wp, st));
  float* lnp = ws + pair;
  EpiArgs e3 = {};
  e3.resid = dX2;
  e3.out = static_cast<bf16*>(a.dx);
  e3.f32 = lnp;
  LAUNCH((launch_rowblock<2, D, A_TMA, EPI_LNBWD, 0>(dqkvm, wqkvm, dqkvm, dqkvm, dqkvm, X, l1s, nullptr,
                                                     0, M, D, 3 * D, a.eps, e3, st)));
  Reductions red = {};
  red.r[red.count++] = wgrad_reduction(wp[0], static_cast<float*>(a.gwo),
                                       static_cast<float*>(a.gbo), false);
  red.r[red.count++] = wgrad_reduction(wp[1], static_cast<float*>(a.gwqkv),
                                       static_cast<float*>(a.gbqkv), true);
  red.r[red.count++] = {lnp, rowblocks<2>(M) * 8, 2 * D, D, static_cast<float*>(a.gln1_scale),
                        static_cast<float*>(a.gln1_bias), 0, 1};
  return launch_reduce_all(red, st);
}

// The bf16 route for D <= HOPPER_BWD_MAX_D; with size_only, its workspace
// in floats into *need and nothing launched.
static int attn_bwd_hopper(const AttnBwdArgs& a, cudaStream_t st, bool size_only = false,
                           long long* need = nullptr) {
  switch (a.D) {
    case 64: return attn_bwd_hopper_d<64>(a, st, size_only, need);
    case 128: return attn_bwd_hopper_d<128>(a, st, size_only, need);
    case 192: return attn_bwd_hopper_d<192>(a, st, size_only, need);
    case 256: return attn_bwd_hopper_d<256>(a, st, size_only, need);
    default: return (int)cudaErrorInvalidValue;
  }
}
