// MLP half of one ViT layer's backward for Hopper (sm_90a): the launch
// sequences csrc/mlp_bwd.cu runs (and csrc/merged_bwd.cu, the same code), per
// element type and width. Each computes what _mlp_bwd_math
// (vit2spn_tpu/ops/fused_block.py) computes over the M = B * S token rows:
//
//   y2  = T(LN2(x2))                       fp32 statistics
//   m1  = T(y2 @ W1 + b1)                  the recompute stores m1 in T
//   g   = T(gelu(m1)),  gg = T(gelu'(m1))  exact or fast form
//   dm1 = T(T(dout @ W2^T) * gg)
//   dW2 = g^T dout,   db2 = sum(dout)      fp32, over all M rows
//   dW1 = y2^T dm1,   db1 = sum(dm1)
//   dx2 = T(dout + LN2_bwd(dm1 @ W1^T)),  dln2_scale, dln2_bias
//
// T is bf16, or fp32 under compute_dtype=float32, where every T(.) is the
// identity. What bounds it on this card: operations. Five GEMMs of 2 M D MLP
// each (the m1 recompute, dout W2^T, the two weight gradients, dm1 W1^T)
// against a few (M, MLP) intermediates: about 290 MFLOP per image per layer
// at ViT-Tiny, far above the ~295 FLOP per byte ridge.
//
// The TPU kernel accumulates its weight gradients across a sequential grid
// in one resident block (_accumulate_dw). Hopper runs blocks in parallel in
// no set order, so the weight gradients are split over the token rows into
// fp32 partials that a later launch adds in a fixed order: no atomics, so two
// runs give the same bits.
//
// bf16, D <= 256 (mlp_bwd_hopper): five launches of the row-block wgmma kit
// (csrc/rowblock.cuh, csrc/wgrad.cuh), every operand streamed by TMA:
//
//   1. LN2 + W1 + gelu / gelu'   x2 rows by TMA into the A tile, LayerNorm
//                                in place (y2 out by TMA stores for dW1),
//                                every 192 columns of W1 against it; m1, g and
//                                gg in the epilogue with __fdividef (the IEEE
//                                divisions made this epilogue two thirds of
//                                the mma.sync GEMM's time)
//   2. dout W2^T, * gg           W2's rows read K-major (the transpose in the
//                                descriptor), dm1 written over gg
//   3. dW2 and dW1 in one launch split-K wgmma, the tokens M-major; dW1 as
//                                dm1^T y2, written transposed by the reduce;
//                                the bias columns summed from the tiles
//   4. dm1 W1^T + LN2 backward   a block owns whole rows: dy2 (64 x D fp32 per
//                                warpgroup) never leaves the registers; dx2
//                                and per-warp LN2 parameter partials
//   5. reduce_all                the three fixed-order reductions
//
// bf16, D = 384, 768 and 1024 (the wide route, ViT-Small, ViT-Base and
// ViT-Large): the kit's stages where wgmma's N (at most 256), shared memory and the
// registers allow, seven launches:
//
//   1. layernorm_kernel          y2 (bf16, for W1 and dW1)
//   2. y2 W1 + gelu / gelu'      the kit's stage 1 with y2 streamed by TMA
//                                beside W1: a resident 128-row LN tile is
//                                192 KB at D = 768, and the one-warpgroup
//                                block that fits (64 rows) reads W1 from L2
//                                twice as often and leaves the tensor cores
//                                idle through its gelu epilogue (0.775 ms
//                                of a 1.94 ms half on an H100 at D = 768,
//                                B = 128)
//   3. dout W2^T, * gg           the kit's stage 2
//   4. dW2 and dW1 in one launch the kit's pair, N = D in wide_nt(D)-column
//                                tiles (192; 256 at D = 1024)
//   5. dm1 W1^T                  N = D in wide_nt(D)-column tiles; dy2
//                                leaves in fp32 (EPI_F32): 64 x D fp32 per
//                                warpgroup is 384 registers a thread at
//                                D = 768
//   6. ln_bwd_rows_kernel        dx2 and per-16-row LN2 partials, as the
//                                kit's epilogue gives them
//   7. reduce_all                the three fixed-order reductions
//
// The fp32 dy2 costs 2 x 77.5 MB of traffic at D = 768, B = 128 (about
// 0.05 ms against the half's 0.60 ms operations bound).
//
// fp32, and bf16 at the other widths above D = 256 (mlp_bwd_seq<T>): ten
// launches, the GEMMs common.cuh's (mma.sync for bf16, CUDA cores for fp32):
//
//   1. layernorm_kernel                    y2
//   2. gemm NN, EPI_GELU2                  g, gg
//   3. gemm NT, EPI_DM1                    dm1 (written over gg)
//   4. gemm TN split + reduce              dW2, db2
//   5. gemm TN split + reduce              dW1, db1
//   6. gemm NT, EPI_F32                    dy2 = dm1 W1^T, fp32
//   7. ln_bwd_kernel + reduce              dx2, dln2_scale, dln2_bias
//
// The sequence also takes the general geometry in bf16: D or mlp a multiple
// of 32 but not of 64 (the GEMMs' last column tile masked, the LayerNorm
// backward's last pairs of columns half used). Limits: D <= 1024, D and mlp
// multiples of 32, activations and matmul weights in T, fp32 LN parameters.

#pragma once

#include "wgrad.cuh"

#define MLP_SEQ_LAUNCHES 10
#define MLP_HOPPER_LAUNCHES 5
#define MLP_WIDE_LAUNCHES 7

struct MlpBwdArgs {
  const void *x2, *dout, *ln2_scale, *ln2_bias, *w1, *b1, *w2;
  void *dx2, *gln2_scale, *gln2_bias, *gw1, *gb1, *gw2, *gb2;
  void *y2, *g, *gg, *dy, *ws;  // scratch
  int M, D, MLP;
  float eps;
  int fast_gelu;
};

static size_t mlp_seq_workspace(int M, int D, int MLP) {
  size_t w = wgrad_workspace_floats(MLP, D, M);
  const size_t w1 = wgrad_workspace_floats(D, MLP, M);
  const size_t ln = (size_t)lnb_blocks(M) * 2 * D;
  if (w1 > w) w = w1;
  if (ln > w) w = ln;
  return w;
}

template <typename T>
static int mlp_bwd_seq(const MlpBwdArgs& a, cudaStream_t st) {
  const int M = a.M, D = a.D, MLP = a.MLP;
  const T* X2 = static_cast<const T*>(a.x2);
  const T* dO = static_cast<const T*>(a.dout);
  const T* W1 = static_cast<const T*>(a.w1);
  const T* W2 = static_cast<const T*>(a.w2);
  T* y2 = static_cast<T*>(a.y2);
  T* g = static_cast<T*>(a.g);
  T* gg = static_cast<T*>(a.gg);
  T* dm1 = gg;  // EPI_DM1 reads gg and writes dm1 at the same index
  float* dy = static_cast<float*>(a.dy);
  float* ws = static_cast<float*>(a.ws);
  const float* l2s = static_cast<const float*>(a.ln2_scale);

  LAUNCH((launch_layernorm<T, T>(X2, l2s, static_cast<const float*>(a.ln2_bias), y2, M, D,
                                 a.eps, st)));
  EpiArgsT<T> e1 = {};
  e1.bias = static_cast<const T*>(a.b1);
  e1.out = g;
  e1.out2 = gg;
  e1.fast_gelu = a.fast_gelu;
  LAUNCH((launch_gemm<T, false, false, EPI_GELU2>(y2, W1, M, MLP, D, e1, st)));
  EpiArgsT<T> e2 = {};
  e2.aux = gg;
  e2.out = dm1;
  LAUNCH((launch_gemm<T, false, true, EPI_DM1>(dO, W2, M, MLP, D, e2, st)));
  LAUNCH(launch_wgrad(g, dO, MLP, D, M, ws, static_cast<float*>(a.gw2),
                      static_cast<float*>(a.gb2), st));
  LAUNCH(launch_wgrad(y2, dm1, D, MLP, M, ws, static_cast<float*>(a.gw1),
                      static_cast<float*>(a.gb1), st));
  EpiArgsT<T> e3 = {};
  e3.f32 = dy;
  LAUNCH((launch_gemm<T, false, true, EPI_F32>(dm1, W1, M, D, MLP, e3, st)));
  return launch_ln_bwd(X2, dy, dO, l2s, static_cast<T*>(a.dx2), ws,
                       static_cast<float*>(a.gln2_scale), static_cast<float*>(a.gln2_bias), M,
                       D, a.eps, st);
}

// bf16, D <= HOPPER_BWD_MAX_D (the row-block kit) and D = 384, 768, 1024
// (its wide route). NT of the two products over the MLP columns: the widest of
// 192, 128, 64 that divides mlp. With `defer`, its three reductions join that
// list (csrc/merged_bwd.cu takes them in one launch with the attention
// half's) and the half is one launch shorter.
template <int D, int NT>
static int mlp_bwd_hopper_nt(const MlpBwdArgs& a, cudaStream_t st, bool size_only,
                             long long* need, Reductions* defer) {
  constexpr bool WIDE = D > HOPPER_BWD_MAX_D;
  constexpr int NW = WIDE ? wide_nt(D) : D;  // the N tiles of the products whose N is D
  const int M = a.M, MLP = a.MLP;
  const bf16* X2 = static_cast<const bf16*>(a.x2);
  const bf16* dO = static_cast<const bf16*>(a.dout);
  bf16* y2 = static_cast<bf16*>(a.y2);
  bf16* g = static_cast<bf16*>(a.g);
  bf16* dm1 = static_cast<bf16*>(a.gg);  // gg, then dm1 over it
  float* ws = static_cast<float*>(a.ws);
  WgradProblem wp[2];
  const long long pair = wgrad_pair<NW>(g, dO, MLP, 0, dm1, y2, MLP, 1, D, M, nullptr, wp, st);
  // the LayerNorm partials: one per 16 rows (per warp of the kit's epilogue,
  // rounded up to its 128-row blocks)
  const int ln_parts = WIDE ? ln_rows_parts(M) : rowblocks<2>(M) * 8;
  if (pair < 0) return (int)-pair;
  if (size_only) {
    *need = pair + (long long)ln_parts * 2 * D;
    return 0;
  }
  if (WIDE && !a.dy) return (int)cudaErrorInvalidValue;
  CUtensorMap x2m, doutm, y2m, gm, dm1m, w1m, w2m;
  LAUNCH(tensor_map(&x2m, X2, D, M, 1));
  LAUNCH(tensor_map(&doutm, dO, D, M, 1));
  LAUNCH(tensor_map(&y2m, y2, D, M, 1));
  LAUNCH(tensor_map(&gm, g, MLP, M, 1));
  LAUNCH(tensor_map(&dm1m, dm1, MLP, M, 1));
  LAUNCH(tensor_map(&w1m, a.w1, MLP, D, 1));
  LAUNCH(tensor_map(&w2m, a.w2, D, MLP, 1));
  const float* l2s = static_cast<const float*>(a.ln2_scale);
  const float* l2b = static_cast<const float*>(a.ln2_bias);

  EpiArgs e1 = {};  // g and gg leave by TMA stores (gm, dm1m)
  e1.bias = static_cast<const bf16*>(a.b1);
  e1.fast_gelu = a.fast_gelu;
  if constexpr (WIDE) {  // y2 first, then streamed beside W1
    LAUNCH((launch_layernorm<bf16, bf16>(X2, l2s, l2b, y2, M, D, a.eps, st)));
    LAUNCH((launch_rowblock<2, NT, A_TMA, EPI_GELU2, 1>(y2m, w1m, gm, dm1m, y2m, nullptr,
                                                        nullptr, nullptr, 0, M, MLP, D, a.eps,
                                                        e1, st)));
  } else {  // LN2 into the resident A tile, y2 out by TMA stores
    LAUNCH((launch_rowblock<2, NT, A_LN_BF16, EPI_GELU2, 1, true>(
        x2m, w1m, gm, dm1m, y2m, X2, l2s, l2b, 0, M, MLP, D, a.eps, e1, st)));
  }
  EpiArgs e2 = {};  // gg arrives and dm1 leaves by TMA (dm1m)
  LAUNCH((launch_rowblock<2, NT, A_TMA, EPI_DM1, 0>(doutm, w2m, dm1m, dm1m, doutm, nullptr, nullptr,
                                                    nullptr, 0, M, MLP, D, a.eps, e2, st)));
  LAUNCH((int)wgrad_pair<NW>(g, dO, MLP, 0, dm1, y2, MLP, 1, D, M, ws, wp, st));
  float* lnp = ws + pair;
  if constexpr (WIDE) {  // dy2 = dm1 W1^T in fp32, then the row-wise LN2 backward
    float* dy = static_cast<float*>(a.dy);
    EpiArgs e3 = {};
    e3.f32 = dy;
    LAUNCH((launch_rowblock<2, NW, A_TMA, EPI_F32, 0>(dm1m, w1m, dm1m, dm1m, dm1m, nullptr,
                                                      nullptr, nullptr, 0, M, D, MLP, a.eps, e3,
                                                      st)));
    LAUNCH(launch_ln_bwd_rows<D>(X2, dy, dO, l2s, static_cast<bf16*>(a.dx2), lnp, M, a.eps, st));
  } else {  // dy2 in registers, the LN2 backward in the epilogue
    EpiArgs e3 = {};
    e3.resid = dO;
    e3.out = static_cast<bf16*>(a.dx2);
    e3.f32 = lnp;
    LAUNCH((launch_rowblock<2, D, A_TMA, EPI_LNBWD, 0>(dm1m, w1m, dm1m, dm1m, dm1m, X2, l2s,
                                                       nullptr, 0, M, D, MLP, a.eps, e3, st)));
  }
  Reductions red = {};
  Reductions* r = defer ? defer : &red;
  LAUNCH(defer_reduction(r, wgrad_reduction(wp[0], static_cast<float*>(a.gw2),
                                            static_cast<float*>(a.gb2), false)));
  LAUNCH(defer_reduction(r, wgrad_reduction(wp[1], static_cast<float*>(a.gw1),
                                            static_cast<float*>(a.gb1), true)));
  LAUNCH(defer_reduction(r, {lnp, ln_parts, 2 * D, D, static_cast<float*>(a.gln2_scale),
                             static_cast<float*>(a.gln2_bias), 0, 1}));
  return defer ? 0 : launch_reduce_all(red, st);
}

template <int D>
static int mlp_bwd_hopper_d(const MlpBwdArgs& a, cudaStream_t st, bool size_only,
                            long long* need, Reductions* defer) {
  if (a.MLP % 192 == 0) return mlp_bwd_hopper_nt<D, 192>(a, st, size_only, need, defer);
  if (a.MLP % 128 == 0) return mlp_bwd_hopper_nt<D, 128>(a, st, size_only, need, defer);
  return mlp_bwd_hopper_nt<D, 64>(a, st, size_only, need, defer);
}

// The bf16 wgmma routes (hopper_route: D <= HOPPER_BWD_MAX_D, 384, 768, 1024);
// with size_only, the workspace in floats into *need and nothing launched;
// with `defer`, the reductions left to the caller.
static int mlp_bwd_hopper(const MlpBwdArgs& a, cudaStream_t st, bool size_only = false,
                          long long* need = nullptr, Reductions* defer = nullptr) {
  switch (a.D) {
    case 64: return mlp_bwd_hopper_d<64>(a, st, size_only, need, defer);
    case 128: return mlp_bwd_hopper_d<128>(a, st, size_only, need, defer);
    case 192: return mlp_bwd_hopper_d<192>(a, st, size_only, need, defer);
    case 256: return mlp_bwd_hopper_d<256>(a, st, size_only, need, defer);
    case 384: return mlp_bwd_hopper_d<384>(a, st, size_only, need, defer);
    case 768: return mlp_bwd_hopper_d<768>(a, st, size_only, need, defer);
    case 1024: return mlp_bwd_hopper_d<1024>(a, st, size_only, need, defer);
    default: return (int)cudaErrorInvalidValue;
  }
}
