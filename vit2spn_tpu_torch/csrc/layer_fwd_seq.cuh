// One pre-LN ViT layer's forward as seven launches for Hopper (sm_90a), in
// T = fp32 or bf16: the fp32 route (compute_dtype=float32) of
// csrc/backbone_fwd.cu and csrc/layer_fwd.cu at every geometry, and their
// bf16 route at the general geometry (head_dim 16, 32, 48 or 80, or D or mlp
// not a multiple of 64, any S: common.cuh general_route).
//
// It computes _block_fwd_math (vit2spn_tpu/ops/fused_block.py) with its
// rounding points to T (the identity in fp32):
//
//   y1  = T(LN1(x));  qkv = T(y1 @ Wqkv + bqkv)
//   att = T(concat_h(T(softmax(q k^T / sqrt(dh))) @ v))   pad keys -1e30
//   x2  = (x + att @ Wo) + bo   fp32;  g = T(gelu(T(LN2(x2)) @ W1 + b1))
//   out = T((x2 + g @ W2) + b2)
//
// A simple design, not a fast one: seven launches per layer, every
// intermediate through device memory, the seven-launch layer the bf16 kernel
// had before it was fused: LayerNorm (common.cuh), the GEMM with the QKV bias
// epilogue, the attention reading q, k and v in place from qkv, the Wo GEMM
// with the residual (fp32 x2, the xs / x2s stacks), LayerNorm, the W1 GEMM
// with gelu, the W2 GEMM with the residual. The GEMMs are common.cuh's
// launch_gemm<T>: mma.sync for bf16 (N a multiple of 32: masked column
// tiles), CUDA-core FMAs for fp32 (the tensor cores take no fp32 operand).
// The attention: fp32, the CUDA-core kernels of csrc/flash_f32.cuh (P not
// rounded, as the identity T leaves it); bf16, the forward-only mode of the
// backward's mma.sync core (csrc/attention_bwd.cuh), which rounds P to bf16
// before P v as the function does (the flash kernels keep P in fp32: another
// function), above 256 keys the multi-pass stage of csrc/general_long.cuh
// (head_dim 16, 32, 48; 80 at every S) or csrc/long_attention.cuh (64). `out`
// may be `in`: `in` is last read by the Wo launch, `out` first written by
// the W2 launch.

#pragma once

#define ATTENTION_CORE_FWD_ONLY  // csrc/attention_bwd.cuh: the forward-only launcher
#include "attention_bwd.cuh"
#include "flash_f32.cuh"

#define LAYER_SEQ_LAUNCHES 7

// out = layer l (in), weights the 12 stacked arrays (WEIGHT_NAMES order:
// LN parameters fp32, matrices and biases T); xs / x2s (optional) get a copy
// of in and T(x2). Scratch: y (M, D; y1, then y2), qkv (M, 3 D), att (M, D)
// and g (M, MLP) in T, x2 (M, D) fp32.
template <typename T>
static int launch_layer_seq(const T* in, T* out, T* xs, T* x2s, const void* const* wt, int l,
                            T* y, T* qkv, T* att, float* x2, T* g, int B, int S, int D, int H,
                            int MLP, float eps, int fast_gelu, cudaStream_t st) {
  const int M = B * S;
  const size_t d = D, m = MLP;
  auto f = [&](int i) { return static_cast<const float*>(wt[i]); };
  auto w = [&](int i) { return static_cast<const T*>(wt[i]); };
  const float *ln1s = f(0) + l * d, *ln1b = f(1) + l * d, *ln2s = f(6) + l * d,
              *ln2b = f(7) + l * d;
  const T *wqkv = w(2) + l * d * 3 * d, *bqkv = w(3) + l * 3 * d, *wo = w(4) + l * d * d,
          *bo = w(5) + l * d, *w1 = w(8) + l * d * m, *b1 = w(9) + l * m,
          *w2 = w(10) + l * m * d, *b2 = w(11) + l * d;
  LAUNCH((launch_layernorm<T, T>(in, ln1s, ln1b, y, M, D, eps, st)));
  EpiArgsT<T> e1 = {};
  e1.bias = bqkv;
  e1.out = qkv;
  LAUNCH((launch_gemm<T, false, false, EPI_BIAS>(y, wqkv, M, 3 * D, D, e1, st)));
  if constexpr (sizeof(T) == 2) {
    LAUNCH(launch_attention_fwd_general(qkv, att, B, S, H, D, st));
  } else {
    const long long ts = 3LL * D;
    LAUNCH(fwd_f32(qkv, qkv + D, qkv + 2 * D, att, B, S, H, D / H, S * ts, ts,
                   attention_scale(D / H), st));
  }
  EpiArgsT<T> e3 = {};
  e3.bias = bo;
  e3.f32 = x2;
  e3.resid = in;
  e3.xs = xs;
  e3.x2s = x2s;
  LAUNCH((launch_gemm<T, false, false, EPI_RESID>(att, wo, M, D, D, e3, st)));
  LAUNCH((launch_layernorm<float, T>(x2, ln2s, ln2b, y, M, D, eps, st)));
  EpiArgsT<T> e4 = {};
  e4.bias = b1;
  e4.out = g;
  e4.fast_gelu = fast_gelu;
  LAUNCH((launch_gemm<T, false, false, EPI_GELU>(y, w1, M, MLP, D, e4, st)));
  EpiArgsT<T> e5 = {};
  e5.bias = b2;
  e5.f32 = x2;
  e5.out = out;
  return launch_gemm<T, false, false, EPI_OUT>(g, w2, M, D, MLP, e5, st);
}
