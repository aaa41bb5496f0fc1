// One pre-LN ViT layer's forward in fp32 (compute_dtype=float32) for Hopper
// (sm_90a): the fp32 route of csrc/backbone_fwd.cu and csrc/layer_fwd.cu.
//
// In fp32 every astype(dtype) of _block_fwd_math
// (vit2spn_tpu/ops/fused_block.py) is the identity, so the layer is the bf16
// one with its rounding points removed:
//
//   y1  = LN1(x);  qkv = y1 @ Wqkv + bqkv
//   att = concat_h(softmax(q k^T / sqrt(dh)) @ v)        pad keys -1e30
//   x2  = (x + att @ Wo) + bo;  g = gelu(LN2(x2) @ W1 + b1)
//   out = (x2 + g @ W2) + b2
//
// A simple design, not a fast one: the tensor cores take no fp32 operand,
// so every product is an fp32 FMA on the CUDA cores (67 TFLOP/s on the card
// against 989 for bf16). Seven launches per layer, every intermediate through
// device memory, the seven-launch layer the bf16 kernel had before it was
// fused: LayerNorm (common.cuh), the CUDA-core GEMM with the QKV bias
// epilogue, the fp32 flash forward (csrc/flash_f32.cuh) reading q, k and v in
// place from qkv, the Wo GEMM with the residual (fp32 x2, the xs / x2s
// stacks), LayerNorm, the W1 GEMM with gelu, the W2 GEMM with the residual.
// `out` may be `in`: `in` is last read by the Wo launch, `out` first written
// by the W2 launch.

#pragma once

#include "flash_f32.cuh"

#define LAYER_F32_LAUNCHES 7

// out = layer l (in), weights the 12 stacked fp32 arrays (WEIGHT_NAMES
// order); xs / x2s (optional) get a copy of in and x2. Scratch (fp32): y (M,
// D; y1, then y2), qkv (M, 3 D), att (M, D), x2 (M, D), g (M, MLP).
static int launch_layer_f32(const float* in, float* out, float* xs, float* x2s,
                            const void* const* wt, int l, float* y, float* qkv, float* att,
                            float* x2, float* g, int B, int S, int D, int H, int MLP, float eps,
                            int fast_gelu, cudaStream_t st) {
  const int M = B * S;
  const size_t d = D, m = MLP;
  auto w = [&](int i) { return static_cast<const float*>(wt[i]); };
  const float *ln1s = w(0) + l * d, *ln1b = w(1) + l * d, *wqkv = w(2) + l * d * 3 * d,
              *bqkv = w(3) + l * 3 * d, *wo = w(4) + l * d * d, *bo = w(5) + l * d,
              *ln2s = w(6) + l * d, *ln2b = w(7) + l * d, *w1 = w(8) + l * d * m,
              *b1 = w(9) + l * m, *w2 = w(10) + l * m * d, *b2 = w(11) + l * d;
  LAUNCH((launch_layernorm<float, float>(in, ln1s, ln1b, y, M, D, eps, st)));
  EpiArgsT<float> e1 = {};
  e1.bias = bqkv;
  e1.out = qkv;
  LAUNCH((launch_gemm<float, false, false, EPI_BIAS>(y, wqkv, M, 3 * D, D, e1, st)));
  const long long ts = 3LL * D;
  LAUNCH(fwd_f32(qkv, qkv + D, qkv + 2 * D, att, B, S, H, S * ts, ts,
                 1.0f / sqrtf((float)FA_DH), st));
  EpiArgsT<float> e3 = {};
  e3.bias = bo;
  e3.f32 = x2;
  e3.resid = in;
  e3.xs = xs;
  e3.x2s = x2s;
  LAUNCH((launch_gemm<float, false, false, EPI_RESID>(att, wo, M, D, D, e3, st)));
  LAUNCH((launch_layernorm<float, float>(x2, ln2s, ln2b, y, M, D, eps, st)));
  EpiArgsT<float> e4 = {};
  e4.bias = b1;
  e4.out = g;
  e4.fast_gelu = fast_gelu;
  LAUNCH((launch_gemm<float, false, false, EPI_GELU>(y, w1, M, MLP, D, e4, st)));
  EpiArgsT<float> e5 = {};
  e5.bias = b2;
  e5.f32 = x2;
  e5.out = out;
  return launch_gemm<float, false, false, EPI_OUT>(g, w2, M, D, MLP, e5, st);
}
