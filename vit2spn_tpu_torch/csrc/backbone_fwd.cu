// Whole-backbone ViT forward for Hopper (sm_90a), bf16 or fp32 in and out.
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
// What bounds it, and the design: see csrc/layer_fwd.cuh, whose layer code
// this source runs for every layer: three launches per layer for D <= 256
// (LN1 + QKV, attention, Wo through W2 with LN2 and gelu), five above. The
// weight matrices are read through TMA maps of the stacked arrays, built
// once per call, the layer as their third coordinate. fp32
// (compute_dtype=float32): the seven-launch CUDA-core layer of
// csrc/layer_fwd_f32.cuh per layer. Limits: head_dim 64, S <= 256, D <= 768,
// D and mlp multiples of 64.

#include "layer_fwd.cuh"
#include "layer_fwd_f32.cuh"

// ---------------------------------------------------------------------------
// Host entry: the layer loop on the caller's stream
// ---------------------------------------------------------------------------

// qkv_buf holds (B * S + QKV_PAD_ROWS) rows of 3 * D; the pad rows are
// zeroed here on every call. att_buf holds B * S rows of D; x2_buf (fp32) and
// g_buf (B * S rows of MLP) are read only above FUSED_MLP_MAX_D and may be
// null below it.
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
  bf16* att = static_cast<bf16*>(att_buf);
  bf16* g = static_cast<bf16*>(g_buf);
  LayerMaps maps;
  LAUNCH(layer_maps(&maps, w, L, D, MLP, (int)M, static_cast<const bf16*>(x), o, qkv, att, g));
  LAUNCH(zero_qkv_pad(qkv, (int)M, D, st));
  for (int l = 0; l < L; ++l) {
    // layer 0 reads the caller's input; later layers update `out` in place
    const bf16* cur = (l == 0) ? static_cast<const bf16*>(x) : o;
    LAUNCH(launch_layer(cur, o, xs ? static_cast<bf16*>(xs) + l * M * D : nullptr,
                        x2s ? static_cast<bf16*>(x2s) + l * M * D : nullptr,
                        layer_weights(w, l, D, MLP), maps, l, qkv, att,
                        static_cast<float*>(x2_buf), g, B, S, D, H, MLP, eps, fast_gelu, st));
  }
  return (int)cudaSuccess;
}

extern "C" int vit2spn_backbone_fwd_qkv_pad_rows() { return QKV_PAD_ROWS; }

extern "C" int vit2spn_backbone_fwd_launches_per_layer(int D, int fp32) {
  return fp32 ? LAYER_F32_LAUNCHES : launches_per_layer(D);
}

// fp32: x, out (B * S, D), xs / x2s (optional, L x B * S x D) and the
// matmul weights and biases fp32, as the LN parameters. Scratch (fp32): y_buf
// and att_buf (B * S rows of D), qkv_buf (of 3 D), x2_buf (of D), g_buf (of
// MLP).
extern "C" int vit2spn_backbone_fwd_f32(
    const void* x, void* out, void* xs, void* x2s,
    const void* ln1_scale, const void* ln1_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* ln2_scale, const void* ln2_bias,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* y_buf, void* qkv_buf, void* att_buf, void* x2_buf, void* g_buf,
    int B, int S, int D, int H, int MLP, int L, float eps, int fast_gelu, void* stream) {
  if (L <= 0 || !layer_shape_ok(B, S, D, H, MLP)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t M = (size_t)B * S;
  const void* w[12] = {ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2};
  float* o = static_cast<float*>(out);
  for (int l = 0; l < L; ++l) {
    const float* cur = (l == 0) ? static_cast<const float*>(x) : o;
    LAUNCH(launch_layer_f32(cur, o, xs ? static_cast<float*>(xs) + l * M * D : nullptr,
                            x2s ? static_cast<float*>(x2s) + l * M * D : nullptr, w, l,
                            static_cast<float*>(y_buf), static_cast<float*>(qkv_buf),
                            static_cast<float*>(att_buf), static_cast<float*>(x2_buf),
                            static_cast<float*>(g_buf), B, S, D, H, MLP, eps, fast_gelu, st));
  }
  return (int)cudaSuccess;
}
