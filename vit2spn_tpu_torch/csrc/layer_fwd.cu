// One ViT layer's forward for Hopper (sm_90a), bf16 or fp32 in and out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_fwd_kernel (reached through
// _fused_fwd_impl and fused_block, the per-layer path attn_impl="fused_layer"
// runs under lax.scan), the Pallas TPU kernel that runs one pre-LN block over
// a tile of images with the activations resident in VMEM and emits the
// layer's output and its mid-residual x2, both in the input dtype, for the
// split backward. It is _block_fwd_math once: the same function as one layer
// of _backbone_fwd_kernel.
//
// So this source runs the layer code of csrc/layer_fwd.cuh once, the code
// csrc/backbone_fwd.cu runs for every layer (the header says what bounds it
// and why it is built as it is): three launches for D <= 256 (LN1 + QKV, attention, Wo through
// W2), five above, on the caller's stream; a loop of these calls gives the
// backbone kernel's output bit for bit. x2 is written as bf16 by the same
// epilogue that writes the backbone's x2s stack. fp32 (compute_dtype=
// float32): the seven-launch CUDA-core layer of csrc/layer_fwd_f32.cuh, the
// backbone's fp32 layer code. Limits: head_dim 64, S <= 256, D <= 768, D and
// mlp multiples of 64.

#include "layer_fwd.cuh"
#include "layer_fwd_f32.cuh"

// x, out: (B * S, D) bf16; x2 (optional): (B * S, D) bf16; weights as one
// layer's slices of the stacked arrays. Scratch as launch_layer's: qkv_buf
// (B * S + QKV_PAD_ROWS rows of 3 D, the pad rows zeroed here), att_buf, and
// above FUSED_MLP_MAX_D x2_buf (fp32) and g_buf (null below it).
extern "C" int vit2spn_layer_fwd(
    const void* x, void* out, void* x2,
    const void* ln1_scale, const void* ln1_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* ln2_scale, const void* ln2_bias,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* qkv_buf, void* att_buf, void* x2_buf, void* g_buf,
    int B, int S, int D, int H, int MLP, float eps, int fast_gelu, void* stream) {
  if (!layer_shape_ok(B, S, D, H, MLP)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* w[12] = {ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2};
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* att = static_cast<bf16*>(att_buf);
  bf16* g = static_cast<bf16*>(g_buf);
  LayerMaps maps;
  LAUNCH(layer_maps(&maps, w, 1, D, MLP, B * S, static_cast<const bf16*>(x),
                    static_cast<const bf16*>(out), qkv, att, g));
  LAUNCH(zero_qkv_pad(qkv, B * S, D, st));
  return launch_layer(static_cast<const bf16*>(x), static_cast<bf16*>(out), nullptr,
                      static_cast<bf16*>(x2), layer_weights(w, 0, D, MLP), maps, 0, qkv, att,
                      static_cast<float*>(x2_buf), g, B, S, D, H, MLP, eps, fast_gelu, st);
}

extern "C" int vit2spn_layer_fwd_qkv_pad_rows() { return QKV_PAD_ROWS; }

extern "C" int vit2spn_layer_fwd_launches(int D, int fp32) {
  return fp32 ? LAYER_F32_LAUNCHES : launches_per_layer(D);
}

// fp32: x, out, x2 (optional) (B * S, D), weights one layer's fp32 arrays;
// scratch as vit2spn_backbone_fwd_f32's.
extern "C" int vit2spn_layer_fwd_f32(
    const void* x, void* out, void* x2,
    const void* ln1_scale, const void* ln1_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* ln2_scale, const void* ln2_bias,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* y_buf, void* qkv_buf, void* att_buf, void* x2_buf, void* g_buf,
    int B, int S, int D, int H, int MLP, float eps, int fast_gelu, void* stream) {
  if (!layer_shape_ok(B, S, D, H, MLP)) return (int)cudaErrorInvalidValue;
  const void* w[12] = {ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2};
  return launch_layer_f32(static_cast<const float*>(x), static_cast<float*>(out), nullptr,
                          static_cast<float*>(x2), w, 0, static_cast<float*>(y_buf),
                          static_cast<float*>(qkv_buf), static_cast<float*>(att_buf),
                          static_cast<float*>(x2_buf), static_cast<float*>(g_buf), B, S, D, H,
                          MLP, eps, fast_gelu, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory per block of kernel 0 (LN1 + QKV), 1 (attention at
// S) or 2 (Wo through W2; above FUSED_MLP_MAX_D the largest of its three
// row-block GEMMs)
extern "C" int vit2spn_layer_fwd_smem_bytes(int S, int D, int kernel) {
  if (kernel == 0)
    return D <= FUSED_MLP_MAX_D ? rb_smem_bytes<QKV_WG, QKV_NT, A_LN_BF16, EPI_BIAS>(D)
                                : rb_smem_bytes<1, QKV_NT, A_LN_BF16, EPI_BIAS>(D);
  if (kernel == 1) return attention_smem_bytes(S);
  switch (D) {
    case 64: return MlpTile<64>::SMEM;
    case 128: return MlpTile<128>::SMEM;
    case 192: return MlpTile<192>::SMEM;
    case 256: return MlpTile<256>::SMEM;
    default: return rb_smem_bytes<1, 64, A_LN_F32, EPI_GELU>(D);
  }
}
