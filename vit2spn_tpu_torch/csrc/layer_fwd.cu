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
// and why it is built as it is): three launches for D <= 256 (LN1 + QKV,
// attention, Wo through W2), seven above (two LayerNorms and four GEMMs
// beside the attention), on the caller's stream; a loop of these calls gives
// the backbone kernel's output bit for bit. x2 is written as bf16 by the same
// epilogue that writes the backbone's x2s stack. fp32 (compute_dtype=
// float32): the seven-launch CUDA-core layer of csrc/layer_fwd_seq.cuh, the
// backbone's fp32 layer code, which the general geometry (head_dim 16, 32
// or 48, or D or mlp not a multiple of 64) also takes in bf16, as the
// backbone does. Limits: head_dim 16, 32, 48, 64 or 80, D a multiple of 32 up to
// 1024, mlp a multiple of 32; any S.

#include "layer_fwd.cuh"
#include "layer_fwd_seq.cuh"

// x, out: (B * S, D) bf16; x2 (optional): (B * S, D) bf16; weights as one
// layer's slices of the stacked arrays. Scratch as launch_layer's: qkv_buf
// (B * S rows of 3 D), att_buf, and above FUSED_MLP_MAX_D y_buf (bf16),
// x2_buf (fp32) and g_buf (null below it, except on the general route).
extern "C" int vit2spn_layer_fwd(
    const void* x, void* out, void* x2,
    const void* ln1_scale, const void* ln1_bias, const void* wqkv, const void* bqkv,
    const void* wo, const void* bo, const void* ln2_scale, const void* ln2_bias,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* qkv_buf, void* att_buf, void* y_buf, void* x2_buf, void* g_buf,
    int B, int S, int D, int H, int MLP, float eps, int fast_gelu, void* stream) {
  if (!geometry_ok(B, S, D, H, MLP)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* w[12] = {ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2};
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* y = static_cast<bf16*>(y_buf);
  if (general_route(D, H, MLP)) {
    if (!y || !x2_buf || !g_buf) return (int)cudaErrorInvalidValue;
    return launch_layer_seq<bf16>(static_cast<const bf16*>(x), static_cast<bf16*>(out), nullptr,
                                  static_cast<bf16*>(x2), w, 0, y, qkv,
                                  static_cast<bf16*>(att_buf), static_cast<float*>(x2_buf),
                                  static_cast<bf16*>(g_buf), B, S, D, H, MLP, eps, fast_gelu, st);
  }
  LayerMaps maps;
  LAUNCH(layer_maps(&maps, w, 1, D, MLP, B, S, static_cast<const bf16*>(x),
                    static_cast<const bf16*>(out), qkv, static_cast<const bf16*>(att_buf), y,
                    static_cast<const bf16*>(g_buf)));
  return launch_layer(static_cast<const bf16*>(x), nullptr, static_cast<bf16*>(x2),
                      layer_weights(w, 0, D, MLP), maps, 0, qkv, y,
                      static_cast<float*>(x2_buf), B, S, D, H, MLP, eps, fast_gelu, st);
}

// The layer's attention stage alone (bf16): att (B * S, D) from qkv (B * S,
// 3 D), the launch vit2spn_layer_fwd makes for it (head_dim D / H; at 16,
// 32 and 48 the general route's, above 256 keys csrc/general_long.cuh's);
// for holding the stage against its twin and timing it by itself.
extern "C" int vit2spn_attention_stage(const void* qkv, void* att, int B, int S, int H, int D,
                                       void* stream) {
  if (!geometry_ok(B, S, D, H, 64)) return (int)cudaErrorInvalidValue;
  if (D != H * ATT_DH)
    return launch_attention_fwd_general(static_cast<const bf16*>(qkv), static_cast<bf16*>(att),
                                        B, S, H, D, static_cast<cudaStream_t>(stream));
  LayerMaps mp;
  LAUNCH(tensor_map(&mp.qkv_img, qkv, 3 * D, S, B));
  LAUNCH(tensor_map(&mp.att_img, att, D, S, B));
  mp.att_buf = static_cast<bf16*>(att);
  return launch_layer_attention(mp, B, S, D, H, static_cast<cudaStream_t>(stream));
}

// The fp32 layer's attention stage alone (csrc/flash_f32.cuh, as
// launch_layer_seq<float> makes it): att (B * S, D) from qkv (B * S, 3 D),
// fp32; `multipass` set takes the multi-pass route above 256 keys at any S
// (head_dim 64; head_dim 16, 32 and 48 take it above 256 keys anyway)
extern "C" int vit2spn_attention_stage_f32(const void* qkv, void* att, int B, int S, int H,
                                           int D, int multipass, void* stream) {
  if (!geometry_ok(B, S, D, H, 64)) return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  const long long ts = 3LL * D;
  return fwd_f32(q, q + D, q + 2 * D, static_cast<float*>(att), B, S, H, D / H, S * ts, ts,
                 attention_scale(D / H), static_cast<cudaStream_t>(stream), multipass != 0);
}

extern "C" int vit2spn_layer_fwd_launches(int D, int fp32, int H, int MLP) {
  return fp32 ? LAYER_SEQ_LAUNCHES : launches_per_layer(D, H, MLP);
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
  if (!geometry_ok(B, S, D, H, MLP)) return (int)cudaErrorInvalidValue;
  const void* w[12] = {ln1_scale, ln1_bias, wqkv, bqkv, wo, bo,
                       ln2_scale, ln2_bias, w1, b1, w2, b2};
  return launch_layer_seq<float>(static_cast<const float*>(x), static_cast<float*>(out), nullptr,
                                 static_cast<float*>(x2), w, 0, static_cast<float*>(y_buf),
                                 static_cast<float*>(qkv_buf), static_cast<float*>(att_buf),
                                 static_cast<float*>(x2_buf), static_cast<float*>(g_buf), B, S, D,
                                 H, MLP, eps, fast_gelu, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory per block of kernel 0 (LN1 + QKV; above
// FUSED_MLP_MAX_D the QKV GEMM), 1 (attention at S) or 2 (Wo through W2;
// above FUSED_MLP_MAX_D the largest of their three GEMMs)
extern "C" int vit2spn_layer_fwd_smem_bytes(int S, int D, int kernel) {
  if (kernel == 1) return S > ATT_MAX_S ? (int)long_fwd_smem() : attention_smem_bytes(S);
  if (kernel == 0)
    return D <= FUSED_MLP_MAX_D ? rb_smem_bytes<QKV_WG, QKV_NT, A_LN_BF16, EPI_BIAS>(D)
                                : tile_gemm_smem_bytes<EPI_BIAS>(3 * D);
  switch (D) {
    case 64: return MlpTile<64>::SMEM;
    case 128: return MlpTile<128>::SMEM;
    case 192: return MlpTile<192>::SMEM;
    case 256: return MlpTile<256>::SMEM;
    default: break;
  }
  // MLP: the widths of W1 (mlp columns) and of Wo and W2 (D columns) at the
  // caller's D; the largest of the three at mlp = 4 D
  const int a = tile_gemm_smem_bytes<EPI_RESID>(D), b = tile_gemm_smem_bytes<EPI_GELU>(4 * D),
            c = tile_gemm_smem_bytes<EPI_OUT>(D);
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
