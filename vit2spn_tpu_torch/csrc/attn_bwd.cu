// Attention half of one ViT layer's backward for Hopper (sm_90a): bf16 or
// fp32 in and out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_attn_bwd_kernel (the Pallas TPU
// kernel run by _layer_bwd for every layer of _backbone_vjp_bwd, after
// _mlp_bwd_kernel), which recomputes LN1, QKV and attention from the layer
// input x and emits dx and the LN1 / attention weight gradients, in whatever
// dtype its inputs carry. The launch sequences, what bounds them and the
// design: csrc/attn_bwd.cuh. bf16 at D <= 256 runs the wgmma row-block kit
// (six launches), bf16 above it the eleven-launch sequence, fp32 the same
// sequence with the CUDA-core attention of csrc/flash_f32.cuh (thirteen).

#include "attn_bwd.cuh"

static bool hopper_route(int D, int fp32) { return !fp32 && D <= HOPPER_BWD_MAX_D; }

// fp32 scratch the wrapper allocates for the split partials (and the fp32
// attention's row statistics)
extern "C" long long vit2spn_attn_bwd_workspace_floats(int B, int S, int D, int H, int fp32) {
  if (!hopper_route(D, fp32)) return (long long)attn_seq_workspace(B, S, D, H);
  AttnBwdArgs a = {};
  a.B = B;
  a.S = S;
  a.D = D;
  a.H = H;
  long long need = 0;
  return attn_bwd_hopper(a, 0, true, &need) == 0 ? need : -1;
}

// CUDA kernel launches one call makes
extern "C" int vit2spn_attn_bwd_launches(int D, int fp32) {
  if (hopper_route(D, fp32)) return ATTN_HOPPER_LAUNCHES;
  return fp32 ? attn_seq_launches<float>() : attn_seq_launches<bf16>();
}

// x, dx2, dx: (B * S, D), all bf16 or (fp32 set) all fp32, as the matmul
// weights wqkv (D, 3D), bqkv (3D), wo (D, D); LN parameters fp32 (D).
// Gradients fp32: gwqkv (D, 3D), gbqkv (3D), gwo (D, D), gbo (D), gln1_scale,
// gln1_bias (D). Scratch in the activations' dtype: y1, datt, att (M, D),
// qkv and dqkv (M, 3D); dy (M, D) fp32 (null on the bf16 route at D <=
// 256); ws (workspace_floats) fp32.
extern "C" int vit2spn_attn_bwd(
    const void* x, const void* dx2, const void* ln1_scale, const void* ln1_bias,
    const void* wqkv, const void* bqkv, const void* wo,
    void* dx, void* gln1_scale, void* gln1_bias, void* gwqkv, void* gbqkv, void* gwo, void* gbo,
    void* y1_buf, void* qkv_buf, void* datt_buf, void* att_buf, void* dqkv_buf, void* dy_buf,
    void* ws_buf, int B, int S, int D, int H, float eps, int fp32, void* stream) {
  if (B <= 0 || S <= 0 || S > AB_MAX_S || H <= 0 || D != H * DH || D > LN_MAX_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnBwdArgs a = {x, dx2, ln1_scale, ln1_bias, wqkv, bqkv, wo, dx, gln1_scale, gln1_bias,
                         gwqkv, gbqkv, gwo, gbo, y1_buf, qkv_buf, datt_buf, att_buf, dqkv_buf,
                         dy_buf, ws_buf, B, S, D, H, eps};
  if (fp32) return attn_bwd_seq<float>(a, st);
  if (hopper_route(D, fp32)) return attn_bwd_hopper(a, st);
  return attn_bwd_seq<bf16>(a, st);
}
