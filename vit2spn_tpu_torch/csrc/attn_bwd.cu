// Attention half of one ViT layer's backward for Hopper (sm_90a): bf16 or
// fp32 in and out.
//
// Replaces: vit2spn_tpu/ops/fused_block.py::_attn_bwd_kernel (the Pallas TPU
// kernel run by _layer_bwd for every layer of _backbone_vjp_bwd, after
// _mlp_bwd_kernel), which recomputes LN1, QKV and attention from the layer
// input x and emits dx and the LN1 / attention weight gradients, in whatever
// dtype its inputs carry. The launch sequences, what bounds them and the
// design: csrc/attn_bwd.cuh. bf16 at D <= 256 runs the wgmma row-block kit
// (six launches), bf16 at D = 384, 768 and 1024 its wide route (seven), bf16 at
// other widths above 256 and at the general geometry (head_dim 16, 32, 48,
// 80; D a multiple of 32 up to 1280) the eleven-launch sequence, fp32 the same sequence
// with the CUDA-core attention of csrc/flash_f32.cuh (thirteen).

#include "attn_bwd.cuh"

// fp32 scratch the wrapper allocates for the split partials (and the fp32
// attention's row statistics)
extern "C" long long vit2spn_attn_bwd_workspace_floats(int B, int S, int D, int H, int fp32) {
  if (H <= 0 || !hopper_route(D, fp32, 64, D / H)) return (long long)attn_seq_workspace(B, S, D, H);
  AttnBwdArgs a = {};
  a.B = B;
  a.S = S;
  a.D = D;
  a.H = H;
  long long need = 0;
  return attn_bwd_hopper(a, 0, true, &need) == 0 ? need : -1;
}

// The backward's attention core alone (bf16): att (B * S, D) and dqkv (B *
// S, 3 D) from qkv (B * S, 3 D) and datt (B * S, D), the launch
// vit2spn_attn_bwd makes for it; for holding the core against its twin and
// timing it by itself.
extern "C" int vit2spn_attention_core(const void* qkv, const void* datt, void* att, void* dqkv,
                                      int B, int S, int H, int D, void* stream) {
  if (!geometry_ok(B, S, D, H, 64)) return (int)cudaErrorInvalidValue;
  return launch_attention_bwd(static_cast<const bf16*>(qkv), static_cast<const bf16*>(datt),
                              static_cast<bf16*>(att), static_cast<bf16*>(dqkv), B, S, H, D,
                              static_cast<cudaStream_t>(stream));
}

// The fp32 backward's attention core alone, as attn_bwd_seq<float> makes it
// (csrc/flash_f32.cuh: the forward for att, then the backward pair): att and
// dqkv from qkv and datt, fp32; ws: B * H * S * 3 floats (the row
// statistics); `multipass` set takes the multi-pass route above 256 keys at
// any S
extern "C" int vit2spn_attention_core_f32(const void* qkv, const void* datt, void* att,
                                          void* dqkv, void* ws, int B, int S, int H, int D,
                                          int multipass, void* stream) {
  if (!geometry_ok(B, S, D, H, 64)) return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(qkv);
  float* dq = static_cast<float*>(dqkv);
  const int dh = D / H;
  const float scale = attention_scale(dh);
  const long long ts = 3LL * D, bs = (long long)S * ts;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LAUNCH(fwd_f32(q, q + D, q + 2 * D, static_cast<float*>(att), B, S, H, dh, bs, ts, scale, st,
                 multipass != 0));
  return bwd_f32(q, q + D, q + 2 * D, static_cast<const float*>(datt), dq, dq + D, dq + 2 * D,
                 static_cast<float*>(ws), B, S, H, dh, bs, ts, ts, scale, st, multipass != 0);
}

// The longest S the bf16 core takes above 256 keys at head_dim dh:
// csrc/long_attention.cuh keeps three fp32 statistics a query in shared
// memory beside its ring (csrc/general_long.cuh's core, which keeps them
// beside smaller staged tiles, takes the same limit at 16-48, and less at
// 80, whose staged rows are wider); 0 for a head_dim the kernels refuse
extern "C" int vit2spn_attention_core_max_seq(int dh) {
  return head_dim_ok(dh) ? attention_core_max_seq(dh) : 0;
}

// s = q k^T and st = k q^T (64 x 64 fp32) of one pair of 64 x 64 bf16 tiles
// through the long core's score products (long_scores_probe): whether its
// key-major phase's scores equal its query passes' bit for bit
extern "C" int vit2spn_long_scores_probe(const void* q, const void* k, void* s, void* st,
                                         void* stream) {
  return launch_long_scores_probe(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                  static_cast<float*>(s), static_cast<float*>(st),
                                  static_cast<cudaStream_t>(stream));
}

// The long routes' branch-free quotient against __fdiv_rn on n pairs and
// the edges (long_quotient_probe); counts: 4 zeroed uint64
extern "C" int vit2spn_long_quotient_probe(long long n, void* counts, void* stream) {
  return launch_long_quotient_probe((unsigned long long)n,
                                    static_cast<unsigned long long*>(counts),
                                    static_cast<cudaStream_t>(stream));
}

// CUDA kernel launches one call makes
extern "C" int vit2spn_attn_bwd_launches(int D, int fp32, int H, int MLP) {
  (void)MLP;
  if (H > 0 && hopper_route(D, fp32, 64, D / H))
    return wide_route(D) ? ATTN_WIDE_LAUNCHES : ATTN_HOPPER_LAUNCHES;
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
  if (!geometry_ok(B, S, D, H, 64)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AttnBwdArgs a = {x, dx2, ln1_scale, ln1_bias, wqkv, bqkv, wo, dx, gln1_scale, gln1_bias,
                         gwqkv, gbqkv, gwo, gbo, y1_buf, qkv_buf, datt_buf, att_buf, dqkv_buf,
                         dy_buf, ws_buf, B, S, D, H, eps};
  if (fp32) return attn_bwd_seq<float>(a, st);
  if (hopper_route(D, fp32, 64, D / H)) return attn_bwd_hopper(a, st);
  return attn_bwd_seq<bf16>(a, st);
}
