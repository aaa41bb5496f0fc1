// csrc/general_long.cuh's launchers as C entries that take any S, for
// tools/gl_short_probe.py: the head_dim 16-48 routes written for S > 256
// keys, called at S <= 256, where the register-row kernels run
// (attention_bwd_kernel, flash_fwd_tc, flash_bwd_rows_tc / _cols_tc).
// Built by the probe with cuda_build.NVCC_FLAGS and -I csrc; nothing of the
// package loads it.

#include <type_traits>

#include "general_long.cuh"

template <class F>
static int by_dh(int dh, F&& f) {
  switch (dh) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// att (B S, D) from qkv (B S, 3 D), as vit2spn_attention_stage
extern "C" int gl_probe_stage(const void* qkv, void* att, int B, int S, int H, int D,
                              void* stream) {
  return by_dh(D / H, [&](auto d) {
    return gl_launch_stage<decltype(d)::value>(static_cast<const bf16*>(qkv),
                                               static_cast<bf16*>(att), B, S, H, D,
                                               static_cast<cudaStream_t>(stream));
  });
}

// att and dqkv from qkv and datt, as vit2spn_attention_core
extern "C" int gl_probe_core(const void* qkv, const void* datt, void* att, void* dqkv, int B,
                             int S, int H, int D, void* stream) {
  return by_dh(D / H, [&](auto d) {
    return gl_launch_core<decltype(d)::value>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(datt), static_cast<bf16*>(att),
        static_cast<bf16*>(dqkv), B, S, H, D, static_cast<cudaStream_t>(stream));
  });
}

// o contiguous (B, S, H, dh) from q, k, v read through (bs, ts), as
// vit2spn_flash_fwd in bf16
extern "C" int gl_probe_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                  int S, int H, int dh, long long bs, long long ts,
                                  void* stream) {
  return by_dh(dh, [&](auto d) {
    return gl_launch_flash_fwd<decltype(d)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), B, S, H, bs, ts, static_cast<cudaStream_t>(stream));
  });
}

// dq, dk, dv contiguous, as vit2spn_flash_bwd in bf16; ws:
// gl_probe_ws_floats(B, S, H) floats
extern "C" int gl_probe_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  void* dq, void* dk, void* dv, void* ws, int B, int S, int H,
                                  int dh, long long bs, long long ts, void* stream) {
  return by_dh(dh, [&](auto d) {
    return gl_launch_flash_bwd<decltype(d)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), static_cast<float*>(ws), B, S, H, bs, ts,
        static_cast<cudaStream_t>(stream));
  });
}

// the flash backward's workspace: 3 x 64 floats a 64-query chunk
// (gl_flash_rows_kernel writes every row of its tiles, S <= 256 too)
extern "C" long long gl_probe_ws_floats(int B, int S, int H) {
  return long_flash_bwd_ws_floats(B, S, H);
}
