// Attention above 256 tokens for Hopper (sm_90a), bf16 in and out: the S >
// 256 route of the port's four bf16 attention kernels.
//
// Replaces, for sequences longer than the 256 keys a row of scores in
// registers can hold (384 px images: S = 577; the folder datasets at 256 px:
// S = 257), the attention of these Pallas TPU kernels, which pad the
// sequence in VMEM and take the softmax over the whole padded row at once:
//
//   vit2spn_tpu/ops/fused_block.py::_attention (inside _backbone_fwd_kernel
//     and _fwd_kernel)               -> long_attention_fwd<false>, the
//                                       forward layer's attention stage
//                                       (csrc/layer_fwd.cuh)
//   ::_attention_bwd with the att it recomputes (inside _attn_bwd_kernel and
//     _merged_bwd_kernel)            -> long_attention_bwd_kernel, the
//                                       backward's attention core
//                                       (csrc/attention_bwd.cuh)
//   vit2spn_tpu/ops/flash_attention.py::_fwd_kernel
//                                    -> long_attention_fwd<true>
//   ::_bwd_kernel                    -> long_flash_bwd_rows, then
//                                       long_flash_bwd_cols
//                                       (csrc/flash_attention.cu)
//
// Each computes its Pallas function with the same rounding points, per
// (image, head), over S keys:
//
//   s = fp32(q k^T) * 1/8, keys >= S at -1e30 (probability exactly 0)
//   m = the row max over ALL keys;  l = sum of exp(s - m);  p = exp(s - m) / l
//   fused block: att = bf16(bf16(p) v); dV = bf16(p)^T dO; dP = dO v^T;
//                dS = bf16(p (dP - rowsum(dP p))); dQ = dS k / 8; dK = dS^T q / 8
//   flash:       o = p v, dV = p^T dO, dQ, dK as above with p and dS in fp32
//                (two bf16 terms each, hi = bf16(x) and lo = bf16(x - hi), as
//                the S <= 256 flash kernels take them)
//
// with queries >= S out of dK and dV. A running-max (online) softmax would
// rescale partial sums by exp(m_old - m_new) and round at other points: a
// different function. So p is only formed once the row's max and sum over
// every key are known, and no sum is ever rescaled.
//
// The design: several passes over the keys, nothing of a row's scores kept
// between them. Keeping a query tile's fp32 scores in shared memory instead
// (64 x S floats: 148 KB at S = 577, 262 KB at S = 1024) would cap S near
// 900 at 64 queries a tile; recomputing the scores costs tensor-core
// operations only, which the card has to spare at these sizes, and leaves S
// unbounded. A warp owns 16 rows (queries; keys in the backward's key-major
// pass) as mma.sync A fragments in registers, and the block streams the
// other side through shared memory in chunks of LA_CHUNK = 64 rows, two
// chunks in flight (cp.async, zeros past S). Per 16-row tile:
//
//   pass 1   s for every key: the row max m        (q k^T)
//   pass 2   s again: l = sum exp(s - m)           (q k^T)
//   forward  s again: p, then o += p v             (q k^T, p v)
//   backward pass 3: p, dP: rowsum(dP p) (and the fused block's att += bf16(p) v);
//            pass 4: p, dP: dS, dQ += dS k;
//            key-major: per 16 keys, every query in 16-row steps: s and dP
//            recomputed with queries as rows (the operands in the query
//            passes' roles: the same mma on the same fragments, so the same
//            bits), p and dS from the row statistics, transposed with
//            movmatrix, dV += p^T dO and dK += dS^T q in registers.
//
// The scores are scaled with __fmul_rn (1/8 is a power of two, so this is
// exact) and s - m is __fsub_rn, the quotient the IEEE division (p / l with
// nvcc's default -prec-div): the layer forward's fast reciprocal path is
// exact only for l <= 256, and l can reach S. Every sum runs in one fixed
// order inside one warp (per lane over chunks in key order, then the quad's
// shuffles), with no atomics, so two runs give the same bits, and the
// forward stage and the backward core, which call the same passes, give the
// same att bits at the same S.
//
// What bounds it on this card: at ViT-Base/16-384 (S = 577, 12 heads, B =
// 64) the function's products are 32.7 GFLOP each (2 S^2 64 per (image,
// head)), 2 in the forward and 6 in the backward, against 56.7 MB (forward)
// to 113 MB (backward) of q, k, v, dO and outputs: operations, at 989
// TFLOP/s, beside 0.017-0.034 ms of bytes. These routes recompute the
// scores in every pass (4 products in the forward, 12 in the backward) on
// mma.sync, which reaches a fraction of wgmma's rate: right first, fast in
// a later pass. Limits: head_dim 64; rows 16-byte aligned; the fused
// backward core keeps three fp32 statistics a query in shared memory, so S
// <= 13,056 at LA_CORE_WARPS = 8 (long_core_smem within LA_MAX_SMEM).

#pragma once

#include "common.cuh"

#define LA_CHUNK 64  // rows of the streamed side per staged chunk
#ifndef LA_ROW_WARPS
#define LA_ROW_WARPS 4  // the forward and flash kernels: 16 rows a warp
#endif
#ifndef LA_ROW_MINB
#define LA_ROW_MINB 4  // their blocks an SM must hold (caps the registers at 128)
#endif
#ifndef LA_CORE_WARPS
#define LA_CORE_WARPS 8  // the fused backward core: one block per (image, head)
#endif
#ifndef LA_CORE_MINB
// two cores an SM (128 registers, a few spills) against one (172): 3.32
// against 4.57 ms a launch at B = 64, S = 577, 12 heads; the flash backward
// 3.33 against 4.17 (tools/long_seq_sweep.py, H100 at 700 W)
#define LA_CORE_MINB 2
#endif
#define LA_SCALE 0.125f  // 1 / sqrt(head_dim 64)
// one slot of the chunk ring: two operands of LA_CHUNK rows, and three fp32
// row statistics per row of the chunk (the flash backward's key-major pass)
#define LA_SLOT_BF16 (2 * LA_CHUNK * TILE_LD)
#define LA_SLOT_BYTES (LA_SLOT_BF16 * 2 + 3 * LA_CHUNK * 4)
#define LA_MAX_SMEM 232448  // dynamic shared memory a block may take (227 KB)

// one operand of the attention: element (image b, token s, head h, dim d) at
// p + b bs + s ts + h 64 + d
struct LaOp {
  const bf16* p;
  long long bs, ts;
};

// the rows of one (image, head) of an operand: row r at p + r ts
struct LaRows {
  const bf16* p;
  long long ts;
};

__device__ __forceinline__ LaRows la_rows(const LaOp& op, int b, int h) {
  return {op.p + (long long)b * op.bs + h * TILE_DH, op.ts};
}

// ---------------------------------------------------------------------------
// Fragment helpers (shared with the S <= 256 flash kernels)
// ---------------------------------------------------------------------------

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_f32(__fsub_rn(x0, __bfloat162float(h0)), __fsub_rn(x1, __bfloat162float(h1)));
}

// two 16 x 8 fp32 C tiles side by side as the hi and lo terms of one 16 x 16
// A operand
__device__ __forceinline__ void split_a(uint32_t hi[4], uint32_t lo[4], const float x0[4],
                                        const float x1[4]) {
  split_pair(x0[0], x0[1], hi[0], lo[0]);
  split_pair(x0[2], x0[3], hi[1], lo[1]);
  split_pair(x1[0], x1[1], hi[2], lo[2]);
  split_pair(x1[2], x1[3], hi[3], lo[3]);
}

// the same for the transpose of the 16 x 16 tile whose columns 8n .. 8n + 7
// are the C tile x[n]: quarter (rows 8h.., columns 8n..) becomes A fragment
// 2h + n once movmatrix has transposed it
__device__ __forceinline__ void split_a_t(uint32_t hi[4], uint32_t lo[4], const float x[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t a, b;
      split_pair(x[n][2 * h], x[n][2 * h + 1], a, b);
      hi[2 * h + n] = movmatrix_t(a);
      lo[2 * h + n] = movmatrix_t(b);
    }
}

// the transpose as one bf16 term (the fused block's bf16(p) and bf16(dS))
__device__ __forceinline__ void pack_a_t(uint32_t a[4], const float x[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 2; ++n) a[2 * h + n] = movmatrix_t(pack_f32(x[n][2 * h], x[n][2 * h + 1]));
}

// acc (16 x 64) += (hi + lo) (16 x 16) times the 16 staged rows at `rows`:
// mma_rows with both terms on one load of the B fragments
__device__ __forceinline__ void mma_rows_split(float acc[8][4], const uint32_t hi[4],
                                               const uint32_t lo[4], const bf16* rows,
                                               int lane) {
  const bf16* p =
      rows + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * TILE_LD + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < TILE_DH / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + np * 16);
    mma_bf16(acc[2 * np], hi, b[0], b[1]);
    mma_bf16(acc[2 * np], lo, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
  }
}

__device__ __forceinline__ void zero_acc(float acc[8][4]) {
#pragma unroll
  for (int n = 0; n < TILE_DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// acc += x (16 x 16 fp32, the C tiles x0 | x1) times 16 staged rows: one
// bf16 term (the fused block) or two (flash)
template <bool SPLIT>
__device__ __forceinline__ void la_mma_p(float acc[8][4], const float x0[4], const float x1[4],
                                         const bf16* rows, int lane) {
  if constexpr (SPLIT) {
    uint32_t hi[4], lo[4];
    split_a(hi, lo, x0, x1);
    mma_rows_split(acc, hi, lo, rows, lane);
  } else {
    uint32_t a[4];
    pack_a(a, x0, x1);
    mma_rows(acc, a, rows, lane);
  }
}

// the same with the transpose of the 16 x 16 tile x[0] | x[1]
template <bool SPLIT>
__device__ __forceinline__ void la_mma_p_t(float acc[8][4], const float x[2][4],
                                           const bf16* rows, int lane) {
  if constexpr (SPLIT) {
    uint32_t hi[4], lo[4];
    split_a_t(hi, lo, x);
    mma_rows_split(acc, hi, lo, rows, lane);
  } else {
    uint32_t a[4];
    pack_a_t(a, x);
    mma_rows(acc, a, rows, lane);
  }
}

// the sum, or the max, of one row over the 4 lanes of its row group
__device__ __forceinline__ float la_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float la_quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int N>
__device__ __forceinline__ void la_wait() {  // all but the newest N cp.async groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Staging and the chunk loop
// ---------------------------------------------------------------------------

// rows r0 .. r0 + n - 1 of `src` into dst, TILE_LD apart, by threads tid of
// nt with cp.async; rows >= S are zeros
__device__ __forceinline__ void la_stage(bf16* dst, const LaRows& src, int r0, int n, int S,
                                         int tid, int nt) {
  for (int i = tid; i < n * (TILE_DH / 8); i += nt) {
    const int r = i / (TILE_DH / 8), c = (i % (TILE_DH / 8)) * 8;
    const bool live = r0 + r < S;
    cp_async16(dst + r * TILE_LD + c, src.p + (live ? (long long)(r0 + r) * src.ts : 0) + c,
               live);
  }
}

// Every chunk of the streamed side, in order: rows LA_CHUNK c .. of `a` (and
// of `b` when `two`; of the statistics `st`, three floats a row, when it is
// not null) land in slot c % 2 of the ring `ring` (2 LA_SLOT_BYTES) while
// chunk c - 1 is worked on; f(c, a rows, b rows, statistics) runs with every
// thread of the block between two barriers, so every warp of the block must
// call this the same number of times.
template <class F>
__device__ __forceinline__ void la_chunks(unsigned char* ring, const LaRows& a, const LaRows& b,
                                          bool two, const float* st, int S, F&& f) {
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK;
  auto stage = [&](int c) {
    unsigned char* slot = ring + (c & 1) * LA_SLOT_BYTES;
    bf16* rows = reinterpret_cast<bf16*>(slot);
    la_stage(rows, a, c * LA_CHUNK, LA_CHUNK, S, threadIdx.x, blockDim.x);
    if (two) la_stage(rows + LA_CHUNK * TILE_LD, b, c * LA_CHUNK, LA_CHUNK, S, threadIdx.x, blockDim.x);
    if (st) {
      float* s = reinterpret_cast<float*>(slot + LA_SLOT_BF16 * 2);
      for (int i = threadIdx.x; i < 3 * LA_CHUNK; i += blockDim.x) {
        const bool live = c * LA_CHUNK + i / 3 < S;
        cp_async4(s + i, st + (live ? (long long)c * LA_CHUNK * 3 + i : 0), live);
      }
    }
    cp_async_commit();
  };
  stage(0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      stage(c + 1);
      la_wait<1>();
    } else {
      la_wait<0>();
    }
    __syncthreads();
    const unsigned char* slot = ring + (c & 1) * LA_SLOT_BYTES;
    const bf16* rows = reinterpret_cast<const bf16*>(slot);
    f(c, rows, rows + LA_CHUNK * TILE_LD, reinterpret_cast<const float*>(slot + LA_SLOT_BF16 * 2));
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The query passes of one warp (16 rows: A fragments qa, dO fragments oa)
// ---------------------------------------------------------------------------

// s of the warp's 16 rows against the chunk's keys c0 .. c0 + 63 at K
// (staged rows): scaled, keys >= S at -1e30; lane 4g + t holds rows g, g + 8
// and keys c0 + 8j + 2t, + 1 in sc[j]
__device__ __forceinline__ void la_scores(float sc[8][4], const uint32_t qa[4][4], const bf16* K,
                                          int c0, int S, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < LA_CHUNK / 8; ++j) {
    mma_rows_t(sc[j], qa, K + (size_t)8 * j * TILE_LD, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[j][e] = (c0 + 8 * j + 2 * t + (e & 1) < S) ? __fmul_rn(sc[j][e], LA_SCALE) : NEG_INF;
  }
}

// p = exp(s - m) / l in place (rows g: m[0], l[0]; g + 8: m[1], l[1])
__device__ __forceinline__ void la_probs(float p[8][4], const float m[2], const float l[2]) {
#pragma unroll
  for (int j = 0; j < LA_CHUNK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = expf(__fsub_rn(p[j][e], m[e >> 1])) / l[e >> 1];
}

// passes 1 and 2: each row's max m over all keys, then l = sum exp(s - m)
// (per lane in key order, then the quad)
__device__ __forceinline__ void la_row_stats(float m[2], float l[2], const uint32_t qa[4][4],
                                             unsigned char* ring, const LaRows& k, int S,
                                             int lane) {
  m[0] = m[1] = -3.0e38f;
  la_chunks(ring, k, k, false, nullptr, S, [&](int c, const bf16* K, const bf16*, const float*) {
    float sc[8][4];
    la_scores(sc, qa, K, c * LA_CHUNK, S, lane);
#pragma unroll
    for (int j = 0; j < LA_CHUNK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], sc[j][e]);
  });
  m[0] = la_quad_max(m[0]);
  m[1] = la_quad_max(m[1]);
  l[0] = l[1] = 0.0f;
  la_chunks(ring, k, k, false, nullptr, S, [&](int c, const bf16* K, const bf16*, const float*) {
    float sc[8][4];
    la_scores(sc, qa, K, c * LA_CHUNK, S, lane);
#pragma unroll
    for (int j = 0; j < LA_CHUNK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l[e >> 1] += expf(__fsub_rn(sc[j][e], m[e >> 1]));
  });
  l[0] = la_quad_sum(l[0]);
  l[1] = la_quad_sum(l[1]);
}

// the forward's last pass: acc = p v (SPLIT: p in two bf16 terms; else
// bf16(p)); DOT: also dot = rowsum(dP p), dP = dO v^T (the backward's pass
// 3, where the fused block's att is this acc; PV false: the flash backward,
// which needs no o)
template <bool SPLIT, bool DOT, bool PV = true>
__device__ __forceinline__ void la_pv(float acc[8][4], float dot[2], const uint32_t qa[4][4],
                                      const uint32_t (*oa)[4], const float m[2], const float l[2],
                                      unsigned char* ring, const LaRows& k, const LaRows& v,
                                      int S, int lane) {
  zero_acc(acc);
  dot[0] = dot[1] = 0.0f;
  la_chunks(ring, k, v, true, nullptr, S, [&](int c, const bf16* K, const bf16* V, const float*) {
    float p[8][4];
    la_scores(p, qa, K, c * LA_CHUNK, S, lane);
    la_probs(p, m, l);
#pragma unroll
    for (int i = 0; i < LA_CHUNK / 16; ++i) {
      if constexpr (DOT) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float dp[4];
          mma_rows_t(dp, oa, V + (size_t)8 * (2 * i + hh) * TILE_LD, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[e >> 1] += dp[e] * p[2 * i + hh][e];
        }
      }
      if constexpr (PV) la_mma_p<SPLIT>(acc, p[2 * i], p[2 * i + 1], V + (size_t)16 * i * TILE_LD, lane);
    }
  });
  if constexpr (DOT) {
    dot[0] = la_quad_sum(dot[0]);
    dot[1] = la_quad_sum(dot[1]);
  }
}

// the backward's pass 4: acc = dS k, dS = p (dP - dot) (SPLIT: two bf16
// terms; else bf16(dS))
template <bool SPLIT>
__device__ __forceinline__ void la_dq(float acc[8][4], const uint32_t qa[4][4],
                                      const uint32_t oa[4][4], const float m[2], const float l[2],
                                      const float dot[2], unsigned char* ring, const LaRows& k,
                                      const LaRows& v, int S, int lane) {
  zero_acc(acc);
  la_chunks(ring, k, v, true, nullptr, S, [&](int c, const bf16* K, const bf16* V, const float*) {
    float p[8][4];
    la_scores(p, qa, K, c * LA_CHUNK, S, lane);
    la_probs(p, m, l);
#pragma unroll
    for (int i = 0; i < LA_CHUNK / 16; ++i) {
      float ds[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mma_rows_t(ds[hh], oa, V + (size_t)8 * (2 * i + hh) * TILE_LD, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[hh][e] = p[2 * i + hh][e] * (ds[hh][e] - dot[e >> 1]);
      }
      la_mma_p<SPLIT>(acc, ds[0], ds[1], K + (size_t)16 * i * TILE_LD, lane);
    }
  });
}

// The key-major pass over one chunk of 64 queries (rows Qc, dO rows Oc) for
// the warp's 16 keys k0.. (staged rows Kw, Vw): per 16 queries, s and dP
// with the queries as rows, p and dS from each query's statistics (m, l,
// dot at stat(row)), then dV += p^T dO and dK += dS^T q. Queries >= S and
// keys >= S give p = 0.
template <bool SPLIT, class Stat>
__device__ __forceinline__ void la_cols_chunk(float ak[8][4], float av[8][4], const bf16* Qc,
                                              const bf16* Oc, const bf16* Kw, const bf16* Vw,
                                              int q0, int k0, int S, int lane, Stat&& stat) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int i = 0; i < LA_CHUNK / 16; ++i) {
    uint32_t qa[4][4], oa[4][4];
    load_a_rows(qa, Qc + (size_t)16 * i * TILE_LD, lane);
    load_a_rows(oa, Oc + (size_t)16 * i * TILE_LD, lane);
    float p[2][4], ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mma_rows_t(p[n], qa, Kw + (size_t)8 * n * TILE_LD, lane);
      mma_rows_t(ds[n], oa, Vw + (size_t)8 * n * TILE_LD, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int local = 16 * i + g + 8 * (e >> 1);
        const bool live = q0 + local < S && k0 + 8 * n + 2 * t + (e & 1) < S;
        float m = 0.0f, l = 1.0f, dot = 0.0f;
        stat(live ? local : 0, m, l, dot);
        // the query passes' p, bit for bit: the same score, the same operations
        const float pr = live ? expf(__fsub_rn(__fmul_rn(p[n][e], LA_SCALE), m)) / l : 0.0f;
        p[n][e] = pr;
        ds[n][e] = pr * (ds[n][e] - dot);
      }
    }
    la_mma_p_t<SPLIT>(av, p, Oc + (size_t)16 * i * TILE_LD, lane);
    la_mma_p_t<SPLIT>(ak, ds, Qc + (size_t)16 * i * TILE_LD, lane);
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// The forward: one block per 64 queries of one (image, head) (grid (S / 64,
// H, B)); o rows of (image b, head h) at o + b obs + h 64 + r ots. SPLIT:
// flash (p in two terms); else the fused layer's stage (bf16(p)).
template <bool SPLIT>
__global__ void __launch_bounds__(LA_ROW_WARPS * 32, LA_ROW_MINB)
long_attention_fwd(LaOp q, LaOp k, LaOp v, bf16* __restrict__ o, long long obs, long long ots,
                   int S) {
  extern __shared__ __align__(128) unsigned char la_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qw = reinterpret_cast<bf16*>(la_smem + 2 * LA_SLOT_BYTES) + warp * 16 * TILE_LD;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * (16 * LA_ROW_WARPS) + 16 * warp;
  const LaRows kr = la_rows(k, b, h), vr = la_rows(v, b, h);
  la_stage(Qw, la_rows(q, b, h), r0, 16, S, lane, 32);
  cp_async_commit();
  la_wait<0>();
  __syncwarp();
  uint32_t qa[4][4];
  load_a_rows(qa, Qw, lane);
  float m[2], l[2], dot[2], acc[8][4];
  la_row_stats(m, l, qa, la_smem, kr, S, lane);
  la_pv<SPLIT, false>(acc, dot, qa, nullptr, m, l, la_smem, kr, vr, S, lane);
  store_rows(o + (long long)b * obs + h * TILE_DH, ots, acc, 1.0f, r0, S, lane);
}

static size_t long_fwd_smem() {
  return 2 * LA_SLOT_BYTES + (size_t)LA_ROW_WARPS * 16 * TILE_LD * sizeof(bf16);
}

// The flash backward, launch 1 (query-major, grid (S / 64, H, B)): per
// query the statistics (m, l, rowsum(dP p)) into `stats` ((b H + h) S + row)
// x 3, and dq. dout, dq: rows of (b, h) at + b obs + h 64 + r ots.
__global__ void __launch_bounds__(LA_ROW_WARPS * 32, LA_ROW_MINB)
long_flash_bwd_rows(LaOp q, LaOp k, LaOp v, const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    float* __restrict__ stats, long long obs, long long ots, int S, int H) {
  extern __shared__ __align__(128) unsigned char la_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* Qw = reinterpret_cast<bf16*>(la_smem + 2 * LA_SLOT_BYTES) + warp * 32 * TILE_LD;
  bf16* Ow = Qw + 16 * TILE_LD;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * (16 * LA_ROW_WARPS) + 16 * warp;
  const LaRows kr = la_rows(k, b, h), vr = la_rows(v, b, h);
  const long long ohead = (long long)b * obs + h * TILE_DH;
  la_stage(Qw, la_rows(q, b, h), r0, 16, S, lane, 32);
  la_stage(Ow, {dout + ohead, ots}, r0, 16, S, lane, 32);
  cp_async_commit();
  la_wait<0>();
  __syncwarp();
  uint32_t qa[4][4], oa[4][4];
  load_a_rows(qa, Qw, lane);
  load_a_rows(oa, Ow, lane);
  float m[2], l[2], dot[2], acc[8][4];
  la_row_stats(m, l, qa, la_smem, kr, S, lane);
  la_pv<true, true, false>(acc, dot, qa, oa, m, l, la_smem, kr, vr, S, lane);
  la_dq<true>(acc, qa, oa, m, l, dot, la_smem, kr, vr, S, lane);
  store_rows(dq + ohead, ots, acc, LA_SCALE, r0, S, lane);
  if (t == 0) {
    float* st = stats + ((long long)(b * H + h) * S) * 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < S) {
        st[row * 3 + 0] = m[r];
        st[row * 3 + 1] = l[r];
        st[row * 3 + 2] = dot[r];
      }
    }
  }
}

// The flash backward, launch 2 (key-major, grid (S / 64, H, B)): the warp's
// 16 keys against every query, the queries' statistics streamed with them.
__global__ void __launch_bounds__(LA_ROW_WARPS * 32, LA_ROW_MINB)
long_flash_bwd_cols(LaOp q, LaOp k, LaOp v, const bf16* __restrict__ dout,
                    const float* __restrict__ stats, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    long long obs, long long ots, int S, int H) {
  extern __shared__ __align__(128) unsigned char la_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Kw = reinterpret_cast<bf16*>(la_smem + 2 * LA_SLOT_BYTES) + warp * 32 * TILE_LD;
  bf16* Vw = Kw + 16 * TILE_LD;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * (16 * LA_ROW_WARPS) + 16 * warp;
  const long long ohead = (long long)b * obs + h * TILE_DH;
  la_stage(Kw, la_rows(k, b, h), k0, 16, S, lane, 32);
  la_stage(Vw, la_rows(v, b, h), k0, 16, S, lane, 32);
  cp_async_commit();
  la_wait<0>();
  __syncwarp();
  float ak[8][4], av[8][4];
  zero_acc(ak);
  zero_acc(av);
  la_chunks(la_smem, la_rows(q, b, h), {dout + ohead, ots}, true,
            stats + ((long long)(b * H + h) * S) * 3, S,
            [&](int c, const bf16* Qc, const bf16* Oc, const float* st) {
              la_cols_chunk<true>(ak, av, Qc, Oc, Kw, Vw, c * LA_CHUNK, k0, S, lane,
                                  [&](int r, float& m, float& l, float& dot) {
                                    m = st[3 * r];
                                    l = st[3 * r + 1];
                                    dot = st[3 * r + 2];
                                  });
            });
  store_rows(dk + ohead, ots, ak, LA_SCALE, k0, S, lane);
  store_rows(dv + ohead, ots, av, 1.0f, k0, S, lane);
}

static size_t long_flash_bwd_smem() {
  return 2 * LA_SLOT_BYTES + (size_t)LA_ROW_WARPS * 32 * TILE_LD * sizeof(bf16);
}

// The fused block's backward core: one block per (image, head) (grid (H,
// B)), qkv (B S, 3 D) and datt (B S, D) in, att (B S, D) and dqkv (B S, 3 D)
// out. Phase 1 takes the queries 16 a warp (passes 1-4; att, dq, and each
// query's statistics into shared memory); phase 2 the keys 16 a warp (dk,
// dv), reading those statistics.
__global__ void __launch_bounds__(LA_CORE_WARPS * 32, LA_CORE_MINB)
long_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
                          bf16* __restrict__ att, bf16* __restrict__ dqkv, int S, int D) {
  extern __shared__ __align__(128) unsigned char la_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* Wa = reinterpret_cast<bf16*>(la_smem + 2 * LA_SLOT_BYTES) + warp * 32 * TILE_LD;
  bf16* Wb = Wa + 16 * TILE_LD;
  float* rmax = reinterpret_cast<float*>(la_smem + 2 * LA_SLOT_BYTES +
                                         (size_t)LA_CORE_WARPS * 32 * TILE_LD * sizeof(bf16));
  const int sp = (S + LA_CHUNK - 1) / LA_CHUNK * LA_CHUNK;
  float* rsum = rmax + sp;
  float* rdot = rsum + sp;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long ld = 3LL * D;
  const LaRows qr = {qkv + (long long)b * S * ld + h * TILE_DH, ld};
  const LaRows kr = {qr.p + D, ld}, vr = {qr.p + 2 * D, ld};
  const LaRows orow = {datt + (long long)b * S * D + h * TILE_DH, D};
  bf16* dq = dqkv + (long long)b * S * ld + h * TILE_DH;
  constexpr int ROUND = 16 * LA_CORE_WARPS;

  // ---- phase 1: 16 queries per warp ------------------------------------
  for (int base = 0; base < S; base += ROUND) {
    const int r0 = base + 16 * warp;
    __syncwarp();
    la_stage(Wa, qr, r0, 16, S, lane, 32);
    la_stage(Wb, orow, r0, 16, S, lane, 32);
    cp_async_commit();
    la_wait<0>();
    __syncwarp();
    uint32_t qa[4][4], oa[4][4];
    load_a_rows(qa, Wa, lane);
    load_a_rows(oa, Wb, lane);
    float m[2], l[2], dot[2], acc[8][4];
    la_row_stats(m, l, qa, la_smem, kr, S, lane);
    la_pv<false, true>(acc, dot, qa, oa, m, l, la_smem, kr, vr, S, lane);
    store_rows(att + (long long)b * S * D + h * TILE_DH, D, acc, 1.0f, r0, S, lane);
    la_dq<false>(acc, qa, oa, m, l, dot, la_smem, kr, vr, S, lane);
    store_rows(dq, ld, acc, LA_SCALE, r0, S, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row < S) {
          rmax[row] = m[r];
          rsum[row] = l[r];
          rdot[row] = dot[r];
        }
      }
    }
  }
  __syncthreads();

  // ---- phase 2: 16 keys per warp, every query ---------------------------
  for (int base = 0; base < S; base += ROUND) {
    const int k0 = base + 16 * warp;
    __syncwarp();
    la_stage(Wa, kr, k0, 16, S, lane, 32);
    la_stage(Wb, vr, k0, 16, S, lane, 32);
    cp_async_commit();
    la_wait<0>();
    __syncwarp();
    float ak[8][4], av[8][4];
    zero_acc(ak);
    zero_acc(av);
    la_chunks(la_smem, qr, orow, true, nullptr, S,
              [&](int c, const bf16* Qc, const bf16* Oc, const float*) {
                const int q0 = c * LA_CHUNK;
                la_cols_chunk<false>(ak, av, Qc, Oc, Wa, Wb, q0, k0, S, lane,
                                     [&](int r, float& m, float& l, float& dot) {
                                       m = rmax[q0 + r];
                                       l = rsum[q0 + r];
                                       dot = rdot[q0 + r];
                                     });
              });
    store_rows(dq + D, ld, ak, LA_SCALE, k0, S, lane);
    store_rows(dq + 2 * D, ld, av, 1.0f, k0, S, lane);
  }
}

static size_t long_core_smem(int S) {
  const size_t sp = (S + LA_CHUNK - 1) / LA_CHUNK * LA_CHUNK;
  return 2 * LA_SLOT_BYTES + (size_t)LA_CORE_WARPS * 32 * TILE_LD * sizeof(bf16) +
         3 * sp * sizeof(float);
}

// ---------------------------------------------------------------------------
// Host launches, on the caller's stream
// ---------------------------------------------------------------------------

template <class K>
static int la_set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

static dim3 la_row_grid(int B, int S, int H) {
  return dim3((S + 16 * LA_ROW_WARPS - 1) / (16 * LA_ROW_WARPS), H, B);
}

// o = softmax(q k^T / 8) v over B images x H heads of S tokens; SPLIT: p in
// fp32 (flash), else bf16(p) (the fused layer)
template <bool SPLIT>
static int launch_long_attention_fwd(const LaOp& q, const LaOp& k, const LaOp& v, bf16* o,
                                     long long obs, long long ots, int B, int S, int H,
                                     cudaStream_t st) {
  const size_t smem = long_fwd_smem();
  LAUNCH(la_set_smem(long_attention_fwd<SPLIT>, smem));
  long_attention_fwd<SPLIT><<<la_row_grid(B, S, H), LA_ROW_WARPS * 32, smem, st>>>(q, k, v, o, obs,
                                                                                  ots, S);
  return (int)cudaGetLastError();
}

// the flash backward: dq, dk, dv (rows as o's), two launches; stats holds B
// H S x 3 floats
static int launch_long_flash_bwd(const LaOp& q, const LaOp& k, const LaOp& v, const bf16* dout,
                                 bf16* dq, bf16* dk, bf16* dv, float* stats, long long obs,
                                 long long ots, int B, int S, int H, cudaStream_t st) {
  const size_t smem = long_flash_bwd_smem();
  const dim3 grid = la_row_grid(B, S, H);
  LAUNCH(la_set_smem(long_flash_bwd_rows, smem));
  long_flash_bwd_rows<<<grid, LA_ROW_WARPS * 32, smem, st>>>(q, k, v, dout, dq, stats, obs, ots,
                                                             S, H);
  LAUNCH((int)cudaGetLastError());
  LAUNCH(la_set_smem(long_flash_bwd_cols, smem));
  long_flash_bwd_cols<<<grid, LA_ROW_WARPS * 32, smem, st>>>(q, k, v, dout, stats, dk, dv, obs,
                                                             ots, S, H);
  return (int)cudaGetLastError();
}

// the fused block's forward stage: att (B S, D) from qkv (B S, 3 D)
static int launch_long_attention_stage(const bf16* qkv, bf16* att, int B, int S, int H, int D,
                                       cudaStream_t st) {
  const long long ld = 3LL * D, bs = (long long)S * ld;
  return launch_long_attention_fwd<false>({qkv, bs, ld}, {qkv + D, bs, ld}, {qkv + 2 * D, bs, ld},
                                          att, (long long)S * D, D, B, S, H, st);
}

// the fused block's backward core: att and dqkv from qkv and datt, one launch
static int launch_long_attention_bwd(const bf16* qkv, const bf16* datt, bf16* att, bf16* dqkv,
                                     int B, int S, int H, int D, cudaStream_t st) {
  if (long_core_smem(S) > LA_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const size_t smem = long_core_smem(S);
  LAUNCH(la_set_smem(long_attention_bwd_kernel, smem));
  long_attention_bwd_kernel<<<dim3(H, B), LA_CORE_WARPS * 32, smem, st>>>(qkv, datt, att, dqkv, S,
                                                                         D);
  return (int)cudaGetLastError();
}
