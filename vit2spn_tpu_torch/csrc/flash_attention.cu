// Attention forward and backward for Hopper (sm_90a) with every intermediate
// in fp32, bf16 or fp32 in and out.
//
// Replaces: vit2spn_tpu/ops/flash_attention.py::_fwd_kernel (reached through
// _flash_fwd_impl and mha_pallas) and ::_bwd_kernel (through _flash_bwd), the
// Pallas TPU kernels of the per-op block's attention (attn_impl="pallas"),
// one grid program per (image, head) with the sequence padded to 256 in VMEM.
// Per (image, head), over S tokens, keys >= S masked to -1e30:
//
//   forward:  s = q k^T / sqrt(dh);  P = softmax(s);  o = P v
//   backward: P recomputed, rows of pad queries zeroed
//             dV = P^T dO;  dP = dO v^T;  dS = P * (dP - rowsum(dP * P))
//             dQ = dS k / sqrt(dh);  dK = dS^T q / sqrt(dh)
//
// The Pallas bodies cast the inputs to fp32 and keep every value fp32 until
// the outputs are rounded to the input dtype: P is not rounded before P v or
// P^T dO, nor dS before dS k and dS^T q. That tells this function apart from
// the fused block's attention (csrc/layer_fwd.cuh, attention_bwd.cuh), which
// rounds P and dS to one bf16 term for the tensor cores.
//
// What bounds it on this card: bytes. At ViT-Tiny (S = 197, dh 64, B = 128:
// 384 (image, head) pairs, bf16) the forward reads q, k, v and writes o, 38.7
// MB, 0.0116 ms at 3.35 TB/s, against 3.82 GFLOP (0.0039 ms at the 989
// TFLOP/s bf16 tensor rate); the backward moves 67.8 MB, 0.0202 ms, against
// 9.54 GFLOP. At the 67 TFLOP/s the card has outside the tensor cores the
// products alone would take 57 and 142 us, so the bf16 kernels run every
// product on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate):
//
//   * q k^T and dO v^T have bf16 operands: their products are exact in fp32,
//     so the mma computes the Pallas body's fp32 sums, in another order;
//   * P and dS are the only fp32 operands. Each goes in as two bf16 terms,
//     hi = bf16(x) and lo = bf16(x - hi), two mma into one fp32 accumulator:
//     hi + lo is x to about 2^-17 of it, far below the outputs' bf16
//     rounding. An emulation in plain torch (tests/test_torch_flash_attention.py,
//     B = 2, S = 197, H = 3, bf16 inputs, dO of scale 0.1) puts the split's
//     mean error against float64, relative to each output's largest
//     magnitude, at the fp32 twin's to four digits (o 1.405e-4, dq 1.495e-4,
//     dk 1.341e-4, dv 1.196e-4) where one bf16 term of P and dS reads
//     2.229e-4, 2.397e-4, 2.119e-4 and 1.905e-4.
//
// The design, one warp per 16 rows, four warps per block, no atomics:
//
//   * a block takes TC_TILE = 128 rows (queries, or keys in the backward's
//     second launch) of one (image, head) and stages all S rows of the other
//     side in shared memory with cp.async (zeros past S), TILE_LD apart for
//     conflict-free ldmatrix; each warp stages its own 16 rows the same way,
//     the next 16 in flight while it works on these. At S = 197 that is two
//     stagings of K and V per (image, head): 64 and 256 rows per block were
//     slower (tools/flash_tile_sweep.py, PERF.md);
//   * the forward and the backward's first launch keep the warp's 16 x S
//     scores in registers (the kernels are instantiated per S rounded up to
//     16), scale them with __fmul_rn, and run the softmax in the Pallas order:
//     the row max, exp(s - max), then the division by the row sum;
//   * backward launch 1, per query tile: the row statistics (max, sum,
//     rowsum(dP * P)) to a workspace, dQ = (dS_hi + dS_lo) k in registers;
//     dP = dO v^T is recomputed in its second pass rather than held;
//   * backward launch 2, per key tile, walks every query in steps of 16: it
//     recomputes the score and dP tiles with the operands in launch 1's roles
//     (queries as A, keys as B: the same mma on the same fragments, so the
//     same bits), rebuilds P and dS from the statistics, turns each 8 x 8
//     bf16 quarter of their hi and lo terms into P^T and dS^T with movmatrix,
//     and sums dV = P^T dO and dK = dS^T q in registers.
//
// Every sum stays inside one warp in a fixed order, so two runs give the same
// bits. Keys >= S get probability exactly 0, queries >= S are left out of dK
// and dV, and pad rows are never written: the Pallas kernels' padding to 256,
// without the padding.
//
// fp32 inputs (compute_dtype=float32) keep the CUDA-core kernels of
// csrc/flash_f32.cuh (shared with the fp32 forward layer and attention
// backward of the fused block): every product an fp32 FMA. A two-term bf16 split of fp32 q
// and k leaves about 2^-17 of each score, above the 1e-6 of the outputs'
// largest magnitude within which those kernels stay of float64.
//
// Layout: q, k, v are read in place through strides, as the views the split
// of the block's (B, S, 3D) qkv gives them: element (b, s, h, d) at
// b * bs + s * ts + h * 64 + d. o, dO, dq, dk and dv are contiguous (B, S, H,
// 64). Limits: head_dim 64, S <= 256; bf16 rows start on 16 bytes (ts and bs
// multiples of 8), fp32 rows on 8.

#include <type_traits>

#include "flash_f32.cuh"

// ===========================================================================
// bf16 inputs: the tensor cores
// ===========================================================================

#ifndef TC_WARPS
#define TC_WARPS 4
#endif
#ifndef TC_TILE
#define TC_TILE 128  // rows of a block: queries, or keys (backward launch 2)
#endif

__host__ __device__ __forceinline__ int pad16(int S) { return (S + 15) / 16 * 16; }

// Rows r0 .. r0 + n - 1 of one (image, head) (global row stride ts) into
// shared memory TILE_LD apart, with cp.async by threads `tid` of `nt`; rows >=
// S are zeros.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long ts, int r0,
                                           int n, int S, int tid, int nt) {
  for (int i = tid; i < n * (FA_DH / 8); i += nt) {
    const int r = i / (FA_DH / 8), c = (i % (FA_DH / 8)) * 8;
    const bool live = r0 + r < S;
    cp_async16(dst + r * TILE_LD + c, src + (live ? r0 + r : 0) * ts + c, live);
  }
}

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

// acc (16 x 64) += (hi + lo) (16 x 16) times the 16 staged rows at `rows`:
// mma_rows with both terms on one load of the B fragments
__device__ __forceinline__ void mma_rows_split(float acc[8][4], const uint32_t hi[4],
                                               const uint32_t lo[4], const bf16* rows,
                                               int lane) {
  const bf16* p =
      rows + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * TILE_LD + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < FA_DH / 16; ++np) {
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
  for (int n = 0; n < FA_DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// the sum, or the max, of one row over the 4 lanes of its row group (rows g
// and g + 8 of a C tile)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// P of the warp's 16 queries (A fragments qa) against the SP = 8 NT staged
// keys Ks, in sc: scores scaled with __fmul_rn, keys >= S at -1e30, the row
// max mx, exp(s - max) (exactly 0 for masked keys), their sum l, then the
// division. Rows g and g + 8 of the tile: mx[0], l[0] and mx[1], l[1].
template <int NT>
__device__ __forceinline__ void probs_tile(float sc[NT][4], float mx[2], float l[2],
                                           const uint32_t qa[4][4], const bf16* Ks, int S,
                                           float scale, int lane) {
  const int t = lane & 3;
  mx[0] = mx[1] = -3.0e38f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mma_rows_t(sc[j], qa, Ks + (size_t)8 * j * TILE_LD, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = (8 * j + 2 * t + (e & 1) < S) ? __fmul_rn(sc[j][e], scale) : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = expf(__fsub_rn(sc[j][e], mx[e >> 1]));
      l[e >> 1] += sc[j][e];
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = sc[j][e] / l[e >> 1];
}

// ---------------------------------------------------------------------------
// Forward: one block per TC_TILE queries of one (image, head)
// ---------------------------------------------------------------------------

static size_t tc_fwd_smem(int S) {
  return (size_t)(2 * pad16(S) + TC_WARPS * 16) * TILE_LD * sizeof(bf16);
}

template <int NT>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             bf16* __restrict__ o, int S, int H, long long bs, long long ts, float scale) {
  constexpr int SP = 8 * NT;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(fa_smem);
  bf16* Vs = Ks + SP * TILE_LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qw = Vs + SP * TILE_LD + warp * 16 * TILE_LD;  // this warp's 16 queries
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * TC_TILE, r1 = min(r0 + TC_TILE, S);
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  bf16* out = o + (long long)b * S * ots + h * FA_DH;
  stage_rows(Ks, k + head, ts, 0, SP, S, threadIdx.x, blockDim.x);
  stage_rows(Vs, v + head, ts, 0, SP, S, threadIdx.x, blockDim.x);
  stage_rows(Qw, q + head, ts, r0 + 16 * warp, 16, S, lane, 32);
  cp_async_wait_all();
  __syncthreads();

  for (int q0 = r0 + 16 * warp; q0 < r1; q0 += 16 * TC_WARPS) {
    uint32_t qa[4][4];
    load_a_rows(qa, Qw, lane);
    __syncwarp();  // every lane has read the buffer: stage the next 16 queries
    if (q0 + 16 * TC_WARPS < r1) stage_rows(Qw, q + head, ts, q0 + 16 * TC_WARPS, 16, S, lane, 32);

    float sc[NT][4], mx[2], l[2];
    probs_tile<NT>(sc, mx, l, qa, Ks, S, scale, lane);
    // o = (P_hi + P_lo) v: score tiles 2i and 2i + 1 are the A operand of
    // key step i as they lie
    float acc[8][4];
    zero_acc(acc);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      uint32_t hi[4], lo[4];
      split_a(hi, lo, sc[2 * i], sc[2 * i + 1]);
      mma_rows_split(acc, hi, lo, Vs + (size_t)16 * i * TILE_LD, lane);
    }
    store_rows(out, ots, acc, 1.0f, q0, S, lane);
    cp_async_wait_all();
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Backward, launch 1: one block per TC_TILE queries: statistics and dQ
// ---------------------------------------------------------------------------

static size_t tc_bwd_smem(int S) {  // both launches' staged rows
  return (size_t)(2 * pad16(S) + TC_WARPS * 32) * TILE_LD * sizeof(bf16);
}

template <int NT>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_bwd_rows_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  bf16* __restrict__ dq, float* __restrict__ stats, int S, int H, long long bs,
                  long long ts, float scale) {
  constexpr int SP = 8 * NT;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(fa_smem);
  bf16* Vs = Ks + SP * TILE_LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* Qw = Vs + SP * TILE_LD + warp * 32 * TILE_LD;  // this warp's 16 queries
  bf16* Ow = Qw + 16 * TILE_LD;                        // and their dO
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * TC_TILE, r1 = min(r0 + TC_TILE, S);
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  float* st = stats + ((long long)(b * H + h) * S) * 3;
  stage_rows(Ks, k + head, ts, 0, SP, S, threadIdx.x, blockDim.x);
  stage_rows(Vs, v + head, ts, 0, SP, S, threadIdx.x, blockDim.x);
  stage_rows(Qw, q + head, ts, r0 + 16 * warp, 16, S, lane, 32);
  stage_rows(Ow, dout + ohead, ots, r0 + 16 * warp, 16, S, lane, 32);
  cp_async_wait_all();
  __syncthreads();

  for (int q0 = r0 + 16 * warp; q0 < r1; q0 += 16 * TC_WARPS) {
    uint32_t qa[4][4], oa[4][4];
    load_a_rows(qa, Qw, lane);
    load_a_rows(oa, Ow, lane);
    __syncwarp();
    if (q0 + 16 * TC_WARPS < r1) {
      stage_rows(Qw, q + head, ts, q0 + 16 * TC_WARPS, 16, S, lane, 32);
      stage_rows(Ow, dout + ohead, ots, q0 + 16 * TC_WARPS, 16, S, lane, 32);
    }

    float p[NT][4], mx[2], l[2];
    probs_tile<NT>(p, mx, l, qa, Ks, S, scale, lane);
    // rowsum(dP * P), dP = dO v^T one key tile at a time
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float dp[4];
      mma_rows_t(dp, oa, Vs + (size_t)8 * j * TILE_LD, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) dot[e >> 1] += dp[e] * p[j][e];
    }
    dot[0] = quad_sum(dot[0]);
    dot[1] = quad_sum(dot[1]);
    // dS = P (dP - rowsum), dP recomputed; dQ = (dS_hi + dS_lo) k
    float acc[8][4];
    zero_acc(acc);
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      float ds[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mma_rows_t(ds[hh], oa, Vs + (size_t)8 * (2 * i + hh) * TILE_LD, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[hh][e] = p[2 * i + hh][e] * (ds[hh][e] - dot[e >> 1]);
      }
      uint32_t hi[4], lo[4];
      split_a(hi, lo, ds[0], ds[1]);
      mma_rows_split(acc, hi, lo, Ks + (size_t)16 * i * TILE_LD, lane);
    }
    store_rows(dq + ohead, ots, acc, scale, q0, S, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        if (row < S) {
          st[row * 3 + 0] = mx[r];
          st[row * 3 + 1] = l[r];
          st[row * 3 + 2] = dot[r];
        }
      }
    }
    cp_async_wait_all();
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Backward, launch 2: one block per TC_TILE keys, every query: dK and dV
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(TC_WARPS * 32)
flash_bwd_cols_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ stats, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, int S, int H, long long bs, long long ts, float scale) {
  const int SP = pad16(S);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* Os = Qs + SP * TILE_LD;  // dO, every query
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* Kw = Os + SP * TILE_LD + warp * 32 * TILE_LD;  // this warp's 16 keys
  bf16* Vw = Kw + 16 * TILE_LD;
  float* rmax = reinterpret_cast<float*>(Os + SP * TILE_LD + TC_WARPS * 32 * TILE_LD);
  float* rsum = rmax + SP;
  float* rdot = rsum + SP;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * TC_TILE, r1 = min(r0 + TC_TILE, S);
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  const float* st = stats + ((long long)(b * H + h) * S) * 3;
  stage_rows(Qs, q + head, ts, 0, SP, S, threadIdx.x, blockDim.x);
  stage_rows(Os, dout + ohead, ots, 0, SP, S, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < 3 * SP; i += blockDim.x) {  // pad queries: zeros, masked
    const int c = i / 3, f = i % 3;
    cp_async4(rmax + f * SP + c, st + (c < S ? i : 0), c < S);
  }
  int k0 = r0 + 16 * warp;
  stage_rows(Kw, k + head, ts, k0, 16, S, lane, 32);
  stage_rows(Vw, v + head, ts, k0, 16, S, lane, 32);
  cp_async_wait_all();
  __syncthreads();

  for (; k0 < r1; k0 += 16 * TC_WARPS) {
    if (k0 != r0 + 16 * warp) {  // the next 16 keys of this warp
      __syncwarp();
      stage_rows(Kw, k + head, ts, k0, 16, S, lane, 32);
      stage_rows(Vw, v + head, ts, k0, 16, S, lane, 32);
      cp_async_wait_all();
      __syncwarp();
    }
    float ak[8][4], av[8][4];
    zero_acc(ak);
    zero_acc(av);
    for (int i = 0; i < SP / 16; ++i) {
      // scores and dP of queries 16 i.. against the warp's keys, in launch
      // 1's roles (rows query, columns key), then P and dS from the statistics
      uint32_t qa[4][4], oa[4][4];
      load_a_rows(qa, Qs + (size_t)16 * i * TILE_LD, lane);
      load_a_rows(oa, Os + (size_t)16 * i * TILE_LD, lane);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_rows_t(p[n], qa, Kw + (size_t)8 * n * TILE_LD, lane);
        mma_rows_t(ds[n], oa, Vw + (size_t)8 * n * TILE_LD, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + 8 * (e >> 1);
          const bool live = row < S && k0 + 8 * n + 2 * t + (e & 1) < S;
          // launch 1's P, bit for bit: the same score, the same operations
          const float pr =
              live ? expf(__fsub_rn(__fmul_rn(p[n][e], scale), rmax[row])) / rsum[row] : 0.0f;
          p[n][e] = pr;
          ds[n][e] = pr * (ds[n][e] - rdot[row]);
        }
      }
      uint32_t hi[4], lo[4];
      split_a_t(hi, lo, p);  // P^T: rows key, columns query
      mma_rows_split(av, hi, lo, Os + (size_t)16 * i * TILE_LD, lane);
      split_a_t(hi, lo, ds);
      mma_rows_split(ak, hi, lo, Qs + (size_t)16 * i * TILE_LD, lane);
    }
    store_rows(dk + ohead, ots, ak, scale, k0, S, lane);
    store_rows(dv + ohead, ots, av, 1.0f, k0, S, lane);
  }
}

// f(std::integral_constant<int, NT>) for NT = S rounded up to 16, over 8
template <typename F>
static int by_key_tiles(int S, F&& f) {
  switch (pad16(S) / 8) {
#define FA_CASE(nt) \
  case nt:          \
    return f(std::integral_constant<int, nt>());
    FA_CASE(2) FA_CASE(4) FA_CASE(6) FA_CASE(8) FA_CASE(10) FA_CASE(12) FA_CASE(14)
    FA_CASE(16) FA_CASE(18) FA_CASE(20) FA_CASE(22) FA_CASE(24) FA_CASE(26) FA_CASE(28)
    FA_CASE(30) FA_CASE(32)
#undef FA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Host entries
// ---------------------------------------------------------------------------

// rows start on 16 bytes for the bf16 kernels' cp.async, on 8 for fp32 float2
static bool bad_shape(int B, int S, int H, long long bs, long long ts, int fp32) {
  const int align = fp32 ? 2 : 8;
  return B <= 0 || S <= 0 || S > FA_MAX_S || H <= 0 || ts < (long long)H * FA_DH ||
         bs < (long long)S * ts || ts % align || (B > 1 && bs % align);
}

static int fwd_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S, int H,
                    long long bs, long long ts, float scale, cudaStream_t st) {
  const dim3 grid((S + TC_TILE - 1) / TC_TILE, H, B);
  const size_t smem = tc_fwd_smem(S);
  return by_key_tiles(S, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    LAUNCH(set_smem(flash_fwd_tc<NT>, smem));
    flash_fwd_tc<NT><<<grid, TC_WARPS * 32, smem, st>>>(q, k, v, o, S, H, bs, ts, scale);
    return (int)cudaGetLastError();
  });
}

static int bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, bf16* dq,
                    bf16* dk, bf16* dv, float* ws, int B, int S, int H, long long bs,
                    long long ts, float scale, cudaStream_t st) {
  const dim3 grid((S + TC_TILE - 1) / TC_TILE, H, B);
  const size_t smem = tc_bwd_smem(S);
  const int rc = by_key_tiles(S, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    LAUNCH(set_smem(flash_bwd_rows_tc<NT>, smem));
    flash_bwd_rows_tc<NT><<<grid, TC_WARPS * 32, smem, st>>>(q, k, v, dout, dq, ws, S, H, bs,
                                                             ts, scale);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;
  const size_t smem2 = smem + (size_t)3 * pad16(S) * sizeof(float);
  LAUNCH(set_smem(flash_bwd_cols_tc, smem2));
  flash_bwd_cols_tc<<<grid, TC_WARPS * 32, smem2, st>>>(q, k, v, dout, ws, dk, dv, S, H, bs, ts,
                                                        scale);
  return (int)cudaGetLastError();
}

// q, k, v: (B, S, H, 64) read through (bs, ts) strides; o contiguous (B, S,
// H, 64); all bf16, or all fp32 with `fp32` set.
extern "C" int vit2spn_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int H, long long bs, long long ts, int fp32,
                                 void* stream) {
  if (bad_shape(B, S, H, bs, ts, fp32)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)FA_DH);
  if (fp32)
    return fwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<float*>(o), B, S, H, bs, ts, scale,
                   st);
  return fwd_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), B, S, H, bs, ts, scale, st);
}

// dout, dq, dk, dv contiguous (B, S, H, 64); stats: workspace_floats fp32.
extern "C" int vit2spn_flash_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, void* dq, void* dk, void* dv, void* stats,
                                 int B, int S, int H, long long bs, long long ts, int fp32,
                                 void* stream) {
  if (bad_shape(B, S, H, bs, ts, fp32)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf((float)FA_DH);
  float* ws = static_cast<float*>(stats);
  if (fp32)
    return bwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v), static_cast<const float*>(dout),
                   static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), ws,
                   B, S, H, bs, ts, (long long)H * FA_DH, scale, st);
  return bwd_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), ws, B,
                  S, H, bs, ts, scale, st);
}

// the row statistics between the two backward launches
extern "C" long long vit2spn_flash_bwd_workspace_floats(int B, int S, int H) {
  return (long long)B * H * S * 3;
}

extern "C" int vit2spn_flash_fwd_launches() { return 1; }

extern "C" int vit2spn_flash_bwd_launches() { return 2; }
