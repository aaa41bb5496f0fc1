// Attention forward and backward on the CUDA cores in fp32, every product an
// fp32 FMA: the fp32 route of csrc/flash_attention.cu (the "pallas" path under
// compute_dtype=float32), of the fp32 forward layer (csrc/layer_fwd_seq.cuh)
// and of the fp32 attention backward of the fused block (csrc/attn_bwd.cuh).
// One copy of the device code, included by each of those sources.
//
// Per (image, head), over S tokens, keys >= S masked to -1e30:
//
//   forward:  s = q k^T / sqrt(dh);  P = softmax(s);  o = P v
//   backward: dV = P^T dO;  dP = dO v^T;  dS = P * (dP - rowsum(dP * P))
//             dQ = dS k / sqrt(dh);  dK = dS^T q / sqrt(dh)
//
// which in fp32 is what _attention / _attention_bwd
// (vit2spn_tpu/ops/fused_block.py) and the flash Pallas bodies compute: their
// casts to the compute dtype are no-ops. q, k, v are read in place through
// (bs, ts) strides (element (b, s, h, d) at b * bs + s * ts + h * 64 + d), so
// they may be strided views of a fused (B, S, 3D) qkv; o and dO are (B, S, H,
// 64) contiguous; dq, dk, dv have rows gts apart (H * 64, or 3 D when they are
// the thirds of a dqkv). Limits: head_dim 16, 32, 48, 64 or 80 at any S; input
// rows on 8 bytes, output rows on 16. Up to FA_MAX_S (256) keys a warp holds
// its rows' whole row of scores in registers (the kernels below, on DH);
// above it, at head_dim 64, the one-pass route at the end of this file (S <=
// OP_MAX_S = 1,152: a block's query tile of scores in shared memory, 2
// products in the forward and 3 + 4 in the backward's two launches,
// operands from register tiles, loads behind the products) and beyond that
// the multi-pass route before it (any S: the scores recomputed per pass, 4
// and 7 + 4 products), which also takes head_dim 16, 32 and 48 at every S
// above FA_MAX_S, and 80 at every S (the one-pass route is written for head
// dim 64 only; the kernels above cover 64 dims a warp).

#pragma once

#include "common.cuh"
#include "long_attention.cuh"  // la_quot

#define FA_DH 64

// FA_F32_PROBE, for the builds of tools/fp32_long_probe.py only: 1 leaves
// out the products' FMAs (dot_rows, product, op_dots and op_prod add
// nothing), 2 the staging copies (stage copies nothing); 0, the default,
// neither
#ifndef FA_F32_PROBE
#define FA_F32_PROBE 0
#endif

template <typename K>
static int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// ---------------------------------------------------------------------------
// The kernels, one warp per 8 rows
// ---------------------------------------------------------------------------
//
//   * a block takes 64 rows (queries, or keys in the backward's second
//     phase) of one (image, head), 8 per warp, and stages all S rows of the
//     other side in shared memory with rows 68 floats apart, so that lane c
//     reading row 32 j + c and lanes reading across one row both meet no bank
//     conflict. Staging is by cp.async, every copy in flight at once; the
//     backward kernels stage in two groups and start on the first while the
//     second lands (the forward holds K and then V in one buffer instead, so
//     that two blocks fit an SM). What bounds them on this card is the FMA
//     rate: attention in fp32 is FMAs on the CUDA cores;
//   * each lane holds an 8 x 8 register tile of scores (its 8 rows against
//     columns c, 32 + c, ..., 224 + c), summed over dh in ascending order, so
//     that both backward phases recompute the same scores bit for bit. The
//     dh loop is the outer one: four dh steps of the warp's 8 rows are read
//     once (broadcast float4) for all of the lane's columns, 15 shared reads
//     per 224 FMAs at S = 197 (the FMA rate, not the shared-memory pipe,
//     bounds it);
//   * the products with P (or dS) go through a per-warp 32 x 8 slab of shared
//     memory (a lane writes its column of the 8 rows), each lane then
//     accumulating a 4 x 4 tile of the 8 x 64 output (rows 4 (lane / 16)
//     .. + 3, dims 4 (lane % 16) .. + 3): two float4 reads per 16 FMAs, the
//     columns in ascending order.

#define FA_RW 8                     // rows per warp
#define FA_WARPS 8
#define FA_ROWS (FA_RW * FA_WARPS)  // rows per block
#define FA_NJ (FA_MAX_S / 32)       // column groups: lane c holds column 32 j + c
#define FA_LD 68                    // floats per staged row of the other side

// Rows r0 .. r0 + n - 1 of one (image, head) (global row stride ts) into
// shared memory with row stride LD, by 8-byte cp.async: every copy of the
// block in flight at once (plain loads would wait out the memory latency
// once per loop step); rows >= S are zeros. The caller waits (stage_wait).
template <int LD, int DH = FA_DH>
__device__ __forceinline__ void stage(float* dst, const float* src, long long ts, int r0, int n,
                                      int S) {
  if (FA_F32_PROBE == 2) return;
  for (int i = threadIdx.x; i < n * (DH / 2); i += blockDim.x) {
    const int r = i / (DH / 2);
    const int c = 2 * (i % (DH / 2));
    const bool ok = r0 + r < S;
    cp_async8(dst + r * LD + c, ok ? src + (r0 + r) * ts + c : src, ok);
  }
}

// every staged row has landed, for every thread of the block
__device__ __forceinline__ void stage_wait() {
  cp_async_wait_all();
  __syncthreads();
}

// the same for the rows staged before the last cp_async_commit (the
// backward's first operands; the second group still in flight)
__device__ __forceinline__ void stage_wait_first() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
}

// acc[i][j] = sum over d ascending of A[i][d] * B[32 j + lane][d]: A the warp's
// 8 rows (stride DH, read as broadcasts), B the staged rows (LD apart). Groups
// with 32 j >= S stay 0.
template <int DH = FA_DH, int LD = FA_LD>
__device__ __forceinline__ void dot_rows(float acc[FA_RW][FA_NJ], const float* A, const float* B,
                                         int S, int lane) {
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j)
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) acc[i][j] = 0.0f;
  if (FA_F32_PROBE == 1) return;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[FA_RW];
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) a[i] = *reinterpret_cast<const float4*>(A + i * DH + d);
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) {
      if (32 * j < S) {
        const float4 b = *reinterpret_cast<const float4*>(B + (32 * j + lane) * LD + d);
#pragma unroll
        for (int i = 0; i < FA_RW; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
}

// acc[r][e] = sum over columns c ascending of w[4 rg + r][c] * R[c][4 dg + e]
// (rg = lane / 16, dg = lane % 16): w the register tile (column 32 j + lane
// in w[i][j]), passed through the warp's 32 x 8 slab `slab`; R the staged
// rows (LD apart). At DH below 64 the lanes with 4 dg >= DH sum nothing. At
// DH = 80 (the multi-pass route only) dims 64 .. 79 go to `tail` in the same
// order, a lane's row lane / 4 of the warp's 8 and dims 64 + 4 (lane % 4)
// .. + 3 (store_tail): 20 FMAs a lane a column, as 16 at DH = 64.
template <int DH = FA_DH, int LD = FA_LD>
__device__ __forceinline__ void product(float acc[4][4], const float w[FA_RW][FA_NJ],
                                        float* slab, const float* R, int S, int lane,
                                        float* tail = nullptr) {
  static_assert(DH <= 64 || DH == 80, "product: head_dim up to 64, or 80");
  const int rg = lane >> 4, dg = lane & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
  if constexpr (DH > 64) tail[0] = tail[1] = tail[2] = tail[3] = 0.0f;
  if (FA_F32_PROBE == 1) return;
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j) {
    if (32 * j < S) {
      __syncwarp();  // the slab's last readers are done
      *reinterpret_cast<float4*>(slab + lane * FA_RW) =
          make_float4(w[0][j], w[1][j], w[2][j], w[3][j]);
      *reinterpret_cast<float4*>(slab + lane * FA_RW + 4) =
          make_float4(w[4][j], w[5][j], w[6][j], w[7][j]);
      __syncwarp();
      if (DH < 64 && 4 * dg >= DH) continue;
      const float* rr = R + (32 * j) * LD + 4 * dg;
#pragma unroll 4
      for (int c = 0; c < 32; ++c) {
        const float4 p = *reinterpret_cast<const float4*>(slab + c * FA_RW + 4 * rg);
        const float4 v = *reinterpret_cast<const float4*>(rr + c * LD);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(pr[r], v.x, acc[r][0]);
          acc[r][1] = fmaf(pr[r], v.y, acc[r][1]);
          acc[r][2] = fmaf(pr[r], v.z, acc[r][2]);
          acc[r][3] = fmaf(pr[r], v.w, acc[r][3]);
        }
        if constexpr (DH > 64) {
          const float pt = slab[c * FA_RW + (lane >> 2)];
          const float4 vt = *reinterpret_cast<const float4*>(R + (32 * j + c) * LD + 64 +
                                                             4 * (lane & 3));
          tail[0] = fmaf(pt, vt.x, tail[0]);
          tail[1] = fmaf(pt, vt.y, tail[1]);
          tail[2] = fmaf(pt, vt.z, tail[2]);
          tail[3] = fmaf(pt, vt.w, tail[3]);
        }
      }
    }
  }
}

// Scaled scores to probabilities, in place, with the row statistics: keys >=
// S at -1e30 (probability exactly 0), max, then exp(s - max), then / sum.
__device__ __forceinline__ void softmax_rows(float s[FA_RW][FA_NJ], float mx[FA_RW],
                                             float sum[FA_RW], float scale, int S, int lane) {
#pragma unroll
  for (int i = 0; i < FA_RW; ++i) {
    float m = -3.0e38f;
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) {
      // _rn: never contracted into an FMA, so phase 2 recomputes the same bits
      s[i][j] = (32 * j + lane < S) ? __fmul_rn(s[i][j], scale) : NEG_INF;
      m = fmaxf(m, s[i][j]);
    }
    mx[i] = warp_max(m);
    float l = 0.0f;
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) {
      s[i][j] = expf(__fsub_rn(s[i][j], mx[i]));
      l += s[i][j];
    }
    sum[i] = warp_sum(l);
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) s[i][j] = s[i][j] / sum[i];
  }
}

// the lane's tile of `product` (rows w0 + 4 (lane / 16) + r < S, dims
// 4 (lane % 16) .. + 3 < DH) times `mul` into out (row stride ts)
template <int DH = FA_DH>
__device__ __forceinline__ void store_tile(float* out, long long ts, const float acc[4][4],
                                           float mul, int w0, int S, int lane) {
  const int r0 = w0 + 4 * (lane >> 4), c = 4 * (lane & 15);
  if (DH < 64 && c >= DH) return;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r0 + r < S)
      *reinterpret_cast<float4*>(out + (r0 + r) * ts + c) =
          make_float4(acc[r][0] * mul, acc[r][1] * mul, acc[r][2] * mul, acc[r][3] * mul);
}

// the lane's `tail` of `product` (DH = 80: row w0 + lane / 4 < S, dims 64 +
// 4 (lane % 4) .. + 3) times `mul` into out (row stride ts)
__device__ __forceinline__ void store_tail(float* out, long long ts, const float tail[4],
                                           float mul, int w0, int S, int lane) {
  const int r = w0 + (lane >> 2), c = 64 + 4 * (lane & 3);
  if (r < S)
    *reinterpret_cast<float4*>(out + r * ts + c) =
        make_float4(tail[0] * mul, tail[1] * mul, tail[2] * mul, tail[3] * mul);
}

__host__ __device__ __forceinline__ int padded(int S) { return (S + 31) / 32 * 32; }

// Forward: one block per 64 queries of one (image, head). K and then V take
// turns in one staged buffer (V lands once every warp's scores are done), so
// that two blocks share an SM: one stages while the other computes.

// head_dim DH (64; 16, 32, 48 or 80 on the general route): the other side's rows
// DH + 4 floats apart (68 at 64), which keeps both access patterns free of
// bank conflicts at every DH
template <int DH>
__host__ __device__ constexpr int fa_ld() {
  return DH + 4;
}

template <int DH = FA_DH>
static size_t fwd_smem(int S) {
  return (size_t)padded(S) * fa_ld<DH>() * 4 + (size_t)FA_ROWS * DH * 4 +
         (size_t)FA_WARPS * FA_RW * 32 * 4;
}

template <int DH = FA_DH>
__global__ void __launch_bounds__(FA_WARPS * 32, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int H, long long bs,
                 long long ts, float scale) {
  constexpr int LD = fa_ld<DH>();
  const int SP = padded(S);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* KVs = reinterpret_cast<float*>(fa_smem);  // K, then V
  float* Qs = KVs + SP * LD;                         // this block's queries
  float* slabs = Qs + FA_ROWS * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  stage<LD, DH>(KVs, k + head, ts, 0, SP, S);
  stage<DH, DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  stage_wait();
  float s[FA_RW][FA_NJ], mx[FA_RW], sum[FA_RW];
  if (live) {
    dot_rows<DH, LD>(s, Qs + warp * FA_RW * DH, KVs, S, lane);
    softmax_rows(s, mx, sum, scale, S, lane);
  }
  __syncthreads();  // every warp is done with K
  stage<LD, DH>(KVs, v + head, ts, 0, SP, S);
  stage_wait();
  if (!live) return;
  float acc[4][4];
  product<DH, LD>(acc, s, slabs + warp * FA_RW * 32, KVs, S, lane);
  const long long ots = (long long)H * DH;
  store_tile<DH>(o + (long long)b * S * ots + h * DH, ots, acc, 1.0f, w0, S, lane);
}

// Backward, phase 1: one block per 64 queries: statistics and dQ

template <int DH = FA_DH>
static size_t bwd_rows_smem(int S) {
  return (size_t)2 * padded(S) * fa_ld<DH>() * 4 + (size_t)2 * FA_ROWS * DH * 4 +
         (size_t)FA_WARPS * FA_RW * 32 * 4;
}

template <int DH = FA_DH>
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
flash_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      float* __restrict__ dq, float* __restrict__ stats, int S, int H,
                      long long bs, long long ts, long long gts, float scale) {
  constexpr int LD = fa_ld<DH>();
  const int SP = padded(S);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Ks = reinterpret_cast<float*>(fa_smem);
  float* Vs = Ks + SP * LD;
  float* Qs = Vs + SP * LD;
  float* Os = Qs + FA_ROWS * DH;  // dO of this block's queries
  float* slabs = Os + FA_ROWS * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * DH;
  const long long ots = (long long)H * DH;
  const long long ohead = (long long)b * S * ots + h * DH;
  // K and the queries first: the scores and softmax run while V and dO land
  stage<LD, DH>(Ks, k + head, ts, 0, SP, S);
  stage<DH, DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  stage<LD, DH>(Vs, v + head, ts, 0, SP, S);
  stage<DH, DH>(Os, dout + ohead, ots, r0, FA_ROWS, S);
  cp_async_commit();
  const int w0 = r0 + warp * FA_RW;
  const bool active = w0 < S;  // a warp past S only helps stage
  float p[FA_RW][FA_NJ], dp[FA_RW][FA_NJ], mx[FA_RW], sum[FA_RW];
  stage_wait_first();
  if (active) {
    dot_rows<DH, LD>(p, Qs + warp * FA_RW * DH, Ks, S, lane);
    softmax_rows(p, mx, sum, scale, S, lane);
  }
  stage_wait();
  if (!active) return;
  dot_rows<DH, LD>(dp, Os + warp * FA_RW * DH, Vs, S, lane);
  float dot[FA_RW];
#pragma unroll
  for (int i = 0; i < FA_RW; ++i) {
    float t = 0.0f;
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) t += dp[i][j] * p[i][j];
    dot[i] = warp_sum(t);
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) dp[i][j] = p[i][j] * (dp[i][j] - dot[i]);  // dS
  }
  float acc[4][4];
  product<DH, LD>(acc, dp, slabs + warp * FA_RW * 32, Ks, S, lane);
  store_tile<DH>(dq + (long long)b * S * gts + h * DH, gts, acc, scale, w0, S, lane);
  if (lane == 0) {
    float* st = stats + ((long long)(b * H + h) * S) * 3;
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) {
      if (w0 + i < S) {
        st[(w0 + i) * 3 + 0] = mx[i];
        st[(w0 + i) * 3 + 1] = sum[i];
        st[(w0 + i) * 3 + 2] = dot[i];
      }
    }
  }
}

// Backward, phase 2: one block per 64 keys, every query: dK and dV

template <int DH = FA_DH>
static size_t bwd_cols_smem(int S) {
  return (size_t)2 * padded(S) * fa_ld<DH>() * 4 + (size_t)2 * FA_ROWS * DH * 4 +
         (size_t)3 * padded(S) * 4 + (size_t)FA_WARPS * FA_RW * 32 * 4;
}

template <int DH = FA_DH>
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
flash_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ stats, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int H, long long bs, long long ts,
                      long long gts, float scale) {
  constexpr int LD = fa_ld<DH>();
  const int SP = padded(S);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);
  float* Os = Qs + SP * LD;  // dO, every query
  float* Kt = Os + SP * LD;  // this block's keys
  float* Vt = Kt + FA_ROWS * DH;
  float* rmax = Vt + FA_ROWS * DH;
  float* rsum = rmax + SP;
  float* rdot = rsum + SP;
  float* slabs = rdot + SP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * DH;
  const long long ots = (long long)H * DH;
  const long long ohead = (long long)b * S * ots + h * DH;
  // the queries and this block's keys first: P^T runs while dO and V land
  stage<LD, DH>(Qs, q + head, ts, 0, SP, S);
  stage<DH, DH>(Kt, k + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  stage<LD, DH>(Os, dout + ohead, ots, 0, SP, S);
  stage<DH, DH>(Vt, v + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  const float* st = stats + ((long long)(b * H + h) * S) * 3;
  for (int c = threadIdx.x; c < SP; c += blockDim.x) {  // pad queries: inert
    rmax[c] = c < S ? st[c * 3 + 0] : 0.0f;
    rsum[c] = c < S ? st[c * 3 + 1] : 1.0f;
    rdot[c] = c < S ? st[c * 3 + 2] : 0.0f;
  }
  const int w0 = r0 + warp * FA_RW;
  const bool active = w0 < S;  // a warp past S only helps stage

  // P^T and dP^T: rows are this warp's keys, columns the queries 32 j + lane
  float p[FA_RW][FA_NJ], ds[FA_RW][FA_NJ];
  stage_wait_first();
  if (active) {
    dot_rows<DH, LD>(p, Kt + warp * FA_RW * DH, Qs, S, lane);
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) {
      const int c = 32 * j + lane;
      const bool live = c < S;
      const float m = rmax[live ? c : 0], l = rsum[live ? c : 0];
#pragma unroll
      for (int i = 0; i < FA_RW; ++i)  // the scores and P of phase 1, bit for bit
        p[i][j] = live ? expf(__fsub_rn(__fmul_rn(p[i][j], scale), m)) / l : 0.0f;
    }
  }
  stage_wait();
  if (!active) return;
  dot_rows<DH, LD>(ds, Vt + warp * FA_RW * DH, Os, S, lane);
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j) {
    const float dt = rdot[32 * j + lane < S ? 32 * j + lane : 0];
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) ds[i][j] = p[i][j] * (ds[i][j] - dt);
  }
  float* slab = slabs + warp * FA_RW * 32;
  float acc[4][4];
  product<DH, LD>(acc, p, slab, Os, S, lane);  // dV = P^T dO
  const long long ghead = (long long)b * S * gts + h * DH;
  store_tile<DH>(dv + ghead, gts, acc, 1.0f, w0, S, lane);
  product<DH, LD>(acc, ds, slab, Qs, S, lane);  // dK = dS^T q / sqrt(dh)
  store_tile<DH>(dk + ghead, gts, acc, scale, w0, S, lane);
}

// ---------------------------------------------------------------------------
// Above FA_MAX_S keys: several passes over 256-key chunks
// ---------------------------------------------------------------------------
//
// Replaces, for fp32 sequences longer than the row of scores a warp's
// registers hold (384 px images: S = 577; the folder datasets at 256 px: S =
// 257), the attention of the Pallas kernels the kernels above replace
// (vit2spn_tpu/ops/fused_block.py::_attention inside _backbone_fwd_kernel and
// _fwd_kernel, ::_attention_bwd inside _attn_bwd_kernel and
// _merged_bwd_kernel, vit2spn_tpu/ops/flash_attention.py::_fwd_kernel and
// ::_bwd_kernel), which pad the sequence and take the softmax over the whole
// padded row at once. The function and its rounding points are the ones
// above, per (image, head), in fp32 FMAs on the CUDA cores:
//
//   s = (q . k, dh ascending) * 1/8 (__fmul_rn), keys >= S at -1e30
//   m = the row max over ALL keys;  l = sum of exp(s - m);  p = exp(s - m) / l
//   o = p v;  dV = p^T dO;  dP = dO v^T;  dS = p (dP - rowsum(dP p))
//   dQ = dS k / 8;  dK = dS^T q / 8;  queries >= S out of dK and dV
//
// A running-max (online) softmax would rescale partial sums and round at
// other points: a different function. So p is formed only once m and l over
// every key are known, and nothing a row holds between passes is rescaled.
// The keys (the queries, in the key-major phase) come in chunks of LF_CHUNK
// = 256, so that the register tile of dot_rows serves each chunk as it
// serves a whole row above; nothing of a row's scores is kept between
// passes, and the row statistics pass through device memory, so S is not
// bounded. Per 64-query block (8 rows a warp):
//
//   forward    pass 1  s of every chunk: m
//              pass 2  s again: l
//              pass 3  s again and p, o += p v
//   rows phase passes 1 and 2; pass 3: s and dP, dot = rowsum(dP p);
//   (launch 1) pass 4: s and dP, dS, dQ += dS k; m, l and dot to ws
//   cols phase per 64 keys, every 256-query chunk of Q and dO: s^T and dP^T,
//   (launch 2) p and dS from each query's m, l, dot (ws), dV += p^T dO,
//              dK += dS^T q
//
// The orders of the sums, fixed, so that two runs give the same bits: the
// scores as dot_rows sums them (every pass and both phases recompute the
// same bits: the key-major phase's k . q multiplies the same pairs in the
// same order); the max in any order (it is exact); l and dot per chunk as
// softmax_rows sums a row (a lane over its columns 32 j + lane, j
// ascending, then warp_sum), the chunks' sums added in chunk order from 0;
// o, dQ, dV and dK per chunk as `product` sums (columns ascending from 0),
// the chunks' partial tiles added in chunk order from 0. The kernels above
// are left as they were; this route calls their helpers unchanged, on the
// head_dim DH as they take it (rows fa_ld<DH>() floats apart in a chunk
// buffer): the head_dim-64 instantiations are the code of before.
//
// What bounds it on this card: every product and every recomputed score is
// an fp32 FMA on the CUDA cores (67 TFLOP/s). The function's products are 2
// S^2 64 a (image, head) each, 2 in the forward and 5 in the backward; the
// passes run 4 (the forward) and 7 + 4 (the backward's two launches) of
// that size, beside an expf per score and pass, and an IEEE division per
// score in the passes that form p, and `product` passes its weights
// through a per-warp slab (two float4 shared reads for every 16 FMAs).
// Shared memory (two 256-row chunk buffers of 68 floats a row: 139 KB)
// leaves one block of 8 warps an SM: the forward's pass 3 stages the next K
// chunk while the product with V runs, the statistics passes double-buffer
// K, the backward stages K (or Q) and V (or dO) in two groups and starts on
// the first while the second lands. Since the one-pass route below took S
// up to OP_MAX_S, this route runs only above it (or where a test entry
// forces it): it takes any S.

#define LF_CHUNK FA_MAX_S  // keys (queries, in the key-major phase) per staged chunk
// floats of one chunk buffer: LF_CHUNK rows fa_ld<DH>() apart
template <int DH>
__host__ __device__ constexpr int lf_buf() {
  return LF_CHUNK * fa_ld<DH>();
}

__device__ __forceinline__ int lf_chunks(int S) { return (S + LF_CHUNK - 1) / LF_CHUNK; }

// rows of chunk c that are below S
__device__ __forceinline__ int lf_rows(int c, int S) {
  return min(LF_CHUNK, S - c * LF_CHUNK);
}

// Rows c * LF_CHUNK .. of a (image, head) into a chunk buffer (rows >= S
// zeros), committed as one cp.async group
template <int DH>
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, long long ts, int c,
                                            int S) {
  stage<fa_ld<DH>(), DH>(dst, src, ts, c * LF_CHUNK, padded(lf_rows(c, S)), S);
  cp_async_commit();
}

// the chunk's scores (dot_rows' tile over its n keys) scaled, keys >= n at
// -1e30, as softmax_rows takes them
__device__ __forceinline__ void scale_scores(float s[FA_RW][FA_NJ], float scale, int n,
                                             int lane) {
#pragma unroll
  for (int i = 0; i < FA_RW; ++i)
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j)
      s[i][j] = (32 * j + lane < n) ? __fmul_rn(s[i][j], scale) : NEG_INF;
}

// scaled scores to p = exp(s - m) / l, in place
__device__ __forceinline__ void probs(float s[FA_RW][FA_NJ], const float mx[FA_RW],
                                      const float l[FA_RW]) {
#pragma unroll
  for (int i = 0; i < FA_RW; ++i)
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) s[i][j] = expf(__fsub_rn(s[i][j], mx[i])) / l[i];
}

__device__ __forceinline__ void add_tile(float acc[4][4], const float part[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] += part[r][e];
}

// add_tile for `product`'s tail (DH = 80), in the same chunk order
__device__ __forceinline__ void add_tail(float acc[4], const float part[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// Passes 1 and 2: the max m and the sum l of the warp's 8 rows (Qw, stride
// DH, already staged or in a committed group) over every key, the K
// chunks double-buffered in buf0 and buf1. Every thread of the block calls
// it (staging, barriers); `live` warps compute.
template <int DH>
__device__ __forceinline__ void row_stats(float mx[FA_RW], float l[FA_RW], const float* Qw,
                                          float* buf0, float* buf1, const float* kh,
                                          long long ts, int S, float scale, bool live,
                                          int lane) {
  const int nc = lf_chunks(S);
#pragma unroll
  for (int i = 0; i < FA_RW; ++i) {
    mx[i] = -3.0e38f;
    l[i] = 0.0f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    stage_chunk<DH>(buf0, kh, ts, 0, S);
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) {
        stage_chunk<DH>(c & 1 ? buf0 : buf1, kh, ts, c + 1, S);
        stage_wait_first();
      } else {
        stage_wait();
      }
      if (live) {
        const int n = lf_rows(c, S);
        float s[FA_RW][FA_NJ];
        dot_rows<DH, fa_ld<DH>()>(s, Qw, c & 1 ? buf1 : buf0, n, lane);
        scale_scores(s, scale, n, lane);
#pragma unroll
        for (int i = 0; i < FA_RW; ++i) {
          if (pass == 0) {
#pragma unroll
            for (int j = 0; j < FA_NJ; ++j) mx[i] = fmaxf(mx[i], s[i][j]);
          } else {
            float t = 0.0f;
#pragma unroll
            for (int j = 0; j < FA_NJ; ++j) t += expf(__fsub_rn(s[i][j], mx[i]));
            l[i] += warp_sum(t);
          }
        }
      }
      __syncthreads();  // every warp is done with this buffer
    }
    if (pass == 0 && live) {
#pragma unroll
      for (int i = 0; i < FA_RW; ++i) mx[i] = warp_max(mx[i]);
    }
  }
}

// Shared memory: two chunk buffers, the block's 64-row tiles (queries, dO;
// keys, values), the per-warp slabs, and in the cols phase three statistics
// of each query of a chunk
template <int DH>
static size_t long_f32_smem(int tiles, int stats) {
  return (size_t)2 * lf_buf<DH>() * 4 + (size_t)tiles * FA_ROWS * DH * 4 +
         (size_t)stats * LF_CHUNK * 4 + (size_t)FA_WARPS * FA_RW * 32 * 4;
}

// Forward: one block per 64 queries of one (image, head)
template <int DH = FA_DH>
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
long_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int S, int H,
                    long long bs, long long ts, float scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Ks = reinterpret_cast<float*>(fa_smem);  // K chunks (both buffers in passes 1, 2)
  float* Vs = Ks + lf_buf<DH>();                  // V chunks
  float* Qs = Vs + lf_buf<DH>();
  float* slabs = Qs + FA_ROWS * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  const float* Qw = Qs + warp * FA_RW * DH;
  stage<DH, DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  float mx[FA_RW], l[FA_RW];
  row_stats<DH>(mx, l, Qw, Ks, Vs, k + head, ts, S, scale, live, lane);
  // pass 3: the next K chunk lands while the product with this V runs
  const int nc = lf_chunks(S);
  float acc[4][4] = {}, part[4][4];
  float acct[4] = {}, partt[4];  // dims 64 .. 79 at DH = 80 (product's tail)
  stage_chunk<DH>(Ks, k + head, ts, 0, S);
  stage_chunk<DH>(Vs, v + head, ts, 0, S);
  for (int c = 0; c < nc; ++c) {
    const int n = lf_rows(c, S);
    stage_wait_first();  // K of chunk c (V of it may still be in flight)
    float p[FA_RW][FA_NJ];
    if (live) {
      dot_rows<DH, fa_ld<DH>()>(p, Qw, Ks, n, lane);
      scale_scores(p, scale, n, lane);
      probs(p, mx, l);
    }
    __syncthreads();  // every warp is done with K
    if (c + 1 < nc) {  // V of chunk c lands
      stage_chunk<DH>(Ks, k + head, ts, c + 1, S);
      stage_wait_first();
    } else {
      stage_wait();
    }
    if (live) {
      product<DH, fa_ld<DH>()>(part, p, slabs + warp * FA_RW * 32, Vs, n, lane, partt);
      add_tile(acc, part);
      if constexpr (DH > 64) add_tail(acct, partt);
    }
    __syncthreads();  // every warp is done with V
    if (c + 1 < nc) stage_chunk<DH>(Vs, v + head, ts, c + 1, S);
  }
  if (!live) return;
  const long long ots = (long long)H * DH;
  store_tile<DH>(o + (long long)b * S * ots + h * DH, ots, acc, 1.0f, w0, S, lane);
  if constexpr (DH > 64)
    store_tail(o + (long long)b * S * ots + h * DH, ots, acct, 1.0f, w0, S, lane);
}

// Backward, phase 1: one block per 64 queries: the statistics and dQ
template <int DH = FA_DH>
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
long_bwd_rows_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ stats, int S, int H,
                         long long bs, long long ts, long long gts, float scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Ks = reinterpret_cast<float*>(fa_smem);  // K chunks (both buffers in passes 1, 2)
  float* Vs = Ks + lf_buf<DH>();                  // V chunks
  float* Qs = Vs + lf_buf<DH>();
  float* Os = Qs + FA_ROWS * DH;  // dO of this block's queries
  float* slabs = Os + FA_ROWS * DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * DH;
  const long long ots = (long long)H * DH;
  const long long ohead = (long long)b * S * ots + h * DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  const float* Qw = Qs + warp * FA_RW * DH;
  const float* Ow = Os + warp * FA_RW * DH;
  stage<DH, DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  stage<DH, DH>(Os, dout + ohead, ots, r0, FA_ROWS, S);
  cp_async_commit();
  float mx[FA_RW], l[FA_RW], dot[FA_RW] = {};
  row_stats<DH>(mx, l, Qw, Ks, Vs, k + head, ts, S, scale, live, lane);
  // pass 3: dot = rowsum(dP p); pass 4: dS and dQ. The scores start on K
  // while V lands
  const int nc = lf_chunks(S);
  float acc[4][4] = {}, part[4][4];
  float acct[4] = {}, partt[4];  // dims 64 .. 79 at DH = 80 (product's tail)
  for (int pass = 3; pass <= 4; ++pass) {
    for (int c = 0; c < nc; ++c) {
      const int n = lf_rows(c, S);
      stage_chunk<DH>(Ks, k + head, ts, c, S);
      stage_chunk<DH>(Vs, v + head, ts, c, S);
      stage_wait_first();
      float p[FA_RW][FA_NJ], dp[FA_RW][FA_NJ];
      if (live) {
        dot_rows<DH, fa_ld<DH>()>(p, Qw, Ks, n, lane);
        scale_scores(p, scale, n, lane);
        probs(p, mx, l);
      }
      stage_wait();
      if (live) {
        dot_rows<DH, fa_ld<DH>()>(dp, Ow, Vs, n, lane);
#pragma unroll
        for (int i = 0; i < FA_RW; ++i) {
          if (pass == 3) {
            float t = 0.0f;
#pragma unroll
            for (int j = 0; j < FA_NJ; ++j) t += dp[i][j] * p[i][j];
            dot[i] += warp_sum(t);
          } else {
#pragma unroll
            for (int j = 0; j < FA_NJ; ++j) dp[i][j] = p[i][j] * (dp[i][j] - dot[i]);  // dS
          }
        }
        if (pass == 4) {
          product<DH, fa_ld<DH>()>(part, dp, slabs + warp * FA_RW * 32, Ks, n, lane, partt);
          add_tile(acc, part);
          if constexpr (DH > 64) add_tail(acct, partt);
        }
      }
      __syncthreads();  // every warp is done with both buffers
    }
  }
  if (!live) return;
  store_tile<DH>(dq + (long long)b * S * gts + h * DH, gts, acc, scale, w0, S, lane);
  if constexpr (DH > 64)
    store_tail(dq + (long long)b * S * gts + h * DH, gts, acct, scale, w0, S, lane);
  if (lane == 0) {
    float* st = stats + ((long long)(b * H + h) * S) * 3;
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) {
      if (w0 + i < S) {
        st[(w0 + i) * 3 + 0] = mx[i];
        st[(w0 + i) * 3 + 1] = l[i];
        st[(w0 + i) * 3 + 2] = dot[i];
      }
    }
  }
}

// Backward, phase 2: one block per 64 keys, every query in 256-query
// chunks: dK and dV
template <int DH = FA_DH>
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
long_bwd_cols_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ stats, float* __restrict__ dk,
                         float* __restrict__ dv, int S, int H, long long bs, long long ts,
                         long long gts, float scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Qc = reinterpret_cast<float*>(fa_smem);  // a chunk of queries
  float* Oc = Qc + lf_buf<DH>();                  // their dO
  float* Kt = Oc + lf_buf<DH>();                  // this block's keys
  float* Vt = Kt + FA_ROWS * DH;
  float* rmax = Vt + FA_ROWS * DH;
  float* rsum = rmax + LF_CHUNK;
  float* rdot = rsum + LF_CHUNK;
  float* slab = rdot + LF_CHUNK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * DH;
  const long long ots = (long long)H * DH;
  const long long ohead = (long long)b * S * ots + h * DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  const float* Kw = Kt + warp * FA_RW * DH;
  const float* Vw = Vt + warp * FA_RW * DH;
  slab += warp * FA_RW * 32;
  stage<DH, DH>(Kt, k + head, ts, r0, FA_ROWS, S);
  stage<DH, DH>(Vt, v + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  const float* st = stats + ((long long)(b * H + h) * S) * 3;
  const int nc = lf_chunks(S);
  float adk[4][4] = {}, adv[4][4] = {}, part[4][4];
  float adkt[4] = {}, advt[4] = {}, partt[4];  // dims 64 .. 79 at DH = 80 (product's tail)
  for (int c = 0; c < nc; ++c) {
    const int n = lf_rows(c, S), q0 = c * LF_CHUNK;
    // the queries first: P^T runs while dO lands
    stage_chunk<DH>(Qc, q + head, ts, c, S);
    stage_chunk<DH>(Oc, dout + ohead, ots, c, S);
    for (int i = threadIdx.x; i < LF_CHUNK; i += blockDim.x) {  // pad queries: inert
      rmax[i] = i < n ? st[(q0 + i) * 3 + 0] : 0.0f;
      rsum[i] = i < n ? st[(q0 + i) * 3 + 1] : 1.0f;
      rdot[i] = i < n ? st[(q0 + i) * 3 + 2] : 0.0f;
    }
    stage_wait_first();
    // P^T and dP^T: rows are this warp's keys, columns the queries 32 j + lane
    float p[FA_RW][FA_NJ], ds[FA_RW][FA_NJ];
    if (live) {
      dot_rows<DH, fa_ld<DH>()>(p, Kw, Qc, n, lane);
#pragma unroll
      for (int j = 0; j < FA_NJ; ++j) {
        const int cq = 32 * j + lane;
        const bool ok = cq < n;
        const float m = rmax[ok ? cq : 0], l = rsum[ok ? cq : 0];
#pragma unroll
        for (int i = 0; i < FA_RW; ++i)  // the scores and p of phase 1, bit for bit
          p[i][j] = ok ? expf(__fsub_rn(__fmul_rn(p[i][j], scale), m)) / l : 0.0f;
      }
    }
    stage_wait();
    if (live) {
      dot_rows<DH, fa_ld<DH>()>(ds, Vw, Oc, n, lane);
#pragma unroll
      for (int j = 0; j < FA_NJ; ++j) {
        const float dt = rdot[32 * j + lane < n ? 32 * j + lane : 0];
#pragma unroll
        for (int i = 0; i < FA_RW; ++i) ds[i][j] = p[i][j] * (ds[i][j] - dt);
      }
      product<DH, fa_ld<DH>()>(part, p, slab, Oc, n, lane, partt);  // dV += P^T dO
      add_tile(adv, part);
      if constexpr (DH > 64) add_tail(advt, partt);
      product<DH, fa_ld<DH>()>(part, ds, slab, Qc, n, lane, partt);  // dK += dS^T q
      add_tile(adk, part);
      if constexpr (DH > 64) add_tail(adkt, partt);
    }
    __syncthreads();  // every warp is done with the chunk and its statistics
  }
  if (!live) return;
  const long long ghead = (long long)b * S * gts + h * DH;
  store_tile<DH>(dv + ghead, gts, adv, 1.0f, w0, S, lane);
  store_tile<DH>(dk + ghead, gts, adk, scale, w0, S, lane);
  if constexpr (DH > 64) {
    store_tail(dv + ghead, gts, advt, 1.0f, w0, S, lane);
    store_tail(dk + ghead, gts, adkt, scale, w0, S, lane);
  }
}

// ---------------------------------------------------------------------------
// Up to OP_MAX_S keys: one pass, the scores of a query tile in shared memory
// ---------------------------------------------------------------------------
//
// The function of the multi-pass route above, for S up to OP_MAX_S = 1,152,
// where a tile of 32 rows of scores fits beside its ring. Per (image, head):
//
//   forward    (32 queries a block) s = q k^T once, K in 128-key chunks,
//              into a 32 x S tile; m, then e = exp(s - m) in place with l,
//              then p = e / l; o = p V, V in 128-key chunks
//   rows phase (16 queries a block) s once into one tile, p as above; dP =
//   (launch 1) dO V^T once into a second tile; dot = rowsum(dP p); dS = p
//              (dP - dot) in place; dQ = dS K; m, l and dot to ws
//   cols phase (64 keys a block, every query in 64-query chunks) s^T and
//   (launch 2) dP^T, then p and dS from each query's m, l, dot (ws) into
//              two 64 x 64 tiles; dV += p^T dO, dK += dS^T q
//
// So 2 products of 2 S^2 64 an (image, head) in the forward (the multi-pass
// route: 4) and 3 + 4 in the backward (7 + 4), and one expf a score in the
// forward and the rows phase (2 and 4). Each K, V, Q or dO chunk is staged
// by cp.async (16-byte copies where every row starts on 16 bytes) into a
// two-stage ring: the next chunk lands while the current one is multiplied
// (one barrier a chunk, op_wait), the first V (K) chunk while the softmax
// (dS) runs.
//
// What bounds it on this card: the FMAs on the CUDA cores and the shared
// memory that feeds them (tools/fp32_long_probe.py at S = 577: leaving out
// the FMAs saves ~60% of the time, the staging copies ~16%). Shared memory
// delivers 32 floats a clock an SM against 128 FMAs, so a thread's register
// tile sets how many FMAs each float it reads feeds. The tiles of scores
// bound the block: 32 rows (16 in the rows phase, which holds two) of S
// fp32 scores beside a two-stage ring of 128-key chunks leave one 8-warp
// block an SM, so a score product's chunk holds 32 x 128 outputs, 16 a
// thread: 4 x 4 tiles (2 FMAs a float read; 2 x 4 in the rows phase, 1.3;
// 4 x 4 in the cols phase). The products with p and dS have 32 x 64 (16 x
// 64, 64 x 64) outputs over S keys: each staged chunk's keys are split into
// runs that thread groups sum at once, so a thread holds a 4 x 8 tile (2.7
// FMAs a float): 4 runs of 32 keys for o, 8 runs of 16 for dQ, 2 runs of 32
// queries for dK and dV. Operands are read as float4 and the next step's
// are loaded while this step's FMAs run. Chunks of 256 keys where they fit
// (S <= 640: 4 x 8 score tiles in the forward, 4 x 4 in the rows phase)
// measured 7% slower, and a third ring stage no faster: with one block an
// SM the steps' latency, not the loads, is what is left.

// The orders: each score summed over dh in ascending order as dot_rows sums
// it (k . q and q . k alike); the max in any order; l and the rowsum per
// 256-key chunk as a lane of softmax_rows sums its keys (32 j + lane, j
// ascending; the rowsum's terms one fma each, as nvcc contracts the
// multi-pass route's t += dP p), then warp_sum, the chunks added in order;
// the quotient la_quot (csrc/long_attention.cuh: the IEEE division's bits;
// __fdiv_rn for a warp with an operand outside its range). So p and dS are
// the multi-pass route's bit for bit. The products with p and dS take
// another order: run g of every staged chunk summed in ascending order into
// one partial tile over the whole row (column), the runs' tiles added in
// run order (op_combine). The outputs differ from the multi-pass route's by
// fp32 reassociation (chip_smoke.py holds both against float64); two runs,
// the stage and the core give the same bits.

#define OP_MAX_S 1152     // the longest S of this route: onepass_smem(S) <= 232,448 B
#define OP_KC 128         // keys a staged K or V chunk (forward, rows phase)
#define OP_QC 64          // queries a staged Q and dO chunk (cols phase)
#define OP_FWD_ROWS 32    // queries a forward block
#define OP_BWD_ROWS 16    // queries a rows-phase block
#define OP_COLS_KEYS 64   // keys a cols-phase block
#define OP_THREADS (FA_WARPS * 32)

// columns of a score tile (S in whole chunks) and its row stride (4 floats
// more: its rows start on other banks)
__host__ __device__ __forceinline__ int op_cols(int S) { return (S + OP_KC - 1) / OP_KC * OP_KC; }
__host__ __device__ __forceinline__ int op_ld(int S) { return op_cols(S) + 4; }

// the forward's tile of 32 rows, or the rows phase's two of 16, beside the
// query tile (or the query and dO tiles) and the ring's two stages
static size_t onepass_smem(int S) {
  return ((size_t)32 * op_ld(S) + 32 * FA_LD + 2 * OP_KC * FA_LD) * 4;
}
#define OP_COLS_STAGE (2 * OP_QC * FA_LD + 3 * OP_QC)  // Q, dO, 3 statistics a query
static size_t onepass_cols_smem() {
  return ((size_t)4 * OP_COLS_KEYS * FA_LD + 2 * OP_COLS_STAGE) * 4;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// c[i][j] = the dot over dh of rows A + i as and B + j bs, ascending, as
// dot_rows sums it; column groups j >= jn stay 0. The operands of the next
// 4 dh are loaded while this step's FMAs run (two register sets).
template <int TM, int TN>
__device__ __forceinline__ void op_dots(float (&c)[TM][TN], const float* A, int as,
                                        const float* B, int bs, int jn) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) c[i][j] = 0.0f;
  if (FA_F32_PROBE == 1) return;
  float4 a[2][TM], b[2][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) a[0][i] = ld4(A + i * as);
#pragma unroll
  for (int j = 0; j < TN; ++j) b[0][j] = ld4(B + j * bs);
#pragma unroll
  for (int d = 0; d < FA_DH; d += 4) {
    const int cur = (d >> 2) & 1;
    if (d + 4 < FA_DH) {
#pragma unroll
      for (int i = 0; i < TM; ++i) a[cur ^ 1][i] = ld4(A + i * as + d + 4);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[cur ^ 1][j] = ld4(B + j * bs + d + 4);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (j < jn) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          c[i][j] = fmaf(a[cur][i].x, b[cur][j].x, c[i][j]);
          c[i][j] = fmaf(a[cur][i].y, b[cur][j].y, c[i][j]);
          c[i][j] = fmaf(a[cur][i].z, b[cur][j].z, c[i][j]);
          c[i][j] = fmaf(a[cur][i].w, b[cur][j].w, c[i][j]);
        }
      }
    }
  }
}

// The operands of op_prod's step at k: TM float4 of W (4 keys of each row)
// and 4 rows of TG float4 of R
template <int TM, int TG>
__device__ __forceinline__ void op_prod_load(float4 (&w)[TM], float4 (&r)[4][TG], const float* W,
                                             int ws, const float* R, int k) {
#pragma unroll
  for (int i = 0; i < TM; ++i) w[i] = ld4(W + i * ws + k);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < TG; ++g) r[kk][g] = ld4(R + (k + kk) * FA_LD + 32 * g);
}

__device__ __forceinline__ float lane4(const float4& v, int kk) {
  return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

// p[i][4 g + e] += the sum over k in [0, n) ascending (n a positive multiple
// of 4) of W[i ws + k] R[k FA_LD + 32 g + e], as `product` sums: W rows of a
// tile of p or dS, R a staged chunk's rows at the thread's dims. The next
// step's operands are loaded while this step's FMAs run (the last step
// loads its own again).
template <int TM, int TG>
__device__ __forceinline__ void op_prod(float (&p)[TM][4 * TG], const float* W, int ws,
                                        const float* R, int n) {
  if (FA_F32_PROBE == 1) return;
  float4 w[TM], r[4][TG];
  op_prod_load(w, r, W, ws, R, 0);
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float4 wn[TM], rn[4][TG];
    op_prod_load(wn, rn, W, ws, R, min(k + 4, n - 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < TG; ++g)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = lane4(w[i], kk);
          p[i][4 * g + 0] = fmaf(x, r[kk][g].x, p[i][4 * g + 0]);
          p[i][4 * g + 1] = fmaf(x, r[kk][g].y, p[i][4 * g + 1]);
          p[i][4 * g + 2] = fmaf(x, r[kk][g].z, p[i][4 * g + 2]);
          p[i][4 * g + 3] = fmaf(x, r[kk][g].w, p[i][4 * g + 3]);
        }
#pragma unroll
    for (int i = 0; i < TM; ++i) w[i] = wn[i];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int g = 0; g < TG; ++g) r[kk][g] = rn[kk][g];
  }
}

// The sum of G partial tiles (rows x 64 floats each, from X, in shared
// memory) in group order, times mul, into out (rows os apart) for rows r0 +
// r below S; every thread of the block takes 4 floats at a time
__device__ __forceinline__ void op_combine(float* out, long long os, const float* X, int G,
                                           int rows, int r0, int S, float mul) {
  for (int i = threadIdx.x; i < rows * (FA_DH / 4); i += blockDim.x) {
    const int r = i / (FA_DH / 4), c = 4 * (i % (FA_DH / 4));
    float4 t = ld4(X + r * FA_DH + c);
    for (int g = 1; g < G; ++g) {
      const float4 x = ld4(X + (g * rows + r) * FA_DH + c);
      t.x += x.x;
      t.y += x.y;
      t.z += x.z;
      t.w += x.w;
    }
    if (r0 + r < S)
      *reinterpret_cast<float4*>(out + r * os + c) =
          make_float4(t.x * mul, t.y * mul, t.z * mul, t.w * mul);
  }
}

// a thread's 4 x 8 partial tile (rows row + rs i, dims 4 dg + e and 32 + 4
// dg + e) into tile X (rows x 64 floats)
__device__ __forceinline__ void op_put(float* X, const float (&acc)[4][8], int row, int rs,
                                       int dg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* x = X + (row + rs * i) * FA_DH + 4 * dg;
    *reinterpret_cast<float4*>(x) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(x + 32) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// One warp's WR rows of scaled scores (from t0, ld apart: S live of
// op_cols(S) columns, -1e30 past S) to p in place, the rows side by side:
// m over every key, e = exp(s - m) with l per 256-key chunk as softmax_rows
// sums it, then p = e / l; the columns past S to 0
template <int WR>
__device__ __forceinline__ void op_softmax_rows(float* t0, int ld, int S, float (&m)[WR],
                                                float (&l)[WR], int lane) {
  const int cols = op_cols(S);
#pragma unroll
  for (int i = 0; i < WR; ++i) m[i] = -3.0e38f;
  for (int k = lane; k < cols; k += 32)
#pragma unroll
    for (int i = 0; i < WR; ++i) m[i] = fmaxf(m[i], t0[i * ld + k]);
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    m[i] = warp_max(m[i]);
    l[i] = 0.0f;
  }
  bool slow = false;
  for (int c0 = 0; c0 < S; c0 += LF_CHUNK) {
    float t[WR];
#pragma unroll
    for (int i = 0; i < WR; ++i) t[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) {
      const int k = c0 + 32 * j + lane;
      if (k < S) {
#pragma unroll
        for (int i = 0; i < WR; ++i) {
          const float e = expf(__fsub_rn(t0[i * ld + k], m[i]));
          t0[i * ld + k] = e;
          t[i] += e;
          slow |= e != 0.0f && e < LA_QUOT_MIN;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WR; ++i) l[i] += warp_sum(t[i]);
  }
  // la_quot where every operand of the warp's rows is in its range, else
  // the IEEE division: the same bits
#pragma unroll
  for (int i = 0; i < WR; ++i) slow |= l[i] > LA_QUOT_MAX_L;
  slow = __any_sync(0xffffffffu, slow);
  float r[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) r[i] = la_rcp(l[i]);
  for (int k = lane; k < cols; k += 32)
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const float e = t0[i * ld + k];
      t0[i * ld + k] = k < S ? (slow ? __fdiv_rn(e, l[i]) : la_quot(e, l[i], r[i])) : 0.0f;
    }
}

// Rows r0 .. r0 + n - 1 of one (image, head) (zeros past S) into shared
// memory, rows FA_LD apart: by 16-byte cp.async where every row starts on
// 16 bytes (v16: the callers' fused qkv and its views; half the copies of
// `stage`), else as `stage`
__device__ __forceinline__ void op_rows(float* dst, const float* src, long long ts, int r0,
                                        int n, int S, bool v16) {
  if (!v16) {
    stage<FA_LD>(dst, src, ts, r0, n, S);
    return;
  }
  if (FA_F32_PROBE == 2) return;
  for (int i = threadIdx.x; i < n * (FA_DH / 4); i += blockDim.x) {
    const int r = i / (FA_DH / 4), c = 4 * (i % (FA_DH / 4));
    const bool ok = r0 + r < S;
    cp_async16(dst + r * FA_LD + c, ok ? src + (r0 + r) * ts + c : src, ok);
  }
}

// Chunk c (OP_KC rows from c OP_KC) of src into ring stage t & 1, one
// cp.async group
__device__ __forceinline__ void op_stage(float* ring, const float* src, long long ts, int c,
                                         int t, int S, bool v16) {
  op_rows(ring + (t & 1) * OP_KC * FA_LD, src, ts, c * OP_KC, OP_KC, S, v16);
  cp_async_commit();
}

// The ring's loop, one barrier a chunk: wait until chunk t has landed, then
// the barrier: every thread sees chunk t and is done with chunk t - 1,
// whose stage the caller refills with chunk t + 1 before using chunk t
__device__ __forceinline__ void op_wait() { stage_wait(); }

// the column groups j of a 128-key chunk from c0 (keys kg + 32 j, a warp's
// kg from kg0) that hold a key below S
__device__ __forceinline__ int op_groups(int S, int c0, int kg0) {
  return min(4, max(0, (S - c0 - kg0 + 31) / 32));
}

// the keys below S of a staged chunk from c0 (n rounded up to 4) that run
// g of runs of `len` takes, or 0
__device__ __forceinline__ int op_run(int S, int c0, int chunk, int len, int g) {
  return min(len, ((min(chunk, S - c0) + 3) & ~3) - len * g);
}

// Forward: one block per 32 queries of one (image, head)
__global__ void __launch_bounds__(OP_THREADS, 1)
onepass_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int S, int H,
                       long long bs, long long ts, float scale, int v16) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  const int ld = op_ld(S);
  float* T = reinterpret_cast<float*>(fa_smem);  // 32 rows of scores, then p
  float* Qs = T + OP_FWD_ROWS * ld;
  float* ring = Qs + OP_FWD_ROWS * FA_LD;  // at the end the 4 runs' partial o
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * OP_FWD_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const int nk = op_cols(S) / OP_KC;
  // scores: rows 4 rg + i, keys kg + 32 j of a chunk (a warp: two rg, 16
  // kg); o: run pg (keys 32 pg .. + 31 of each chunk) by threads 64 pg ..,
  // rows orow + 8 i, dims 4 dg + e and 32 + 4 dg + e
  const int rg = 2 * (warp & 3) + (lane >> 4), kg0 = 16 * (warp >> 2), kg = kg0 + (lane & 15);
  const int pg = tid >> 6, orow = (tid >> 3) & 7, dg = tid & 7;
  constexpr int WR = OP_FWD_ROWS / FA_WARPS;  // rows of a warp's softmax
  float acc[4][8] = {};
  op_rows(Qs, q + head, ts, r0, OP_FWD_ROWS, S, v16);
  op_stage(ring, k + head, ts, 0, 0, S, v16);
  for (int t = 0; t < 2 * nk; ++t) {  // K chunks (s), then V chunks (o)
    op_wait();
    if (t + 1 < 2 * nk)
      op_stage(ring, (t + 1 < nk ? k : v) + head, ts, (t + 1) % nk, t + 1, S, v16);
    const float* buf = ring + (t & 1) * OP_KC * FA_LD;
    const int c0 = (t % nk) * OP_KC;
    if (t < nk) {
      float s[4][4];
      op_dots(s, Qs + 4 * rg * FA_LD, FA_LD, buf + kg * FA_LD, 32 * FA_LD, op_groups(S, c0, kg0));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = c0 + kg + 32 * j;
          T[(4 * rg + i) * ld + key] = key < S ? __fmul_rn(s[i][j], scale) : NEG_INF;
        }
      if (t == nk - 1) {  // every score is in: p, while V chunk 0 lands
        __syncthreads();
        float m[WR], l[WR];
        op_softmax_rows(T + warp * WR * ld, ld, S, m, l, lane);
      }
    } else {
      const int n = op_run(S, c0, OP_KC, 32, pg);
      if (n > 0)
        op_prod<4, 2>(acc, T + orow * ld + c0 + 32 * pg, 8 * ld, buf + 32 * pg * FA_LD + 4 * dg,
                      n);
    }
  }
  __syncthreads();  // every warp is done with the ring
  op_put(ring + pg * OP_FWD_ROWS * FA_DH, acc, orow, 8, dg);
  __syncthreads();
  const long long ots = (long long)H * FA_DH;
  op_combine(o + (long long)b * S * ots + r0 * ots + h * FA_DH, ots, ring, 4, OP_FWD_ROWS, r0, S,
             1.0f);
}

// Backward, phase 1: one block per 16 queries: the statistics and dQ
__global__ void __launch_bounds__(OP_THREADS, 1)
onepass_bwd_rows_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            float* __restrict__ dq, float* __restrict__ stats, int S, int H,
                            long long bs, long long ts, long long gts, float scale, int v16) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  const int ld = op_ld(S);
  float* P = reinterpret_cast<float*>(fa_smem);  // 16 rows of scores, then p
  float* D = P + OP_BWD_ROWS * ld;                // dP, then dS
  float* Qs = D + OP_BWD_ROWS * ld;
  float* Os = Qs + OP_BWD_ROWS * FA_LD;    // dO of this block's queries
  float* ring = Os + OP_BWD_ROWS * FA_LD;  // at the end the 8 runs' partial dQ
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * OP_BWD_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  const int nk = op_cols(S) / OP_KC;
  // s and dP: rows 2 rg + i, keys kg + 32 j (a warp: four rg, 8 kg); dQ:
  // run `warp` (keys 16 warp .. + 15 of each chunk), rows qrow + 4 i, dims
  // 4 dg + e and 32 + 4 dg + e
  const int rg = (lane >> 3) + 4 * (warp & 1), kg0 = 8 * (warp >> 1), kg = kg0 + (lane & 7);
  const int qrow = lane >> 3, dg = lane & 7;
  constexpr int WR = OP_BWD_ROWS / FA_WARPS;  // rows of a warp's softmax and dS
  float mx[WR], l[WR], dot[WR];
  float acc[4][8] = {};
  op_rows(Qs, q + head, ts, r0, OP_BWD_ROWS, S, v16);
  op_rows(Os, dout + ohead, ots, r0, OP_BWD_ROWS, S, v16);
  op_stage(ring, k + head, ts, 0, 0, S, v16);
  for (int t = 0; t < 3 * nk; ++t) {  // K chunks (s), V chunks (dP), K chunks (dQ)
    op_wait();
    if (t + 1 < 3 * nk)
      op_stage(ring, ((t + 1) / nk == 1 ? v : k) + head, ts, (t + 1) % nk, t + 1, S, v16);
    const float* buf = ring + (t & 1) * OP_KC * FA_LD;
    const int c0 = (t % nk) * OP_KC;
    if (t < 2 * nk) {
      float s[2][4];
      op_dots(s, (t < nk ? Qs : Os) + 2 * rg * FA_LD, FA_LD, buf + kg * FA_LD, 32 * FA_LD,
              op_groups(S, c0, kg0));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = c0 + kg + 32 * j;
          if (t < nk)
            P[(2 * rg + i) * ld + key] = key < S ? __fmul_rn(s[i][j], scale) : NEG_INF;
          else
            D[(2 * rg + i) * ld + key] = s[i][j];
        }
      if (t == nk - 1) {  // p, while V chunk 0 lands
        __syncthreads();
        op_softmax_rows(P + warp * WR * ld, ld, S, mx, l, lane);
      } else if (t == 2 * nk - 1) {  // dot and dS, while K chunk 0 lands
        __syncthreads();
        const float* pr = P + warp * WR * ld;
        float* dr = D + warp * WR * ld;
#pragma unroll
        for (int i = 0; i < WR; ++i) dot[i] = 0.0f;
        for (int k0 = 0; k0 < S; k0 += LF_CHUNK) {
          float tt[WR];
#pragma unroll
          for (int i = 0; i < WR; ++i) tt[i] = 0.0f;
#pragma unroll
          for (int j = 0; j < FA_NJ; ++j) {
            const int key = k0 + 32 * j + lane;
            if (key < S)
#pragma unroll
              for (int i = 0; i < WR; ++i) tt[i] = fmaf(dr[i * ld + key], pr[i * ld + key], tt[i]);
          }
#pragma unroll
          for (int i = 0; i < WR; ++i) dot[i] += warp_sum(tt[i]);
        }
        for (int key = lane; key < op_cols(S); key += 32)
#pragma unroll
          for (int i = 0; i < WR; ++i)
            dr[i * ld + key] = key < S ? pr[i * ld + key] * (dr[i * ld + key] - dot[i]) : 0.0f;
      }
    } else {
      const int n = op_run(S, c0, OP_KC, 16, warp);
      if (n > 0)
        op_prod<4, 2>(acc, D + qrow * ld + c0 + 16 * warp, 4 * ld,
                      buf + 16 * warp * FA_LD + 4 * dg, n);
    }
  }
  __syncthreads();  // every warp is done with the ring
  op_put(ring + warp * OP_BWD_ROWS * FA_DH, acc, qrow, 4, dg);
  __syncthreads();
  op_combine(dq + (long long)b * S * gts + r0 * gts + h * FA_DH, gts, ring, FA_WARPS,
             OP_BWD_ROWS, r0, S, scale);
  if (lane == 0) {
    float* st = stats + ((long long)(b * H + h) * S) * 3;
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const int r = r0 + warp * WR + i;
      if (r < S) {
        st[r * 3 + 0] = mx[i];
        st[r * 3 + 1] = l[i];
        st[r * 3 + 2] = dot[i];
      }
    }
  }
}

// Backward, phase 2: one block per 64 keys, every query in 64-query chunks:
// dK and dV
__global__ void __launch_bounds__(OP_THREADS, 1)
onepass_bwd_cols_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ stats, float* __restrict__ dk,
                            float* __restrict__ dv, int S, int H, long long bs, long long ts,
                            long long gts, float scale, int v16) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Kt = reinterpret_cast<float*>(fa_smem);  // this block's keys
  float* Vt = Kt + OP_COLS_KEYS * FA_LD;
  float* Pt = Vt + OP_COLS_KEYS * FA_LD;    // a chunk's p^T: [key][query]
  float* Dt = Pt + OP_COLS_KEYS * FA_LD;    // its dS^T
  float* ring = Dt + OP_COLS_KEYS * FA_LD;  // 2 stages of Q, dO, each query's m, l, dot;
                                            // at the end the 2 runs' partial dV, dK
  constexpr int STAGE = OP_COLS_STAGE;
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * OP_COLS_KEYS;
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  const float* st = stats + ((long long)(b * H + h) * S) * 3;
  const int nq = (S + OP_QC - 1) / OP_QC;
  // s^T, dP^T: keys 4 rg + i, queries qg + 16 j (a warp: two rg, 16 qg);
  // dK, dV: run cg (queries 32 cg .. + 31 of each chunk) by threads 128 cg
  // .., keys krow + 16 i, dims 4 dg + e and 32 + 4 dg + e
  const int rg = tid >> 4, qg = tid & 15;
  const int cg = tid >> 7, krow = (tid >> 3) & 15, dg = tid & 7;
  float adk[4][8] = {}, adv[4][8] = {};
  auto stage_q = [&](int u) {
    float* sb = ring + (u & 1) * STAGE;
    op_rows(sb, q + head, ts, u * OP_QC, OP_QC, S, v16);
    op_rows(sb + OP_QC * FA_LD, dout + ohead, ots, u * OP_QC, OP_QC, S, v16);
    for (int i = tid; i < 3 * OP_QC; i += OP_THREADS) {
      const int qi = u * OP_QC + i / 3;
      cp_async4(sb + 2 * OP_QC * FA_LD + i, qi < S ? st + 3 * qi + i % 3 : st, qi < S);
    }
    cp_async_commit();
  };
  op_rows(Kt, k + head, ts, r0, OP_COLS_KEYS, S, v16);
  op_rows(Vt, v + head, ts, r0, OP_COLS_KEYS, S, v16);
  stage_q(0);
  for (int u = 0; u < nq; ++u) {
    op_wait();
    if (u + 1 < nq) stage_q(u + 1);
    const float* Qc = ring + (u & 1) * STAGE;
    const float* Oc = Qc + OP_QC * FA_LD;
    const float* sc = Oc + OP_QC * FA_LD;
    const int q0 = u * OP_QC;
    {
      const int jn = min(4, (S - q0 + 15) / 16);
      float s[4][4], dp[4][4];
      op_dots(s, Kt + 4 * rg * FA_LD, FA_LD, Qc + qg * FA_LD, 16 * FA_LD, jn);
      op_dots(dp, Vt + 4 * rg * FA_LD, FA_LD, Oc + qg * FA_LD, 16 * FA_LD, jn);
      // the scores and p of phase 1, bit for bit
      bool slow = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cq = qg + 16 * j;
        const bool ok = q0 + cq < S;
        const float m = sc[3 * cq];
        slow |= ok && sc[3 * cq + 1] > LA_QUOT_MAX_L;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = ok ? expf(__fsub_rn(__fmul_rn(s[i][j], scale), m)) : 0.0f;
          slow |= s[i][j] != 0.0f && s[i][j] < LA_QUOT_MIN;
        }
      }
      slow = __any_sync(0xffffffffu, slow);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cq = qg + 16 * j;
        const bool ok = q0 + cq < S;
        const float lq = ok ? sc[3 * cq + 1] : 1.0f, dt = ok ? sc[3 * cq + 2] : 0.0f;
        const LaQuot quot(lq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = slow ? __fdiv_rn(s[i][j], lq) : quot(s[i][j]);
          Pt[(4 * rg + i) * FA_LD + cq] = p;
          Dt[(4 * rg + i) * FA_LD + cq] = p * (dp[i][j] - dt);
        }
      }
    }
    __syncthreads();  // the chunk's p^T and dS^T are in
    const int n = op_run(S, q0, OP_QC, 32, cg);
    if (n > 0) {
      op_prod<4, 2>(adv, Pt + krow * FA_LD + 32 * cg, 16 * FA_LD, Oc + 32 * cg * FA_LD + 4 * dg,
                    n);  // dV += p^T dO
      op_prod<4, 2>(adk, Dt + krow * FA_LD + 32 * cg, 16 * FA_LD, Qc + 32 * cg * FA_LD + 4 * dg,
                    n);  // dK += dS^T q
    }
  }
  __syncthreads();  // every warp is done with the tiles and the ring
  constexpr int PART = 2 * OP_COLS_KEYS * FA_DH;  // the two runs' partial tiles
  op_put(ring + cg * OP_COLS_KEYS * FA_DH, adv, krow, 16, dg);
  op_put(ring + PART + cg * OP_COLS_KEYS * FA_DH, adk, krow, 16, dg);
  __syncthreads();
  const long long ghead = (long long)b * S * gts + r0 * gts + h * FA_DH;
  op_combine(dv + ghead, gts, ring, 2, OP_COLS_KEYS, r0, S, 1.0f);
  op_combine(dk + ghead, gts, ring + PART, 2, OP_COLS_KEYS, r0, S, scale);
}

// every row of q, k, v (and dO) starts on 16 bytes: the 16-byte copies
static int op_v16(const void* q, const void* k, const void* v, const void* d, long long bs,
                  long long ts) {
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return al(q) && al(k) && al(v) && al(d) && bs % 4 == 0 && ts % 4 == 0;
}

static int onepass_fwd_f32(const float* q, const float* k, const float* v, float* o, int B,
                           int S, int H, long long bs, long long ts, float scale,
                           cudaStream_t st) {
  const size_t smem = onepass_smem(S);
  LAUNCH(set_smem(onepass_fwd_f32_kernel, smem));
  const dim3 grid((S + OP_FWD_ROWS - 1) / OP_FWD_ROWS, H, B);
  onepass_fwd_f32_kernel<<<grid, OP_THREADS, smem, st>>>(q, k, v, o, S, H, bs, ts, scale,
                                                          op_v16(q, k, v, q, bs, ts));
  return (int)cudaGetLastError();
}

// two launches, the statistics through ws (B * H * S * 3 floats)
static int onepass_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                           float* dq, float* dk, float* dv, float* ws, int B, int S, int H,
                           long long bs, long long ts, long long gts, float scale,
                           cudaStream_t st) {
  const int v16 = op_v16(q, k, v, dout, bs, ts);
  size_t smem = onepass_smem(S);
  LAUNCH(set_smem(onepass_bwd_rows_f32_kernel, smem));
  onepass_bwd_rows_f32_kernel<<<dim3((S + OP_BWD_ROWS - 1) / OP_BWD_ROWS, H, B), OP_THREADS,
                                smem, st>>>(q, k, v, dout, dq, ws, S, H, bs, ts, gts, scale,
                                            v16);
  LAUNCH((int)cudaGetLastError());
  smem = onepass_cols_smem();
  LAUNCH(set_smem(onepass_bwd_cols_f32_kernel, smem));
  onepass_bwd_cols_f32_kernel<<<dim3((S + OP_COLS_KEYS - 1) / OP_COLS_KEYS, H, B), OP_THREADS,
                                smem, st>>>(q, k, v, dout, ws, dk, dv, S, H, bs, ts, gts, scale,
                                            v16);
  return (int)cudaGetLastError();
}

template <int DH = FA_DH>
static int long_fwd_f32(const float* q, const float* k, const float* v, float* o, int B, int S,
                        int H, long long bs, long long ts, float scale, cudaStream_t st) {
  const size_t smem = long_f32_smem<DH>(1, 0);
  LAUNCH(set_smem(long_fwd_f32_kernel<DH>, smem));
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  long_fwd_f32_kernel<DH><<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, o, S, H, bs, ts, scale);
  return (int)cudaGetLastError();
}

// two launches, the statistics through ws (B * H * S * 3 floats)
template <int DH = FA_DH>
static int long_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                        float* dq, float* dk, float* dv, float* ws, int B, int S, int H,
                        long long bs, long long ts, long long gts, float scale,
                        cudaStream_t st) {
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  size_t smem = long_f32_smem<DH>(2, 0);
  LAUNCH(set_smem(long_bwd_rows_f32_kernel<DH>, smem));
  long_bwd_rows_f32_kernel<DH><<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, dq, ws, S, H,
                                                                  bs, ts, gts, scale);
  LAUNCH((int)cudaGetLastError());
  smem = long_f32_smem<DH>(2, 3);
  LAUNCH(set_smem(long_bwd_cols_f32_kernel<DH>, smem));
  long_bwd_cols_f32_kernel<DH><<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, ws, dk, dv, S,
                                                                  H, bs, ts, gts, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launches on the caller's stream
// ---------------------------------------------------------------------------

// head_dim DH up to FA_MAX_S keys; above it (head_dim 16, 32, 48) the
// multi-pass route (head_dim 80 takes it at every S: fwd_f32)
template <int DH>
static int fwd_f32_dh(const float* q, const float* k, const float* v, float* o, int B, int S,
                      int H, long long bs, long long ts, float scale, cudaStream_t st) {
  if (S > FA_MAX_S) return long_fwd_f32<DH>(q, k, v, o, B, S, H, bs, ts, scale, st);
  const size_t smem = fwd_smem<DH>(S);
  LAUNCH(set_smem(flash_fwd_kernel<DH>, smem));
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  flash_fwd_kernel<DH><<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, o, S, H, bs, ts, scale);
  return (int)cudaGetLastError();
}

template <int DH>
static int bwd_f32_dh(const float* q, const float* k, const float* v, const float* dout,
                      float* dq, float* dk, float* dv, float* ws, int B, int S, int H,
                      long long bs, long long ts, long long gts, float scale, cudaStream_t st) {
  if (S > FA_MAX_S)
    return long_bwd_f32<DH>(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  size_t smem = bwd_rows_smem<DH>(S);
  LAUNCH(set_smem(flash_bwd_rows_kernel<DH>, smem));
  flash_bwd_rows_kernel<DH><<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, dq, ws, S, H, bs,
                                                               ts, gts, scale);
  LAUNCH((int)cudaGetLastError());
  smem = bwd_cols_smem<DH>(S);
  LAUNCH(set_smem(flash_bwd_cols_kernel<DH>, smem));
  flash_bwd_cols_kernel<DH><<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, ws, dk, dv, S, H,
                                                               bs, ts, gts, scale);
  return (int)cudaGetLastError();
}

// Head_dim dh at any S: 64 above FA_MAX_S keys the one-pass route up to
// OP_MAX_S, the multi-pass route beyond it or where `multipass`, a test
// entry's choice, asks for it; 16, 32 and 48 the multi-pass route above
// FA_MAX_S (the one-pass route is written for head_dim 64); 80 the
// multi-pass route at every S (common.cuh streamed_head_dim: the kernels
// that hold a row of scores in registers cover 64 dims a warp)
static int fwd_f32(const float* q, const float* k, const float* v, float* o, int B, int S,
                   int H, int dh, long long bs, long long ts, float scale, cudaStream_t st,
                   bool multipass = false) {
  if (dh != FA_DH) {
    switch (dh) {
      case 16: return fwd_f32_dh<16>(q, k, v, o, B, S, H, bs, ts, scale, st);
      case 32: return fwd_f32_dh<32>(q, k, v, o, B, S, H, bs, ts, scale, st);
      case 48: return fwd_f32_dh<48>(q, k, v, o, B, S, H, bs, ts, scale, st);
      case 80: return long_fwd_f32<80>(q, k, v, o, B, S, H, bs, ts, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (S > FA_MAX_S)
    return S <= OP_MAX_S && !multipass ? onepass_fwd_f32(q, k, v, o, B, S, H, bs, ts, scale, st)
                                       : long_fwd_f32(q, k, v, o, B, S, H, bs, ts, scale, st);
  return fwd_f32_dh<FA_DH>(q, k, v, o, B, S, H, bs, ts, scale, st);
}

// Not in a source that defines ATTENTION_CORE_FWD_ONLY (the forward layers',
// csrc/layer_fwd_seq.cuh), so that it instantiates none of the backward
// kernels on the head_dim (as csrc/attention_bwd.cuh's launchers)
#ifndef ATTENTION_CORE_FWD_ONLY
static int bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                   float* dq, float* dk, float* dv, float* ws, int B, int S, int H, int dh,
                   long long bs, long long ts, long long gts, float scale, cudaStream_t st,
                   bool multipass = false) {
  if (dh != FA_DH) {
    switch (dh) {
      case 16: return bwd_f32_dh<16>(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
      case 32: return bwd_f32_dh<32>(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
      case 48: return bwd_f32_dh<48>(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
      case 80: return long_bwd_f32<80>(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (S > FA_MAX_S)
    return S <= OP_MAX_S && !multipass
               ? onepass_bwd_f32(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st)
               : long_bwd_f32(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
  return bwd_f32_dh<FA_DH>(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
}
#endif  // ATTENTION_CORE_FWD_ONLY
