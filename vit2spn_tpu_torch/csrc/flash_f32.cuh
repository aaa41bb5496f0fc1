// Attention forward and backward on the CUDA cores in fp32, every product an
// fp32 FMA: the fp32 route of csrc/flash_attention.cu (the "pallas" path under
// compute_dtype=float32), of the fp32 forward layer (csrc/layer_fwd_f32.cuh)
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
// the thirds of a dqkv). Limits: head_dim 64, input rows on 8 bytes, output
// rows on 16. Up to FA_MAX_S (256) keys a warp holds its rows' whole row of
// scores in registers (the kernels below); above it the multi-pass route at
// the end of this file takes any S.

#pragma once

#include "common.cuh"

#define FA_DH 64
#define FA_MAX_S 256

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
template <int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, long long ts, int r0, int n,
                                      int S) {
  for (int i = threadIdx.x; i < n * (FA_DH / 2); i += blockDim.x) {
    const int r = i / (FA_DH / 2);
    const int c = 2 * (i % (FA_DH / 2));
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
// 8 rows (stride FA_DH, read as broadcasts), B the staged rows. Groups with
// 32 j >= S stay 0.
__device__ __forceinline__ void dot_rows(float acc[FA_RW][FA_NJ], const float* A, const float* B,
                                         int S, int lane) {
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j)
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < FA_DH; d += 4) {
    float4 a[FA_RW];
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) a[i] = *reinterpret_cast<const float4*>(A + i * FA_DH + d);
#pragma unroll
    for (int j = 0; j < FA_NJ; ++j) {
      if (32 * j < S) {
        const float4 b = *reinterpret_cast<const float4*>(B + (32 * j + lane) * FA_LD + d);
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
// rows.
__device__ __forceinline__ void product(float acc[4][4], const float w[FA_RW][FA_NJ],
                                        float* slab, const float* R, int S, int lane) {
  const int rg = lane >> 4, dg = lane & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j) {
    if (32 * j < S) {
      __syncwarp();  // the slab's last readers are done
      *reinterpret_cast<float4*>(slab + lane * FA_RW) =
          make_float4(w[0][j], w[1][j], w[2][j], w[3][j]);
      *reinterpret_cast<float4*>(slab + lane * FA_RW + 4) =
          make_float4(w[4][j], w[5][j], w[6][j], w[7][j]);
      __syncwarp();
      const float* rr = R + (32 * j) * FA_LD + 4 * dg;
#pragma unroll 4
      for (int c = 0; c < 32; ++c) {
        const float4 p = *reinterpret_cast<const float4*>(slab + c * FA_RW + 4 * rg);
        const float4 v = *reinterpret_cast<const float4*>(rr + c * FA_LD);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(pr[r], v.x, acc[r][0]);
          acc[r][1] = fmaf(pr[r], v.y, acc[r][1]);
          acc[r][2] = fmaf(pr[r], v.z, acc[r][2]);
          acc[r][3] = fmaf(pr[r], v.w, acc[r][3]);
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
// 4 (lane % 16) .. + 3) times `mul` into out (row stride ts)
__device__ __forceinline__ void store_tile(float* out, long long ts, const float acc[4][4],
                                           float mul, int w0, int S, int lane) {
  const int r0 = w0 + 4 * (lane >> 4), c = 4 * (lane & 15);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r0 + r < S)
      *reinterpret_cast<float4*>(out + (r0 + r) * ts + c) =
          make_float4(acc[r][0] * mul, acc[r][1] * mul, acc[r][2] * mul, acc[r][3] * mul);
}

__host__ __device__ __forceinline__ int padded(int S) { return (S + 31) / 32 * 32; }

// Forward: one block per 64 queries of one (image, head). K and then V take
// turns in one staged buffer (V lands once every warp's scores are done), so
// that two blocks share an SM: one stages while the other computes.

static size_t fwd_smem(int S) {
  return (size_t)padded(S) * FA_LD * 4 + (size_t)FA_ROWS * FA_DH * 4 +
         (size_t)FA_WARPS * FA_RW * 32 * 4;
}

__global__ void __launch_bounds__(FA_WARPS * 32, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int H, long long bs,
                 long long ts, float scale) {
  const int SP = padded(S);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* KVs = reinterpret_cast<float*>(fa_smem);  // K, then V
  float* Qs = KVs + SP * FA_LD;                      // this block's queries
  float* slabs = Qs + FA_ROWS * FA_DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  stage<FA_LD>(KVs, k + head, ts, 0, SP, S);
  stage<FA_DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  stage_wait();
  float s[FA_RW][FA_NJ], mx[FA_RW], sum[FA_RW];
  if (live) {
    dot_rows(s, Qs + warp * FA_RW * FA_DH, KVs, S, lane);
    softmax_rows(s, mx, sum, scale, S, lane);
  }
  __syncthreads();  // every warp is done with K
  stage<FA_LD>(KVs, v + head, ts, 0, SP, S);
  stage_wait();
  if (!live) return;
  float acc[4][4];
  product(acc, s, slabs + warp * FA_RW * 32, KVs, S, lane);
  const long long ots = (long long)H * FA_DH;
  store_tile(o + (long long)b * S * ots + h * FA_DH, ots, acc, 1.0f, w0, S, lane);
}

// Backward, phase 1: one block per 64 queries: statistics and dQ

static size_t bwd_rows_smem(int S) {
  return (size_t)2 * padded(S) * FA_LD * 4 + (size_t)2 * FA_ROWS * FA_DH * 4 +
         (size_t)FA_WARPS * FA_RW * 32 * 4;
}

__global__ void __launch_bounds__(FA_WARPS * 32, 1)
flash_bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      float* __restrict__ dq, float* __restrict__ stats, int S, int H,
                      long long bs, long long ts, long long gts, float scale) {
  const int SP = padded(S);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Ks = reinterpret_cast<float*>(fa_smem);
  float* Vs = Ks + SP * FA_LD;
  float* Qs = Vs + SP * FA_LD;
  float* Os = Qs + FA_ROWS * FA_DH;  // dO of this block's queries
  float* slabs = Os + FA_ROWS * FA_DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  // K and the queries first: the scores and softmax run while V and dO land
  stage<FA_LD>(Ks, k + head, ts, 0, SP, S);
  stage<FA_DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  stage<FA_LD>(Vs, v + head, ts, 0, SP, S);
  stage<FA_DH>(Os, dout + ohead, ots, r0, FA_ROWS, S);
  cp_async_commit();
  const int w0 = r0 + warp * FA_RW;
  const bool active = w0 < S;  // a warp past S only helps stage
  float p[FA_RW][FA_NJ], dp[FA_RW][FA_NJ], mx[FA_RW], sum[FA_RW];
  stage_wait_first();
  if (active) {
    dot_rows(p, Qs + warp * FA_RW * FA_DH, Ks, S, lane);
    softmax_rows(p, mx, sum, scale, S, lane);
  }
  stage_wait();
  if (!active) return;
  dot_rows(dp, Os + warp * FA_RW * FA_DH, Vs, S, lane);
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
  product(acc, dp, slabs + warp * FA_RW * 32, Ks, S, lane);
  store_tile(dq + (long long)b * S * gts + h * FA_DH, gts, acc, scale, w0, S, lane);
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

static size_t bwd_cols_smem(int S) {
  return (size_t)2 * padded(S) * FA_LD * 4 + (size_t)2 * FA_ROWS * FA_DH * 4 +
         (size_t)3 * padded(S) * 4 + (size_t)FA_WARPS * FA_RW * 32 * 4;
}

__global__ void __launch_bounds__(FA_WARPS * 32, 1)
flash_bwd_cols_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ stats, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int H, long long bs, long long ts,
                      long long gts, float scale) {
  const int SP = padded(S);
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Qs = reinterpret_cast<float*>(fa_smem);
  float* Os = Qs + SP * FA_LD;  // dO, every query
  float* Kt = Os + SP * FA_LD;  // this block's keys
  float* Vt = Kt + FA_ROWS * FA_DH;
  float* rmax = Vt + FA_ROWS * FA_DH;
  float* rsum = rmax + SP;
  float* rdot = rsum + SP;
  float* slabs = rdot + SP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  // the queries and this block's keys first: P^T runs while dO and V land
  stage<FA_LD>(Qs, q + head, ts, 0, SP, S);
  stage<FA_DH>(Kt, k + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  stage<FA_LD>(Os, dout + ohead, ots, 0, SP, S);
  stage<FA_DH>(Vt, v + head, ts, r0, FA_ROWS, S);
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
    dot_rows(p, Kt + warp * FA_RW * FA_DH, Qs, S, lane);
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
  dot_rows(ds, Vt + warp * FA_RW * FA_DH, Os, S, lane);
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j) {
    const float dt = rdot[32 * j + lane < S ? 32 * j + lane : 0];
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) ds[i][j] = p[i][j] * (ds[i][j] - dt);
  }
  float* slab = slabs + warp * FA_RW * 32;
  float acc[4][4];
  product(acc, p, slab, Os, S, lane);  // dV = P^T dO
  const long long ghead = (long long)b * S * gts + h * FA_DH;
  store_tile(dv + ghead, gts, acc, 1.0f, w0, S, lane);
  product(acc, ds, slab, Qs, S, lane);  // dK = dS^T q / sqrt(dh)
  store_tile(dk + ghead, gts, acc, scale, w0, S, lane);
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
// are left as they were; this route calls their helpers unchanged.
//
// What bounds it on this card: every product and every recomputed score is
// an fp32 FMA on the CUDA cores (67 TFLOP/s). At S = 577 the function's
// products are 2 S^2 64 a (image, head) each, 2 in the forward and 5 in the
// backward; the passes run 4 (the forward) and 7 + 4 (the backward's two
// launches) of that size, beside an expf per score and pass, and an IEEE
// division per score in the passes that form p. Shared memory (two 256-row chunk buffers of
// 68 floats a row: 139 KB) leaves one block of 8 warps an SM: the forward's
// pass 3 stages the next K chunk while the product with V runs, the
// statistics passes double-buffer K, the backward stages K (or Q) and V (or
// dO) in two groups and starts on the first while the second lands.

#define LF_CHUNK FA_MAX_S  // keys (queries, in the key-major phase) per staged chunk
#define LF_BUF (LF_CHUNK * FA_LD)  // floats of one chunk buffer

__device__ __forceinline__ int lf_chunks(int S) { return (S + LF_CHUNK - 1) / LF_CHUNK; }

// rows of chunk c that are below S
__device__ __forceinline__ int lf_rows(int c, int S) {
  return min(LF_CHUNK, S - c * LF_CHUNK);
}

// Rows c * LF_CHUNK .. of a (image, head) into a chunk buffer (rows >= S
// zeros), committed as one cp.async group
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, long long ts, int c,
                                            int S) {
  stage<FA_LD>(dst, src, ts, c * LF_CHUNK, padded(lf_rows(c, S)), S);
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

// Passes 1 and 2: the max m and the sum l of the warp's 8 rows (Qw, stride
// FA_DH, already staged or in a committed group) over every key, the K
// chunks double-buffered in buf0 and buf1. Every thread of the block calls
// it (staging, barriers); `live` warps compute.
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
    stage_chunk(buf0, kh, ts, 0, S);
    for (int c = 0; c < nc; ++c) {
      if (c + 1 < nc) {
        stage_chunk(c & 1 ? buf0 : buf1, kh, ts, c + 1, S);
        stage_wait_first();
      } else {
        stage_wait();
      }
      if (live) {
        const int n = lf_rows(c, S);
        float s[FA_RW][FA_NJ];
        dot_rows(s, Qw, c & 1 ? buf1 : buf0, n, lane);
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
static size_t long_f32_smem(int tiles, int stats) {
  return (size_t)2 * LF_BUF * 4 + (size_t)tiles * FA_ROWS * FA_DH * 4 +
         (size_t)stats * LF_CHUNK * 4 + (size_t)FA_WARPS * FA_RW * 32 * 4;
}

// Forward: one block per 64 queries of one (image, head)
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
long_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int S, int H,
                    long long bs, long long ts, float scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Ks = reinterpret_cast<float*>(fa_smem);  // K chunks (both buffers in passes 1, 2)
  float* Vs = Ks + LF_BUF;                        // V chunks
  float* Qs = Vs + LF_BUF;
  float* slabs = Qs + FA_ROWS * FA_DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  const float* Qw = Qs + warp * FA_RW * FA_DH;
  stage<FA_DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  float mx[FA_RW], l[FA_RW];
  row_stats(mx, l, Qw, Ks, Vs, k + head, ts, S, scale, live, lane);
  // pass 3: the next K chunk lands while the product with this V runs
  const int nc = lf_chunks(S);
  float acc[4][4] = {}, part[4][4];
  stage_chunk(Ks, k + head, ts, 0, S);
  stage_chunk(Vs, v + head, ts, 0, S);
  for (int c = 0; c < nc; ++c) {
    const int n = lf_rows(c, S);
    stage_wait_first();  // K of chunk c (V of it may still be in flight)
    float p[FA_RW][FA_NJ];
    if (live) {
      dot_rows(p, Qw, Ks, n, lane);
      scale_scores(p, scale, n, lane);
      probs(p, mx, l);
    }
    __syncthreads();  // every warp is done with K
    if (c + 1 < nc) {  // V of chunk c lands
      stage_chunk(Ks, k + head, ts, c + 1, S);
      stage_wait_first();
    } else {
      stage_wait();
    }
    if (live) {
      product(part, p, slabs + warp * FA_RW * 32, Vs, n, lane);
      add_tile(acc, part);
    }
    __syncthreads();  // every warp is done with V
    if (c + 1 < nc) stage_chunk(Vs, v + head, ts, c + 1, S);
  }
  if (!live) return;
  const long long ots = (long long)H * FA_DH;
  store_tile(o + (long long)b * S * ots + h * FA_DH, ots, acc, 1.0f, w0, S, lane);
}

// Backward, phase 1: one block per 64 queries: the statistics and dQ
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
long_bwd_rows_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ stats, int S, int H,
                         long long bs, long long ts, long long gts, float scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Ks = reinterpret_cast<float*>(fa_smem);  // K chunks (both buffers in passes 1, 2)
  float* Vs = Ks + LF_BUF;                        // V chunks
  float* Qs = Vs + LF_BUF;
  float* Os = Qs + FA_ROWS * FA_DH;  // dO of this block's queries
  float* slabs = Os + FA_ROWS * FA_DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  const float* Qw = Qs + warp * FA_RW * FA_DH;
  const float* Ow = Os + warp * FA_RW * FA_DH;
  stage<FA_DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  stage<FA_DH>(Os, dout + ohead, ots, r0, FA_ROWS, S);
  cp_async_commit();
  float mx[FA_RW], l[FA_RW], dot[FA_RW] = {};
  row_stats(mx, l, Qw, Ks, Vs, k + head, ts, S, scale, live, lane);
  // pass 3: dot = rowsum(dP p); pass 4: dS and dQ. The scores start on K
  // while V lands
  const int nc = lf_chunks(S);
  float acc[4][4] = {}, part[4][4];
  for (int pass = 3; pass <= 4; ++pass) {
    for (int c = 0; c < nc; ++c) {
      const int n = lf_rows(c, S);
      stage_chunk(Ks, k + head, ts, c, S);
      stage_chunk(Vs, v + head, ts, c, S);
      stage_wait_first();
      float p[FA_RW][FA_NJ], dp[FA_RW][FA_NJ];
      if (live) {
        dot_rows(p, Qw, Ks, n, lane);
        scale_scores(p, scale, n, lane);
        probs(p, mx, l);
      }
      stage_wait();
      if (live) {
        dot_rows(dp, Ow, Vs, n, lane);
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
          product(part, dp, slabs + warp * FA_RW * 32, Ks, n, lane);
          add_tile(acc, part);
        }
      }
      __syncthreads();  // every warp is done with both buffers
    }
  }
  if (!live) return;
  store_tile(dq + (long long)b * S * gts + h * FA_DH, gts, acc, scale, w0, S, lane);
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
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
long_bwd_cols_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ stats, float* __restrict__ dk,
                         float* __restrict__ dv, int S, int H, long long bs, long long ts,
                         long long gts, float scale) {
  extern __shared__ __align__(128) unsigned char fa_smem[];
  float* Qc = reinterpret_cast<float*>(fa_smem);  // a chunk of queries
  float* Oc = Qc + LF_BUF;                        // their dO
  float* Kt = Oc + LF_BUF;                        // this block's keys
  float* Vt = Kt + FA_ROWS * FA_DH;
  float* rmax = Vt + FA_ROWS * FA_DH;
  float* rsum = rmax + LF_CHUNK;
  float* rdot = rsum + LF_CHUNK;
  float* slab = rdot + LF_CHUNK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  const int w0 = r0 + warp * FA_RW;
  const bool live = w0 < S;  // a warp past S only helps stage
  const float* Kw = Kt + warp * FA_RW * FA_DH;
  const float* Vw = Vt + warp * FA_RW * FA_DH;
  slab += warp * FA_RW * 32;
  stage<FA_DH>(Kt, k + head, ts, r0, FA_ROWS, S);
  stage<FA_DH>(Vt, v + head, ts, r0, FA_ROWS, S);
  cp_async_commit();
  const float* st = stats + ((long long)(b * H + h) * S) * 3;
  const int nc = lf_chunks(S);
  float adk[4][4] = {}, adv[4][4] = {}, part[4][4];
  for (int c = 0; c < nc; ++c) {
    const int n = lf_rows(c, S), q0 = c * LF_CHUNK;
    // the queries first: P^T runs while dO lands
    stage_chunk(Qc, q + head, ts, c, S);
    stage_chunk(Oc, dout + ohead, ots, c, S);
    for (int i = threadIdx.x; i < LF_CHUNK; i += blockDim.x) {  // pad queries: inert
      rmax[i] = i < n ? st[(q0 + i) * 3 + 0] : 0.0f;
      rsum[i] = i < n ? st[(q0 + i) * 3 + 1] : 1.0f;
      rdot[i] = i < n ? st[(q0 + i) * 3 + 2] : 0.0f;
    }
    stage_wait_first();
    // P^T and dP^T: rows are this warp's keys, columns the queries 32 j + lane
    float p[FA_RW][FA_NJ], ds[FA_RW][FA_NJ];
    if (live) {
      dot_rows(p, Kw, Qc, n, lane);
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
      dot_rows(ds, Vw, Oc, n, lane);
#pragma unroll
      for (int j = 0; j < FA_NJ; ++j) {
        const float dt = rdot[32 * j + lane < n ? 32 * j + lane : 0];
#pragma unroll
        for (int i = 0; i < FA_RW; ++i) ds[i][j] = p[i][j] * (ds[i][j] - dt);
      }
      product(part, p, slab, Oc, n, lane);  // dV += P^T dO
      add_tile(adv, part);
      product(part, ds, slab, Qc, n, lane);  // dK += dS^T q
      add_tile(adk, part);
    }
    __syncthreads();  // every warp is done with the chunk and its statistics
  }
  if (!live) return;
  const long long ghead = (long long)b * S * gts + h * FA_DH;
  store_tile(dv + ghead, gts, adv, 1.0f, w0, S, lane);
  store_tile(dk + ghead, gts, adk, scale, w0, S, lane);
}

static int long_fwd_f32(const float* q, const float* k, const float* v, float* o, int B, int S,
                        int H, long long bs, long long ts, float scale, cudaStream_t st) {
  const size_t smem = long_f32_smem(1, 0);
  LAUNCH(set_smem(long_fwd_f32_kernel, smem));
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  long_fwd_f32_kernel<<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, o, S, H, bs, ts, scale);
  return (int)cudaGetLastError();
}

// two launches, the statistics through ws (B * H * S * 3 floats)
static int long_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                        float* dq, float* dk, float* dv, float* ws, int B, int S, int H,
                        long long bs, long long ts, long long gts, float scale,
                        cudaStream_t st) {
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  size_t smem = long_f32_smem(2, 0);
  LAUNCH(set_smem(long_bwd_rows_f32_kernel, smem));
  long_bwd_rows_f32_kernel<<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, dq, ws, S, H, bs,
                                                              ts, gts, scale);
  LAUNCH((int)cudaGetLastError());
  smem = long_f32_smem(2, 3);
  LAUNCH(set_smem(long_bwd_cols_f32_kernel, smem));
  long_bwd_cols_f32_kernel<<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, ws, dk, dv, S, H,
                                                              bs, ts, gts, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launches on the caller's stream
// ---------------------------------------------------------------------------

static int fwd_f32(const float* q, const float* k, const float* v, float* o, int B, int S,
                   int H, long long bs, long long ts, float scale, cudaStream_t st) {
  if (S > FA_MAX_S) return long_fwd_f32(q, k, v, o, B, S, H, bs, ts, scale, st);
  const size_t smem = fwd_smem(S);
  LAUNCH(set_smem(flash_fwd_kernel, smem));
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  flash_fwd_kernel<<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, o, S, H, bs, ts, scale);
  return (int)cudaGetLastError();
}

static int bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                   float* dq, float* dk, float* dv, float* ws, int B, int S, int H,
                   long long bs, long long ts, long long gts, float scale, cudaStream_t st) {
  if (S > FA_MAX_S)
    return long_bwd_f32(q, k, v, dout, dq, dk, dv, ws, B, S, H, bs, ts, gts, scale, st);
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  size_t smem = bwd_rows_smem(S);
  LAUNCH(set_smem(flash_bwd_rows_kernel, smem));
  flash_bwd_rows_kernel<<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, dq, ws, S, H, bs, ts,
                                                           gts, scale);
  LAUNCH((int)cudaGetLastError());
  smem = bwd_cols_smem(S);
  LAUNCH(set_smem(flash_bwd_cols_kernel, smem));
  flash_bwd_cols_kernel<<<grid, FA_WARPS * 32, smem, st>>>(q, k, v, dout, ws, dk, dv, S, H, bs,
                                                           ts, gts, scale);
  return (int)cudaGetLastError();
}

