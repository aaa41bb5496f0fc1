// Attention above 256 tokens at head_dim 16, 32 and 48, and at every S at
// head_dim 80 (common.cuh streamed_head_dim: ViT-Huge/14, which has no
// register-row kernels), for Hopper (sm_90a), bf16 in and out: the S > 256
// route of the general geometry (common.cuh general_route), behind the same
// four bf16 attention functions as csrc/long_attention.cuh, whose wgmma /
// TMA routes are written for head_dim 64:
//
//   vit2spn_tpu/ops/fused_block.py::_attention (inside _backbone_fwd_kernel
//     and _fwd_kernel)               -> gl_fwd_kernel<DH, false>, the forward
//                                       layer's attention stage
//                                       (csrc/layer_fwd_seq.cuh)
//   ::_attention_bwd with the att it recomputes (inside _attn_bwd_kernel and
//     _merged_bwd_kernel)            -> gl_core_kernel<DH>, the backward's
//                                       attention core (attention_bwd.cuh)
//   vit2spn_tpu/ops/flash_attention.py::_fwd_kernel
//                                    -> gl_fwd_kernel<DH, true>
//   ::_bwd_kernel                    -> gl_flash_rows_kernel<DH>, then
//                                       gl_flash_cols_kernel<DH>
//                                       (csrc/flash_attention.cu)
//
// Each computes its Pallas function with the rounding points of the S <= 256
// kernels on the head_dim (attention_bwd_kernel, flash_fwd_tc,
// flash_bwd_rows_tc / _cols_tc), per (image, head), over S keys:
//
//   s = fp32(q k^T) * 1/sqrt(dh) (__fmul_rn), keys >= S at -1e30
//   m = the row max over ALL keys;  l = sum of exp(s - m);  p = exp(s - m) / l
//   fused block: att = bf16(bf16(p) v); dV = bf16(p)^T dO; dP = dO v^T;
//                dS = bf16(p (dP - rowsum(dP p))); dQ = dS k / sqrt(dh);
//                dK = dS^T q / sqrt(dh)
//   flash:       o = p v, dV = p^T dO, dQ, dK as above with p and dS in two
//                bf16 terms each (hi = bf16(x), lo = bf16(x - hi))
//
// with queries >= S out of dK and dV. As in long_attention.cuh, p is formed
// only once the row's max and sum over every key are known (no running
// max, no rescaled sum): several passes over the keys, the scores recomputed
// in each. The design is the S <= 256 mma.sync kernels' (one warp a 16-row
// tile, the m16n8k16 fragments, DH / 16 k-steps of head_dim) with the other
// side streamed through shared memory in GL_CHUNK-row chunks that every warp
// of a block shares, instead of held whole:
//
//   passes 1, 2  s of every key: the row max m, then l = sum exp(s - m)
//   forward      pass 3: s again, p, o += p v (per 16-key step)
//   rows         pass 3: s and dP = dO v^T: dot = rowsum(dP p) (and the
//                core's att += bf16(p) v); pass 4: s and dP again, dS,
//                dQ += dS k; m, l and dot of each query kept
//   cols         per 16 keys a warp, every query chunk: s^T and dP^T, p and
//                dS from each query's m, l, dot, dV += p^T dO, dK += dS^T q
//
// Orders of the sums, fixed, so that two runs give the same bits, and
// written after the S <= 256 kernels' (below: not every bit of the core's
// equals theirs): the scores over head_dim in
// k-steps of 16 (mma_rows_t); l and dot per lane over its keys 8 j + 2 t,
// 8 j + 2 t + 1 in ascending order across every chunk, then the quad's
// shuffles (xor 1, then xor 2); o, att and dQ over 16-key k-steps in
// ascending order, dK and dV over 16-query k-steps in ascending order. A
// key tile wholly past S is skipped: it would add exact zeros.
//
// The fused backward core is one launch, one block per (image, head), as the
// S <= 256 core: its rows phase walks the queries in GL_ROWS rounds and
// keeps each query's three statistics in shared memory, then its cols phase
// walks the keys; so the layer backward's launch count does not change with
// S. Its statistics bound S: 3 floats a query beside the staged rows, which
// leaves room for more than long_core_max_seq() (the head_dim-64 core's
// limit, 15,168) at head_dim 16-48, so the layer backwards state that one
// limit there; at head_dim 80 the staged rows (88 bf16 apart) leave room for
// 13,696 queries (gl_core_max_seq). The flash backward is two launches, as
// every flash backward route: the rows launch writes the statistics to the
// workspace (vit2spn_flash_bwd_workspace_floats), the cols launch reads them
// a chunk at a time beside its Q and dO chunks, so S is not bounded.
//
// Why mma.sync and not long_attention.cuh's wgmma / TMA on DH: a simple
// kernel that is right first. The S <= 256 kernels' fragment code already
// takes every head_dim; TMA has no swizzle mode for a head_dim-48 row (96
// bytes), and wgmma's N = DH for P v would need a second set of the long
// routes' tiles. What bounds it on this card: at ViT-Tiny's width at 384 px
// (S = 577, B = 64) the products are 2 S^2 dh a (image, head) each (2 in
// the forward, 6 in the core's backward), against the recomputed scores (2
// more passes in the forward, 3 in the core's rows phase and 1 in its cols
// phase) and an expf and a division per score and pass on the CUDA cores,
// which mma.sync from shared memory and 8 warps a block leave unhidden.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
// 19): at that shape with head_dim 32 the stage takes 0.39 ms, the core
// 1.40, the flash forward 0.43 and backward 1.20 ms, 3.4-4.3% of their
// bounds (2.3-8.4% over the head_dims and shapes timed there). Why the S <=
// 256 kernels keep S <= 256: at S = 197, B = 128, D 192 these take 1.17-1.49x
// their time for the stage and the flash pair and 1.66-2.59x for the core,
// with the same bits but for 5e-5 of the core's (tools/gl_short_probe.py,
// same card). Head_dim 80 (five k-steps of 16 for the scores, ten n8 tiles
// for P v) takes these kernels at every S: registering the S <= 256 kernels
// there would add six key-tile instantiations to each attention kernel, and
// the register-row core already spills 1.1-1.6 KB at 256 keys at head_dim
// 16-48. Its rows and cols kernels of the flash backward hold dQ (dK and
// dV) beside both operands' fragments: at two blocks an SM (128 registers)
// they would spill, so at head_dim 80 they take one (GL_FLASH_MINB).
// Limits: head dim 16, 32, 48 or 80; rows 16-byte aligned.

#pragma once

#include "common.cuh"
#include "long_attention.cuh"  // split_pair, la_quad_sum, la_quad_max, LA_MAX_SMEM

#define GL_WARPS 8               // warps a block, 16 rows each
#define GL_ROWS (16 * GL_WARPS)  // a block's rows at a time: queries, or keys (cols)
#define GL_CHUNK 64              // rows of the other side a staged chunk

// blocks an SM the flash backward's kernels are compiled for: two (at most
// 128 registers) up to head_dim 48, one at 80, whose accumulators and
// operand fragments need more
#define GL_FLASH_MINB(DH) ((DH) > 64 ? 1 : 2)

// ---------------------------------------------------------------------------
// Fragment helpers (shared with csrc/flash_attention.cu's S <= 256 kernels)
// ---------------------------------------------------------------------------

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

// acc (16 x DH) += (hi + lo) (16 x 16) times the 16 staged rows at `rows`:
// mma_rows with both terms on one load of the B fragments
template <int DH>
__device__ __forceinline__ void mma_rows_split(float acc[][4], const uint32_t hi[4],
                                               const uint32_t lo[4], const bf16* rows,
                                               int lane) {
  const bf16* p =
      rows + (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * tile_ld<DH>() + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, p + np * 16);
    mma_bf16(acc[2 * np], hi, b[0], b[1]);
    mma_bf16(acc[2 * np], lo, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
  }
}

template <int DH>
__device__ __forceinline__ void zero_acc(float acc[][4]) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
}

// ---------------------------------------------------------------------------
// The passes
// ---------------------------------------------------------------------------

// Rows r0 .. r0 + n - 1 of one (image, head) (global row stride ts, DH
// values each) into shared memory tile_ld<DH>() apart by every thread of
// the block, with cp.async (rows >= S zeros); then every copy has landed
// for every thread
template <int DH>
__device__ __forceinline__ void gl_stage(bf16* dst, const bf16* src, long long ts, int r0, int n,
                                         int S) {
  for (int i = threadIdx.x; i < n * (DH / 8); i += blockDim.x) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    const bool live = r0 + r < S;
    cp_async16(dst + r * tile_ld<DH>() + c, src + (live ? r0 + r : 0) * ts + c, live);
  }
}
__device__ __forceinline__ void gl_landed() {
  cp_async_wait_all();
  __syncthreads();
}

// the scaled scores of the warp's 16 queries (qa) against the 8 staged keys
// at `keys`, key0 the first of them: keys >= S at -1e30
template <int DH>
__device__ __forceinline__ void gl_scores(float s[4], const uint32_t qa[][4], const bf16* keys,
                                          int key0, int S, float scale, int lane) {
  const int t = lane & 3;
  mma_rows_t<DH>(s, qa, keys, lane);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s[e] = (key0 + 2 * t + (e & 1) < S) ? __fmul_rn(s[e], scale) : NEG_INF;
}

// p of two score tiles (rows g and g + 8: m[0], l[0] and m[1], l[1]), in place
__device__ __forceinline__ void gl_probs(float p[2][4], const float m[2], const float l[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[hh][e] = expf(__fsub_rn(p[hh][e], m[e >> 1])) / l[e >> 1];
}

// Passes 1 and 2: the row max m and the row sum l of the warp's 16 queries
// (qa) over every key, K streamed in GL_CHUNK-key chunks through Ks. Every
// thread of the block calls it (staging, barriers); `live` warps compute.
template <int DH>
__device__ __forceinline__ void gl_stats(float m[2], float l[2], const uint32_t qa[][4], bf16* Ks,
                                         const bf16* kh, long long ts, int S, float scale,
                                         bool live, int lane) {
  constexpr int LD = tile_ld<DH>();
  m[0] = m[1] = -3.0e38f;
  l[0] = l[1] = 0.0f;
  for (int pass = 0; pass < 2; ++pass) {
    for (int c0 = 0; c0 < S; c0 += GL_CHUNK) {
      __syncthreads();  // every warp is done with the buffer
      gl_stage<DH>(Ks, kh, ts, c0, GL_CHUNK, S);
      gl_landed();
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < GL_CHUNK / 8; ++j) {
        if (c0 + 8 * j >= S) break;
        float s[4];
        gl_scores<DH>(s, qa, Ks + (size_t)8 * j * LD, c0 + 8 * j, S, scale, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (pass == 0)
            m[e >> 1] = fmaxf(m[e >> 1], s[e]);
          else
            l[e >> 1] += expf(__fsub_rn(s[e], m[e >> 1]));
        }
      }
    }
    if (live) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (pass == 0)
          m[r] = la_quad_max(m[r]);
        else
          l[r] = la_quad_sum(l[r]);
    }
  }
}

// Passes 3 and 4 of a rows phase (the fused core, or with SPLIT the flash
// backward's rows launch), the warp's 16 queries (qa, and their dO oa):
// pass 3 dot = rowsum(dP p) (and without SPLIT att += bf16(p) v); pass 4
// dS = p (dP - dot), dQ += dS k (dS one bf16 term, or with SPLIT two).
// K and V stream through Ks and Vs.
template <int DH, bool SPLIT>
__device__ __forceinline__ void gl_rows_bwd(float att[][4], float dq[][4], float dot[2],
                                            const uint32_t qa[][4], const uint32_t oa[][4],
                                            const float m[2], const float l[2], bf16* Ks,
                                            bf16* Vs, const bf16* kh, const bf16* vh,
                                            long long ts, int S, float scale, bool live,
                                            int lane) {
  constexpr int LD = tile_ld<DH>();
  dot[0] = dot[1] = 0.0f;
  if constexpr (!SPLIT) zero_acc<DH>(att);
  zero_acc<DH>(dq);
  for (int pass = 3; pass <= 4; ++pass) {
    for (int c0 = 0; c0 < S; c0 += GL_CHUNK) {
      __syncthreads();
      gl_stage<DH>(Ks, kh, ts, c0, GL_CHUNK, S);
      gl_stage<DH>(Vs, vh, ts, c0, GL_CHUNK, S);
      gl_landed();
      if (!live) continue;
#pragma unroll
      for (int i = 0; i < GL_CHUNK / 16; ++i) {
        if (c0 + 16 * i >= S) break;
        float p[2][4], dp[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int j = 2 * i + hh;
          gl_scores<DH>(p[hh], qa, Ks + (size_t)8 * j * LD, c0 + 8 * j, S, scale, lane);
          mma_rows_t<DH>(dp[hh], oa, Vs + (size_t)8 * j * LD, lane);
        }
        gl_probs(p, m, l);
        if (pass == 3) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) dot[e >> 1] += dp[hh][e] * p[hh][e];
          if constexpr (!SPLIT) {
            uint32_t pa[4];
            pack_a(pa, p[0], p[1]);
            mma_rows<DH>(att, pa, Vs + (size_t)16 * i * LD, lane);
          }
        } else {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[hh][e] = p[hh][e] * (dp[hh][e] - dot[e >> 1]);
          if constexpr (SPLIT) {
            uint32_t hi[4], lo[4];
            split_a(hi, lo, dp[0], dp[1]);
            mma_rows_split<DH>(dq, hi, lo, Ks + (size_t)16 * i * LD, lane);
          } else {
            uint32_t da[4];
            pack_a(da, dp[0], dp[1]);
            mma_rows<DH>(dq, da, Ks + (size_t)16 * i * LD, lane);
          }
        }
      }
    }
    if (pass == 3 && live) {
      dot[0] = la_quad_sum(dot[0]);
      dot[1] = la_quad_sum(dot[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per GL_ROWS queries of one (image, head)
// ---------------------------------------------------------------------------

template <int DH>
static size_t gl_fwd_smem() {
  return (size_t)(GL_ROWS + 2 * GL_CHUNK) * tile_ld<DH>() * sizeof(bf16);
}

// o = bf16(p) v (the fused block's stage), or with SPLIT (p_hi + p_lo) v
// (the flash forward). q, k, v: element (b, s, h, d) at b bs + s ts + h DH +
// d; o at b obs + s ots + h DH + d.
template <int DH, bool SPLIT>
__global__ void __launch_bounds__(GL_WARPS * 32, 2)
gl_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int S, long long bs,
              long long ts, long long obs, long long ots, float scale) {
  constexpr int LD = tile_ld<DH>();
  extern __shared__ __align__(128) bf16 gl_smem[];
  bf16* Qs = gl_smem;
  bf16* Ks = Qs + GL_ROWS * LD;
  bf16* Vs = Ks + GL_CHUNK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * GL_ROWS + 16 * warp;
  const bool live = q0 < S;  // a warp past S only helps stage
  const long long head = (long long)b * bs + h * DH;
  gl_stage<DH>(Qs, q + head, ts, blockIdx.x * GL_ROWS, GL_ROWS, S);
  gl_landed();
  uint32_t qa[DH / 16][4];
  load_a_rows<DH>(qa, Qs + (size_t)16 * warp * LD, lane);
  float m[2], l[2];
  gl_stats<DH>(m, l, qa, Ks, k + head, ts, S, scale, live, lane);
  float acc[DH / 8][4];
  zero_acc<DH>(acc);
  for (int c0 = 0; c0 < S; c0 += GL_CHUNK) {  // pass 3
    __syncthreads();
    gl_stage<DH>(Ks, k + head, ts, c0, GL_CHUNK, S);
    gl_stage<DH>(Vs, v + head, ts, c0, GL_CHUNK, S);
    gl_landed();
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < GL_CHUNK / 16; ++i) {
      if (c0 + 16 * i >= S) break;
      float p[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        gl_scores<DH>(p[hh], qa, Ks + (size_t)8 * (2 * i + hh) * LD, c0 + 8 * (2 * i + hh), S,
                      scale, lane);
      gl_probs(p, m, l);
      if constexpr (SPLIT) {
        uint32_t hi[4], lo[4];
        split_a(hi, lo, p[0], p[1]);
        mma_rows_split<DH>(acc, hi, lo, Vs + (size_t)16 * i * LD, lane);
      } else {
        uint32_t pa[4];
        pack_a(pa, p[0], p[1]);
        mma_rows<DH>(acc, pa, Vs + (size_t)16 * i * LD, lane);
      }
    }
  }
  if (live) store_rows<DH>(o + (long long)b * obs + h * DH, ots, acc, 1.0f, q0, S, lane);
}

// ---------------------------------------------------------------------------
// The fused backward core: one block per (image, head), one launch
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ int gl_chunks_rows(int S) {
  return (S + GL_CHUNK - 1) / GL_CHUNK * GL_CHUNK;
}

// the staged rows (a round of two operands, a chunk of two) and the three
// statistics of every query
template <int DH>
static size_t gl_core_smem(int S) {
  return (size_t)2 * (GL_ROWS + GL_CHUNK) * tile_ld<DH>() * sizeof(bf16) +
         (size_t)3 * gl_chunks_rows(S) * sizeof(float);
}

// the longest S the core takes at head_dim DH: the three statistics of every
// query beside the staged rows, in whole GL_CHUNK-query chunks, and at most
// long_core_max_seq() (the head_dim-64 core's): 15,168 at head_dim 16-48,
// (232,448 - 67,584) / 12 bytes = 13,696 queries at 80
template <int DH>
static int gl_core_max_seq() {
  const long long room = LA_MAX_SMEM - (long long)gl_core_smem<DH>(0);
  const int fit = (int)(room / (3 * (long long)sizeof(float)) / GL_CHUNK * GL_CHUNK);
  return fit < long_core_max_seq() ? fit : long_core_max_seq();
}

// att (B S, D) and dqkv (B S, 3 D) from qkv (B S, 3 D) and datt = dO (B S,
// D), head h at column h DH of each third
template <int DH>
__global__ void __launch_bounds__(GL_WARPS * 32, 1)
gl_core_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ datt,
               bf16* __restrict__ att, bf16* __restrict__ dqkv, int S, int D, float scale) {
  constexpr int LD = tile_ld<DH>();
  extern __shared__ __align__(128) bf16 gl_smem[];
  bf16* Ra = gl_smem;              // rows phase: Q; cols phase: K (a round)
  bf16* Rb = Ra + GL_ROWS * LD;    // rows phase: dO; cols phase: V
  bf16* Ca = Rb + GL_ROWS * LD;    // rows phase: K; cols phase: Q (a chunk)
  bf16* Cb = Ca + GL_CHUNK * LD;   // rows phase: V; cols phase: dO
  float* rmax = reinterpret_cast<float*>(Cb + GL_CHUNK * LD);
  const int SPc = gl_chunks_rows(S);
  float* rsum = rmax + SPc;
  float* rdot = rsum + SPc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long ts = 3LL * D;
  const bf16* qh = qkv + (long long)b * S * ts + h * DH;
  const bf16* kh = qh + D;
  const bf16* vh = qh + 2 * D;
  const bf16* oh = datt + (long long)b * S * D + h * DH;

  // ---- rows phase: GL_ROWS queries a round, 16 a warp ----------------------
  for (int r0 = 0; r0 < S; r0 += GL_ROWS) {
    const int q0 = r0 + 16 * warp;
    const bool live = q0 < S;
    __syncthreads();  // every warp is done with the last round's rows
    gl_stage<DH>(Ra, qh, ts, r0, GL_ROWS, S);
    gl_stage<DH>(Rb, oh, D, r0, GL_ROWS, S);
    gl_landed();
    uint32_t qa[DH / 16][4], oa[DH / 16][4];
    load_a_rows<DH>(qa, Ra + (size_t)16 * warp * LD, lane);
    load_a_rows<DH>(oa, Rb + (size_t)16 * warp * LD, lane);
    float m[2], l[2], dot[2], acc[DH / 8][4], dq[DH / 8][4];
    gl_stats<DH>(m, l, qa, Ca, kh, ts, S, scale, live, lane);
    gl_rows_bwd<DH, false>(acc, dq, dot, qa, oa, m, l, Ca, Cb, kh, vh, ts, S, scale, live,
                           lane);
    if (!live) continue;
    store_rows<DH>(att + (long long)b * S * D + h * DH, D, acc, 1.0f, q0, S, lane);
    store_rows<DH>(dqkv + (long long)b * S * ts + h * DH, ts, dq, scale, q0, S, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rmax[q0 + g + 8 * r] = m[r];
        rsum[q0 + g + 8 * r] = l[r];
        rdot[q0 + g + 8 * r] = dot[r];
      }
    }
  }

  // ---- cols phase: GL_ROWS keys a round, 16 a warp, every query ------------
  for (int r0 = 0; r0 < S; r0 += GL_ROWS) {
    const int k0 = r0 + 16 * warp;
    const bool live = k0 < S;
    __syncthreads();  // the statistics are in; every warp is done with the rows
    gl_stage<DH>(Ra, kh, ts, r0, GL_ROWS, S);
    gl_stage<DH>(Rb, vh, ts, r0, GL_ROWS, S);
    gl_landed();
    uint32_t ka[DH / 16][4], va[DH / 16][4];
    load_a_rows<DH>(ka, Ra + (size_t)16 * warp * LD, lane);
    load_a_rows<DH>(va, Rb + (size_t)16 * warp * LD, lane);
    float dk[DH / 8][4], dv[DH / 8][4];
    zero_acc<DH>(dk);
    zero_acc<DH>(dv);
    for (int c0 = 0; c0 < S; c0 += GL_CHUNK) {
      __syncthreads();
      gl_stage<DH>(Ca, qh, ts, c0, GL_CHUNK, S);
      gl_stage<DH>(Cb, oh, D, c0, GL_CHUNK, S);
      gl_landed();
      if (!live) continue;
#pragma unroll
      for (int i = 0; i < GL_CHUNK / 16; ++i) {
        if (c0 + 16 * i >= S) break;
        // P^T and dS^T of the warp's keys (rows) against queries c0 + 16 i..
        float pt[2][4], dst[2][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int qj = 2 * i + hh;
          mma_rows_t<DH>(pt[hh], ka, Ca + (size_t)8 * qj * LD, lane);
          mma_rows_t<DH>(dst[hh], va, Cb + (size_t)8 * qj * LD, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + g + 8 * (e >> 1);
            const int qq = c0 + 8 * qj + 2 * t + (e & 1);
            const float p =
                (key < S && qq < S)
                    ? expf(__fsub_rn(__fmul_rn(pt[hh][e], scale), rmax[qq])) / rsum[qq]
                    : 0.0f;
            pt[hh][e] = p;
            dst[hh][e] = p * (dst[hh][e] - (qq < S ? rdot[qq] : 0.0f));
          }
        }
        uint32_t pa[4], da[4];
        pack_a(pa, pt[0], pt[1]);
        pack_a(da, dst[0], dst[1]);
        mma_rows<DH>(dv, pa, Cb + (size_t)16 * i * LD, lane);
        mma_rows<DH>(dk, da, Ca + (size_t)16 * i * LD, lane);
      }
    }
    if (!live) continue;
    store_rows<DH>(dqkv + (long long)b * S * ts + D + h * DH, ts, dk, scale, k0, S, lane);
    store_rows<DH>(dqkv + (long long)b * S * ts + 2 * D + h * DH, ts, dv, 1.0f, k0, S, lane);
  }
}

// ---------------------------------------------------------------------------
// The flash backward: rows launch (statistics, dQ), cols launch (dK, dV)
// ---------------------------------------------------------------------------

template <int DH>
static size_t gl_flash_smem() {  // a round of two operands, a chunk of two, a chunk's statistics
  return (size_t)2 * (GL_ROWS + GL_CHUNK) * tile_ld<DH>() * sizeof(bf16) +
         (size_t)3 * GL_CHUNK * sizeof(float);
}

// one block per GL_ROWS queries: dq (contiguous (B, S, H, DH)) and each
// query's m, l, dot at stats + ((b H + h) S + s) 3
template <int DH>
__global__ void __launch_bounds__(GL_WARPS * 32, GL_FLASH_MINB(DH))
gl_flash_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     bf16* __restrict__ dq, float* __restrict__ stats, int S, int H,
                     long long bs, long long ts, float scale) {
  constexpr int LD = tile_ld<DH>();
  extern __shared__ __align__(128) bf16 gl_smem[];
  bf16* Qs = gl_smem;
  bf16* Os = Qs + GL_ROWS * LD;
  bf16* Ks = Os + GL_ROWS * LD;
  bf16* Vs = Ks + GL_CHUNK * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * GL_ROWS, q0 = r0 + 16 * warp;
  const bool live = q0 < S;
  const long long head = (long long)b * bs + h * DH;
  const long long ots = (long long)H * DH, ohead = (long long)b * S * ots + h * DH;
  gl_stage<DH>(Qs, q + head, ts, r0, GL_ROWS, S);
  gl_stage<DH>(Os, dout + ohead, ots, r0, GL_ROWS, S);
  gl_landed();
  uint32_t qa[DH / 16][4], oa[DH / 16][4];
  load_a_rows<DH>(qa, Qs + (size_t)16 * warp * LD, lane);
  load_a_rows<DH>(oa, Os + (size_t)16 * warp * LD, lane);
  float m[2], l[2], dot[2], acc[DH / 8][4];
  gl_stats<DH>(m, l, qa, Ks, k + head, ts, S, scale, live, lane);
  gl_rows_bwd<DH, true>(nullptr, acc, dot, qa, oa, m, l, Ks, Vs, k + head, v + head, ts, S,
                        scale, live, lane);
  if (!live) return;
  store_rows<DH>(dq + ohead, ots, acc, scale, q0, S, lane);
  if (t == 0) {
    float* st = stats + ((long long)(b * H + h) * S) * 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row < S) {
        st[row * 3 + 0] = m[r];
        st[row * 3 + 1] = l[r];
        st[row * 3 + 2] = dot[r];
      }
    }
  }
}

// one block per GL_ROWS keys, every query in GL_CHUNK-query chunks: dK and
// dV, with the operands in the rows launch's roles (queries as A, keys as
// B: the same scores bit for bit), P and dS transposed by movmatrix
template <int DH>
__global__ void __launch_bounds__(GL_WARPS * 32, GL_FLASH_MINB(DH))
gl_flash_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ stats, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, long long bs, long long ts,
                     float scale) {
  constexpr int LD = tile_ld<DH>();
  extern __shared__ __align__(128) bf16 gl_smem[];
  bf16* Kt = gl_smem;
  bf16* Vt = Kt + GL_ROWS * LD;
  bf16* Qc = Vt + GL_ROWS * LD;
  bf16* Oc = Qc + GL_CHUNK * LD;
  float* rmax = reinterpret_cast<float*>(Oc + GL_CHUNK * LD);
  float* rsum = rmax + GL_CHUNK;
  float* rdot = rsum + GL_CHUNK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * GL_ROWS, k0 = r0 + 16 * warp;
  const bool live = k0 < S;
  const long long head = (long long)b * bs + h * DH;
  const long long ots = (long long)H * DH, ohead = (long long)b * S * ots + h * DH;
  const float* st = stats + ((long long)(b * H + h) * S) * 3;
  gl_stage<DH>(Kt, k + head, ts, r0, GL_ROWS, S);
  gl_stage<DH>(Vt, v + head, ts, r0, GL_ROWS, S);
  const bf16* Kw = Kt + (size_t)16 * warp * LD;
  const bf16* Vw = Vt + (size_t)16 * warp * LD;
  float ak[DH / 8][4], av[DH / 8][4];
  zero_acc<DH>(ak);
  zero_acc<DH>(av);
  for (int c0 = 0; c0 < S; c0 += GL_CHUNK) {
    __syncthreads();  // every warp is done with the last chunk
    gl_stage<DH>(Qc, q + head, ts, c0, GL_CHUNK, S);
    gl_stage<DH>(Oc, dout + ohead, ots, c0, GL_CHUNK, S);
    for (int i = threadIdx.x; i < 3 * GL_CHUNK; i += blockDim.x) {  // pad queries: inert
      const int c = i / 3, f = i % 3;
      const bool ok = c0 + c < S;
      cp_async4(rmax + f * GL_CHUNK + c, st + (ok ? (long long)c0 * 3 + i : 0), ok);
    }
    gl_landed();
    if (!live) continue;
#pragma unroll
    for (int i = 0; i < GL_CHUNK / 16; ++i) {
      if (c0 + 16 * i >= S) break;
      uint32_t qa[DH / 16][4], oa[DH / 16][4];
      load_a_rows<DH>(qa, Qc + (size_t)16 * i * LD, lane);
      load_a_rows<DH>(oa, Oc + (size_t)16 * i * LD, lane);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma_rows_t<DH>(p[n], qa, Kw + (size_t)8 * n * LD, lane);
        mma_rows_t<DH>(ds[n], oa, Vw + (size_t)8 * n * LD, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * i + g + 8 * (e >> 1);  // the query, within the chunk
          const bool ok = c0 + row < S && k0 + 8 * n + 2 * t + (e & 1) < S;
          // the rows launch's p, bit for bit: the same score, the same operations
          const float pr =
              ok ? expf(__fsub_rn(__fmul_rn(p[n][e], scale), rmax[row])) / rsum[row] : 0.0f;
          p[n][e] = pr;
          ds[n][e] = pr * (ds[n][e] - rdot[row]);
        }
      }
      uint32_t hi[4], lo[4];
      split_a_t(hi, lo, p);  // P^T: rows key, columns query
      mma_rows_split<DH>(av, hi, lo, Oc + (size_t)16 * i * LD, lane);
      split_a_t(hi, lo, ds);
      mma_rows_split<DH>(ak, hi, lo, Qc + (size_t)16 * i * LD, lane);
    }
  }
  if (!live) return;
  store_rows<DH>(dk + ohead, ots, ak, scale, k0, S, lane);
  store_rows<DH>(dv + ohead, ots, av, 1.0f, k0, S, lane);
}

// ---------------------------------------------------------------------------
// Launches on the caller's stream
// ---------------------------------------------------------------------------

template <class K>
static int gl_set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// the forward: o from q, k, v as gl_fwd_kernel takes them
template <int DH, bool SPLIT>
static int gl_launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                         int H, long long bs, long long ts, long long obs, long long ots,
                         cudaStream_t st) {
  const size_t smem = gl_fwd_smem<DH>();
  LAUNCH(gl_set_smem(gl_fwd_kernel<DH, SPLIT>, smem));
  const dim3 grid((S + GL_ROWS - 1) / GL_ROWS, H, B);
  gl_fwd_kernel<DH, SPLIT><<<grid, GL_WARPS * 32, smem, st>>>(q, k, v, o, S, bs, ts, obs, ots,
                                                              attention_scale(DH));
  return (int)cudaGetLastError();
}

// the fused block's forward stage: att (B S, D) from qkv (B S, 3 D)
template <int DH>
static int gl_launch_stage(const bf16* qkv, bf16* att, int B, int S, int H, int D,
                           cudaStream_t st) {
  const long long ts = 3LL * D;
  return gl_launch_fwd<DH, false>(qkv, qkv + D, qkv + 2 * D, att, B, S, H, S * ts, ts,
                                  (long long)S * D, D, st);
}

// the fused block's backward core: att and dqkv from qkv and datt, one
// launch; S <= gl_core_max_seq<DH>()
template <int DH>
static int gl_launch_core(const bf16* qkv, const bf16* datt, bf16* att, bf16* dqkv, int B, int S,
                          int H, int D, cudaStream_t st) {
  const size_t smem = gl_core_smem<DH>(S);
  if (S > gl_core_max_seq<DH>() || smem > LA_MAX_SMEM) return (int)cudaErrorInvalidValue;
  LAUNCH(gl_set_smem(gl_core_kernel<DH>, smem));
  gl_core_kernel<DH><<<dim3(H, B), GL_WARPS * 32, smem, st>>>(qkv, datt, att, dqkv, S, D,
                                                              attention_scale(DH));
  return (int)cudaGetLastError();
}

// the flash backward: dq, dk, dv contiguous (B, S, H, DH) from q, k, v (as
// gl_fwd_kernel takes them) and a contiguous dout; ws: B H S 3 floats
template <int DH>
static int gl_launch_flash_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                               bf16* dq, bf16* dk, bf16* dv, float* ws, int B, int S, int H,
                               long long bs, long long ts, cudaStream_t st) {
  const size_t smem = gl_flash_smem<DH>();
  const dim3 grid((S + GL_ROWS - 1) / GL_ROWS, H, B);
  const float scale = attention_scale(DH);
  LAUNCH(gl_set_smem(gl_flash_rows_kernel<DH>, smem));
  gl_flash_rows_kernel<DH><<<grid, GL_WARPS * 32, smem, st>>>(q, k, v, dout, dq, ws, S, H, bs,
                                                              ts, scale);
  LAUNCH((int)cudaGetLastError());
  LAUNCH(gl_set_smem(gl_flash_cols_kernel<DH>, smem));
  gl_flash_cols_kernel<DH><<<grid, GL_WARPS * 32, smem, st>>>(q, k, v, dout, ws, dk, dv, S, H,
                                                              bs, ts, scale);
  return (int)cudaGetLastError();
}
