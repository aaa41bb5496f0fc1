// Weight gradients of the backward halves on wgmma (sm_90a): [dW; db] = A^T B
// over the M token rows, bf16 operands, fp32 sums, in split partials that a
// fixed-order reduction adds (no atomics, so two runs give the same bits).
//
// A is (M, K1), B is (M, N), both row-major: the product's reduction index is
// their row, so A enters wgmma M-major (TA = 1: a [64 tokens][64 K1] box is
// 16 K-steps of 64 output rows) and B N-major (TB = 1), each by TMA, 64 token
// rows per stage. A block owns 128 rows of K1 (two consumer warpgroups of 64)
// by NT = N columns over one split of the tokens, with a producer warp
// feeding a ring of GEMM_RING stages; a warpgroup whose 64 rows lie past K1
// (K1 an odd multiple of 64) only walks the ring. The bias gradient is the
// column sums of B (bias_a = 0) or of A (bias_a = 1): the block of the first
// K1 tile (or every block, for A's columns) sums them from the staged tiles,
// one thread per column, rows in order, while the products run.
//
// Partials: split s writes ws[s][0 .. K1 N) (row-major (K1, N)) and
// ws[s][K1 N ..) (the bias); reduce_all_kernel adds the splits in order and
// may write dW transposed (Reduction::tcols), so dW1 = y2^T dm1 runs as
// dm1^T y2 with the wider operand on the rows. Two problems share a launch.

#pragma once

#include "rowblock.cuh"

// widest D of the bf16 backward halves' wgmma route (csrc/mlp_bwd.cuh,
// csrc/attn_bwd.cuh): its LayerNorm-backward GEMM keeps a 64 x D fp32 dy per
// warpgroup in registers
#define HOPPER_BWD_MAX_D 256
#define WGRAD_WG 2
#define WGRAD_SMS 132  // blocks in flight: one per SM of an H100

struct WgradProblem {
  int K1, N, M;
  int k1tiles, splits, cps;  // 128-row tiles of K1; token splits, 64-row chunks each
  int bias_a;                // the bias sums A's columns (else B's)
  float* ws;                 // splits x (K1 N + bias length) partials
  __host__ __device__ int blocks() const { return k1tiles * splits; }
  __host__ __device__ int bias_len() const { return bias_a ? K1 : N; }
  __host__ __device__ size_t part_floats() const { return (size_t)K1 * N + bias_len(); }
};

template <int NT>
__host__ __device__ constexpr int wgrad_stage_bytes() {
  return (WGRAD_WG + NT / 64) * TMA_BOX_BYTES;
}

template <int NT>
__global__ void __launch_bounds__(WGRAD_WG * 128 + 32, 1)
wgrad_kernel(const __grid_constant__ CUtensorMap a0map, const __grid_constant__ CUtensorMap b0map,
             const __grid_constant__ CUtensorMap a1map, const __grid_constant__ CUtensorMap b1map,
             const WgradProblem p0, const WgradProblem p1) {
  constexpr int STAGE = wgrad_stage_bytes<NT>();
  constexpr int B_OFF = WGRAD_WG * TMA_BOX_BYTES;
  __shared__ uint64_t full[GEMM_RING], empty[GEMM_RING];
  extern __shared__ uint8_t raw[];
  uint8_t* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, base, STAGE, GEMM_RING, 0};
  const bool second = (int)blockIdx.x >= p0.blocks();
  const WgradProblem& p = second ? p1 : p0;
  const CUtensorMap* amap = second ? &a1map : &a0map;
  const CUtensorMap* bmap = second ? &b1map : &b0map;
  const int local = blockIdx.x - (second ? p0.blocks() : 0);
  const int kt = local % p.k1tiles, split = local / p.k1tiles;
  const int nchunks = (p.M + 63) / 64;
  const int c0 = split * p.cps, c1 = min(c0 + p.cps, nchunks);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    ring_init(full, empty, GEMM_RING, WGRAD_WG * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WGRAD_WG * 4) {  // producer
    if (lane == 0)
      for (int c = c0; c < c1; ++c) {
        uint64_t* bar;
        uint8_t* st = ring.fill(STAGE, &bar);
        for (int w = 0; w < WGRAD_WG; ++w)
          tma_load(st + w * TMA_BOX_BYTES, amap, bar, kt * 128 + w * 64, c * 64, 0);
        for (int j = 0; j < NT / 64; ++j)
          tma_load(st + B_OFF + j * TMA_BOX_BYTES, bmap, bar, j * 64, c * 64, 0);
      }
    return;
  }

  const int w = warp >> 2, wl = warp & 3;
  const bool live = kt * 128 + w * 64 < p.K1;
  // the bias column this thread sums, if any: a column of B (threads of the
  // first K1 tile), or of this warpgroup's A box
  int bias_col = -1, bias_out = 0, bias_box = 0;  // bias_box: its box's offset in a stage
  if (!p.bias_a && kt == 0 && tid < NT) {
    bias_col = tid & 63;
    bias_out = tid;
    bias_box = B_OFF + (tid >> 6) * TMA_BOX_BYTES;
  } else if (p.bias_a && live && (tid & 127) < 64) {
    bias_col = tid & 63;
    bias_out = kt * 128 + w * 64 + bias_col;
    bias_box = w * TMA_BOX_BYTES;
  }
  float bsum = 0.0f;
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  int prev = -1;
  for (int c = c0; c < c1; ++c) {
    const int s = ring.take();
    const uint8_t* st = ring.at(s);
    if (live) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<NT>::template mma<0, 1, 1>(acc, mn_desc(st + w * TMA_BOX_BYTES + ks * 2048),
                                         b_desc(st + B_OFF + ks * 2048, TMA_BOX_BYTES), 1);
      wgmma_commit();
      fence_regs<NT / 2>(acc);
    }
    if (bias_col >= 0) {
      const uint8_t* box = st + bias_box;
      for (int r = 0; r < 64; ++r)
        bsum += __bfloat162float(*reinterpret_cast<const bf16*>(box + sw128(r, bias_col)));
    }
    __syncwarp();
    if (prev >= 0) {
      if (live) wgmma_wait<1>();
      ring.release(prev, lane);
    }
    prev = s;
  }
  if (live) {
    wgmma_wait<0>();
    fence_regs<NT / 2>(acc);
  }
  if (prev >= 0) ring.release(prev, lane);

  float* part = p.ws + (size_t)split * p.part_floats();
  if (bias_col >= 0) part[(size_t)p.K1 * p.N + bias_out] = bsum;
  if (!live) return;
  const int r0 = kt * 128 + w * 64 + wl * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < NT / 2; i += 2) {
    const int gr = r0 + 8 * ((i >> 1) & 1), gc = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<float2*>(part + (size_t)gr * p.N + gc) = make_float2(acc[i], acc[i + 1]);
  }
}

// A problem's geometry for `total_tiles` K1 tiles in its launch: splits of
// whole 64-row chunks, enough blocks for about one per SM. Depends only on
// the shapes.
static WgradProblem wgrad_problem(int K1, int N, int M, int bias_a, int total_tiles) {
  WgradProblem p = {};
  p.K1 = K1;
  p.N = N;
  p.M = M;
  p.k1tiles = (K1 + 127) / 128;
  p.bias_a = bias_a;
  const int nchunks = (M + 63) / 64;
  int s = WGRAD_SMS / total_tiles;
  s = s < 1 ? 1 : (s > nchunks ? nchunks : s);
  p.cps = (nchunks + s - 1) / s;
  p.splits = (nchunks + p.cps - 1) / p.cps;
  return p;
}

// The two problems of one launch, (A0, B0) and (A1, B1), each A and B a
// row-major bf16 (M, K1) and (M, N), N = NT; their partials at ws, one after
// the other. Returns the fp32 workspace they need when `ws` is null.
template <int NT>
static long long wgrad_pair(const bf16* a0, const bf16* b0, int k0, int bias_a0, const bf16* a1,
                            const bf16* b1, int k1, int bias_a1, int M, float* ws,
                            WgradProblem* out, cudaStream_t st) {
  const int tiles = (k0 + 127) / 128 + (k1 + 127) / 128;
  WgradProblem p0 = wgrad_problem(k0, NT, M, bias_a0, tiles);
  WgradProblem p1 = wgrad_problem(k1, NT, M, bias_a1, tiles);
  const size_t need = (size_t)p0.splits * p0.part_floats() + (size_t)p1.splits * p1.part_floats();
  if (!ws) return (long long)need;
  p0.ws = ws;
  p1.ws = ws + (size_t)p0.splits * p0.part_floats();
  CUtensorMap am0, bm0, am1, bm1;
  LAUNCH(tensor_map(&am0, a0, k0, M, 1));
  LAUNCH(tensor_map(&bm0, b0, NT, M, 1));
  LAUNCH(tensor_map(&am1, a1, k1, M, 1));
  LAUNCH(tensor_map(&bm1, b1, NT, M, 1));
  const int smem = 1024 + GEMM_RING * wgrad_stage_bytes<NT>();
  LAUNCH((int)cudaFuncSetAttribute(wgrad_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem));
  wgrad_kernel<NT><<<p0.blocks() + p1.blocks(), WGRAD_WG * 128 + 32, smem, st>>>(am0, bm0, am1,
                                                                                bm1, p0, p1);
  out[0] = p0;
  out[1] = p1;
  return (long long)cudaGetLastError();
}

// The reduction of one problem's partials into dW (transposed when the
// product ran as its transpose) and db.
static Reduction wgrad_reduction(const WgradProblem& p, float* dw, float* db, bool transposed) {
  return {p.ws, p.splits, (int)p.part_floats(), p.K1 * p.N, dw, db, transposed ? p.N : 0, 0};
}
