// The forward layer's GEMM on its wide route (D > FUSED_MLP_MAX_D: ViT-Small,
// ViT-Base, ViT-Large) for Hopper (sm_90a): C[M, N] = A[M, K] B[K, N] with one of four
// fused epilogues, B one layer's matrix of a stacked (L, K, N) weight.
// csrc/layer_fwd.cuh runs it for the layer's four products (QKV, Wo, W1,
// W2); see there for the layer it belongs to.
//
// What bounds it. At ViT-Base, B = 256 (M = 50,432), the four products of a
// layer are 714 GFLOP against ~1.6 GB of operands and results moved once: at
// ~450 FLOP per byte, above the H100's ~295 bf16 line, so operations.
//
// The design, for the tensor cores' rate: one persistent block per SM walks
// 128 x NT output tiles t = blockIdx.x, + gridDim.x, ... with N's tile index
// running fastest, so the blocks in flight share a few 128-row A panels and
// one weight matrix (at most 4.7 MB) in L2. A producer warp issues every TMA
// load: per 64-deep k-chunk one ring stage holds A's 128 x 64 rows (two
// 64-row boxes) and B's 64 x NT columns; it runs ahead into the next tile's
// stages while the consumers finish a tile, so one tile's epilogue overlaps
// the next one's loads. Two consumer warpgroups own 64 rows each: per stage
// four m64nNTk16 wgmmas in k order, one k-chunk's products in flight while
// the next is issued. Each output sums its K as one fp32 chain of 16-deep
// k-steps in order (no split K). NT = 192 wherever it divides N (every
// matrix of ViT-Small and ViT-Base, ViT-Large's QKV), else 128 or 64
// (ViT-Large's Wo, W1 and W2).
//
// Epilogues, per output pair (fp32 acc):
//   EPI_BIAS   out = bf16(acc + bias)                          (qkv)
//   EPI_RESID  x2 = (x + acc) + bias in fp32 to ep.f32, with the
//              optional xs (a copy of x) and x2s (bf16(x2)) stacks
//   EPI_GELU   out = bf16(gelu(acc + bias)), rowblock.cuh's gelu_fwd
//              (the backward's recompute takes the same form)    (g)
//   EPI_OUT    out = bf16((x2 + acc) + bias)                   (the layer output)
// The bf16 results are staged per warpgroup in the 128-byte swizzle and
// leave by TMA stores (which clip rows past M); x2 leaves from registers.
// Rows past M read as zeros (TMA's out-of-bounds fill) and are never stored.

#pragma once

#include "rowblock.cuh"

#define TG_WG 2  // consumer warpgroups: 64 rows of the 128-row tile each
#define TG_ROWS (TG_WG * 64)
#define TG_THREADS (TG_WG * 128 + 32)

// the output tile's width for N (a multiple of 64)
static int tg_nt(int N) { return N % 192 == 0 ? 192 : N % 128 == 0 ? 128 : 64; }

template <int NT, int EPI>
struct TileGemm {
  static constexpr int NB = NT / 64;                       // B boxes per stage
  static constexpr int STAGE = (TG_WG + NB) * TMA_BOX_BYTES;  // A 128 x 64, B 64 x NT
  static constexpr int OUT = EPI == EPI_RESID ? 0 : TG_WG * NB * TMA_BOX_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - OUT) / STAGE;
  static constexpr int RING = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + OUT + RING * STAGE;
};

template <int NT, int EPI, int FAST>
__global__ void __launch_bounds__(TG_THREADS, 1)
tile_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap bmap,
                 const __grid_constant__ CUtensorMap omap, int layer, int M, int N, int K,
                 EpiArgs ep) {
  using P = TileGemm<NT, EPI>;
  constexpr int NB = P::NB;
  __shared__ uint64_t full[P::RING], empty[P::RING];
  extern __shared__ uint8_t raw[];
  uint8_t* otile = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);  // staged outputs
  Ring ring{full, empty, otile + P::OUT, P::STAGE, P::RING, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntn = N / NT, tiles = (M + TG_ROWS - 1) / TG_ROWS * ntn, kch = K / 64;
  if (tid == 0) {
    ring_init(full, empty, P::RING, TG_WG * 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == TG_WG * 4) {  // producer: one lane issues every load
    if (lane == 0)
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / ntn * TG_ROWS, n0 = t % ntn * NT;
        for (int kc = 0; kc < kch; ++kc) {
          uint64_t* bar;
          uint8_t* st = ring.fill(P::STAGE, &bar);
          for (int w = 0; w < TG_WG; ++w)
            tma_load(st + w * TMA_BOX_BYTES, &amap, bar, kc * 64, m0 + w * 64, 0);
          for (int j = 0; j < NB; ++j)
            tma_load(st + (TG_WG + j) * TMA_BOX_BYTES, &bmap, bar, n0 + j * 64, kc * 64, layer);
        }
      }
    return;
  }

  const int w = warp >> 2, wl = warp & 3, t4 = lane & 3;
  const int lr = wl * 16 + (lane >> 2);  // the thread's first fragment row in the warpgroup's 64
  uint8_t* ot = otile + w * NB * TMA_BOX_BYTES;
  const bool issuer = wl == 0 && lane == 0;
  float acc[NT / 2];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / ntn * TG_ROWS, n0 = t % ntn * NT;
    int prev = -1;
    for (int kc = 0; kc < kch; ++kc) {
      const int s = ring.take();
      const uint8_t* st = ring.at(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<NT>::mma(acc, a_desc(st + w * TMA_BOX_BYTES + ks * 32),
                       b_desc(st + TG_WG * TMA_BOX_BYTES + ks * 2048, TMA_BOX_BYTES), kc | ks);
      wgmma_commit();
      fence_regs<NT / 2>(acc);
      if (prev >= 0) {  // the previous k-chunk's products are done with their stage
        wgmma_wait<1>();
        ring.release(prev, lane);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs<NT / 2>(acc);
    ring.release(prev, lane);

    // register i: row r0 + 8 ((i / 2) % 2), column n0 + 8 (i / 4) + 2 t4 + i % 2
    const int r0 = m0 + w * 64 + lr;
    if constexpr (EPI == EPI_RESID) {
      // every load first, all in flight together: as far as the compiler
      // knows, the stores below may alias x and the bias, so a load after
      // one would wait out its whole latency (a 3x slower stage)
      uint32_t xv[NT / 4], bv[NT / 8];
#pragma unroll
      for (int i = 0; i < NT / 2; i += 2) {
        const int gr = r0 + 8 * ((i >> 1) & 1), gc = n0 + 8 * (i >> 2) + 2 * t4;
        xv[i / 2] = gr < M ? ld_b32(ep.resid + (size_t)gr * N + gc) : 0u;
        if ((i & 2) == 0) bv[i / 4] = ld_b32(ep.bias + gc);
      }
#pragma unroll
      for (int i = 0; i < NT / 2; i += 2) {
        const int gr = r0 + 8 * ((i >> 1) & 1), gc = n0 + 8 * (i >> 2) + 2 * t4;
        if (gr < M) {
          const size_t idx = (size_t)gr * N + gc;
          const float2 x = bf2_to_f2(xv[i / 2]), bb = bf2_to_f2(bv[i / 4]);
          const float a0 = (x.x + acc[i]) + bb.x, a1 = (x.y + acc[i + 1]) + bb.y;
          *reinterpret_cast<float2*>(ep.f32 + idx) = make_float2(a0, a1);
          if (ep.xs) *reinterpret_cast<uint32_t*>(ep.xs + idx) = xv[i / 2];
          if (ep.x2s) *reinterpret_cast<uint32_t*>(ep.x2s + idx) = pack_f32(a0, a1);
        }
      }
    } else {
      // into this warpgroup's staged tile, once its last TMA stores have
      // read it, then out by TMA stores
      if (issuer) bulk_wait_read();
      named_sync(1 + w, 128);
#pragma unroll
      for (int i = 0; i < NT / 2; i += 2) {
        const int hs = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * t4;
        const float2 bb = load2(ep.bias + n0 + c);
        float v0, v1;
        if constexpr (EPI == EPI_OUT) {
          const int gr = r0 + 8 * hs;
          const float2 x2 = gr < M ? load2(ep.f32 + (size_t)gr * N + n0 + c) : make_float2(0.f, 0.f);
          v0 = (x2.x + acc[i]) + bb.x;
          v1 = (x2.y + acc[i + 1]) + bb.y;
        } else if constexpr (EPI == EPI_GELU) {
          v0 = gelu_fwd<FAST>(acc[i] + bb.x);
          v1 = gelu_fwd<FAST>(acc[i + 1] + bb.y);
        } else {  // EPI_BIAS
          v0 = acc[i] + bb.x;
          v1 = acc[i + 1] + bb.y;
        }
        *reinterpret_cast<uint32_t*>(ot + (c >> 6) * TMA_BOX_BYTES + sw128(lr + 8 * hs, c & 63)) =
            pack_f32(v0, v1);
      }
      fence_async_smem();
      named_sync(1 + w, 128);
      if (issuer) {
        for (int j = 0; j < NB; ++j)
          tma_store(&omap, ot + j * TMA_BOX_BYTES, n0 + j * 64, m0 + w * 64, 0);
        bulk_commit();
      }
    }
  }
  if (EPI != EPI_RESID && issuer) bulk_wait_read();
}

// the persistent grid: one block per SM (the block takes most of an SM's
// shared memory), never more blocks than tiles
static int tg_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <int NT, int EPI, int FAST>
static int launch_tile_gemm_nt(const CUtensorMap& amap, const CUtensorMap& bmap,
                               const CUtensorMap& omap, int layer, int M, int N, int K,
                               const EpiArgs& ep, cudaStream_t st) {
  using P = TileGemm<NT, EPI>;
  auto kernel = tile_gemm_kernel<NT, EPI, FAST>;
  LAUNCH((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM));
  const int sms = tg_sms();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int tiles = (M + TG_ROWS - 1) / TG_ROWS * (N / NT);
  kernel<<<tiles < sms ? tiles : sms, TG_THREADS, P::SMEM, st>>>(amap, bmap, omap, layer, M, N,
                                                                 K, ep);
  return (int)cudaGetLastError();
}

template <int EPI, int FAST>
static int launch_tile_gemm_f(const CUtensorMap& amap, const CUtensorMap& bmap,
                              const CUtensorMap& omap, int layer, int M, int N, int K,
                              const EpiArgs& ep, cudaStream_t st) {
  switch (tg_nt(N)) {
    case 192:
      return launch_tile_gemm_nt<192, EPI, FAST>(amap, bmap, omap, layer, M, N, K, ep, st);
    case 128:
      return launch_tile_gemm_nt<128, EPI, FAST>(amap, bmap, omap, layer, M, N, K, ep, st);
    default:
      return launch_tile_gemm_nt<64, EPI, FAST>(amap, bmap, omap, layer, M, N, K, ep, st);
  }
}

// C = A B of layer `layer`'s matrix with epilogue EPI (EPI_GELU: the form
// ep.fast_gelu names). amap: A (M x K, bf16); bmap: the stacked (K, N)
// weights; omap: the bf16 output (all but EPI_RESID). N and K multiples of 64.
template <int EPI>
static int launch_tile_gemm(const CUtensorMap& amap, const CUtensorMap& bmap,
                            const CUtensorMap& omap, int layer, int M, int N, int K,
                            const EpiArgs& ep, cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 64 || K % 64) return (int)cudaErrorInvalidValue;
  if constexpr (EPI == EPI_GELU)
    if (ep.fast_gelu) return launch_tile_gemm_f<EPI, 1>(amap, bmap, omap, layer, M, N, K, ep, st);
  return launch_tile_gemm_f<EPI, 0>(amap, bmap, omap, layer, M, N, K, ep, st);
}

// dynamic shared memory per block of the GEMM with epilogue EPI at width N
template <int EPI>
static int tile_gemm_smem_bytes(int N) {
  switch (tg_nt(N)) {
    case 192: return TileGemm<192, EPI>::SMEM;
    case 128: return TileGemm<128, EPI>::SMEM;
    default: return TileGemm<64, EPI>::SMEM;
  }
}
