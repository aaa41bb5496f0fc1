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
// Several passes over the keys, nothing of a row's scores kept between them.
// Keeping a query tile's fp32 scores in shared memory instead (64 x S floats:
// 148 KB at S = 577, 262 KB at S = 1024) would cap S near 900 at 64 queries
// a tile; recomputing the scores costs tensor-core operations only, which
// the card has to spare at these sizes, and leaves S unbounded. Per 64-row
// tile of queries (keys in the core's key-major phase):
//
//   pass 1   s for every key: the row max m        (q k^T)
//   pass 2   s again: l = sum exp(s - m)           (q k^T)
//   forward  s again: p, then o += p v             (q k^T, p v)
//   core     pass 3: s, dP: dot = rowsum(dP p), att += bf16(p) v;
//            pass 4: s, dP: dS, dQ += dS k;
//            key-major: per 64 keys, every query: s^T = k q^T and dP^T = v
//            dO^T, p and dS from each query's statistics, dV += bf16(p)^T
//            dO and dK += dS^T q (the keys are the accumulator's rows, so
//            no transposes).
//   flash    the core's passes with p and dS in two terms and no att (its
//   backward pass 3 has no P V), in two launches: the query passes write
//            each query's statistics to a workspace in global memory, the
//            key-major pass streams them beside the Q and dO chunks.
//
// What bounds it on this card: at ViT-Base/16-384 (S = 577, 12 heads, B =
// 64) the function's products are 32.7 GFLOP each (2 S^2 64 per (image,
// head)), 2 in the forward, 6 in the core's backward and 5 in the flash
// backward, against 56.7 MB (forward) to 113 MB (backward) of q, k, v, dO
// and outputs: operations, at 989 TFLOP/s, beside 0.017-0.034 ms of bytes.
// What the passes do beside the products is CUDA-core work, and it is what
// bounds them: per score and pass a scale, a subtraction, an expf (the
// SFU's ex2) and a correctly rounded quotient, ~27 instructions a score
// over the forward's passes and ~69 over the core's (more in the flash
// backward: its hi / lo splits), which at 132 SMs is ~0.22 and ~0.6 ms
// before any stall. Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py phase 15, tools/long_seq_sweep.py): all four routes at
// 9-11% of their bounds, the flash backward's two launches 1.76-1.78 ms
// (9.3-9.4%), 59% of it the query-major launch.
//
// The design: every product on wgmma, the scores and dP on SS
// products (Q, dO, K or V tiles in the 128-byte swizzle), P and dS packed
// straight from the accumulator registers into the A registers of RS
// products. Operands arrive by TMA (3-D maps over the (B, S, columns)
// tensors, zeros past S) through a ring of stages, each one 64-row chunk of
// the streamed side (K, or K and V; Q and dO in the key-major phase), fed by
// one lane of a producer warpgroup through full and empty mbarriers (it
// gives its registers to the consumers with setmaxnreg: without, the core
// spilled 3.9 KB and ran 2.3x slower); the consumer warpgroups take every
// stage in order. The forward runs persistent blocks of LA_FWD_WG consumer
// warpgroups over (image, head, LA_FWD_WG query tiles) items, so one chunk
// load feeds all of them, the next item's Q tiles loaded into a second slot
// while this one runs. The
// core keeps one block per (image, head), LA_CORE_MINB blocks an SM, each
// query's three statistics in shared memory. The flash backward's two
// launches are persistent like the forward (LA_FBWD_WG consumer warpgroups,
// LA_FBWD_MINB blocks an SM), the key-major one over key tiles, each query
// chunk's statistics arriving by one bulk copy in the ring stage beside
// its Q and dO boxes, so S is not bounded by shared memory; P and dS enter
// their RS products as two bf16 terms (la_pack<true>: per 16-wide k-step
// hi, then lo). Within a warpgroup the
// forward's passes and the core's statistics passes issue the scores of
// chunk c + 1 before the softmax of chunk c (two accumulator sets), so the
// CUDA cores' work overlaps the tensor cores; the core's other passes, whose
// dP doubles a set, have the registers for one (a second made ptxas
// serialize their wgmma, and in the flash backward's pass 3, which has no
// RS product, spilled and ran slower): the query passes issue the next
// chunk's SS products right behind each chunk's RS product, the key-major
// pass once the RS products have read their A registers, and two blocks an
// SM fill each other's waits. The quotient is la_quot, three branch-free
// instructions that give the IEEE division's bits where a >= 2^-100 and l
// <= 2^16 (proven on the card by chip_smoke.py; the IEEE division's
// slow-path branch had split a chunk's 32 quotients into as many basic
// blocks, which halved the forward's speed); a warp whose chunk holds a
// smaller a, or a row sum above 2^16, takes __fdiv_rn for it.
//
// The wgmma accumulator gives each thread the m16n8 fragment positions of
// mma.sync (register i: row (i / 2) % 2 of the thread's two, key 8 (i / 4) +
// 2 t + i % 2), so every sum keeps its order: per lane over the keys in
// ascending order, then the quad's shuffles, and the products' k-steps (16
// of head_dim, 16 keys or 16 queries) in order. The scores are scaled with
// __fmul_rn (1/8 is a power of two, so this is exact) and s - m is
// __fsub_rn. The key-major phase's K Q^T equals the query passes' Q K^T bit
// for bit on the card (chip_smoke.py), so both phases form the same p. No
// atomics: two runs give the same bits, and the forward stage and the
// backward core, which call the same passes, give the same att bits at the
// same S. Limits: head_dim 64; rows 16-byte aligned; the core keeps three
// fp32 statistics a query in shared memory beside at least one tile slot
// and two ring stages, so S <= long_core_max_seq() (15,168); the forward
// and the flash backward take any S.

#pragma once

#include <type_traits>

#include "hopper.cuh"

#define LA_CHUNK 64  // rows of the streamed side per staged chunk
#ifndef LA_FWD_WG
#define LA_FWD_WG 2  // the forward's consumer warpgroups: one 64-query tile each
#endif
#ifndef LA_FWD_STAGES
#define LA_FWD_STAGES 6  // its ring: stages of one 64-key chunk (K, or K and V)
#endif
#ifndef LA_CORE_WG
#define LA_CORE_WG 1  // the fused backward core's consumer warpgroups
#endif
#ifndef LA_CORE_STAGES
#define LA_CORE_STAGES 4  // its ring, where the statistics leave the room (at least 2)
#endif
#ifndef LA_CORE_MINB
#define LA_CORE_MINB 2  // its blocks an SM must hold (sets its consumers' registers)
#endif
#ifndef LA_FBWD_WG
#define LA_FBWD_WG 1  // the flash backward's consumer warpgroups (both launches)
#endif
#ifndef LA_FBWD_STAGES
#define LA_FBWD_STAGES 4  // their rings' stages
#endif
#ifndef LA_FBWD_MINB
#define LA_FBWD_MINB 2  // their blocks an SM must hold (sets their consumers' registers)
#endif
#define LA_SCALE 0.125f  // 1 / sqrt(head_dim 64)
#define LA_MAX_SMEM 232448  // dynamic shared memory a block may take (227 KB)
#define LA_CORE_SMEM (LA_MAX_SMEM - 256)  // the core's, beside its static mbarriers

// ---------------------------------------------------------------------------
// Fragment helpers
// ---------------------------------------------------------------------------

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_f32(__fsub_rn(x0, __bfloat162float(h0)), __fsub_rn(x1, __bfloat162float(h1)));
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

// ---------------------------------------------------------------------------
// The wgmma routes: the forward (stage and flash), the fused backward core
// and the flash backward. A warpgroup owns 64 rows; its accumulator register i of thread t
// (lane 4 g + t of warp wl) is row 16 wl + g + 8 ((i / 2) % 2), column
// la_col(i, t).
// ---------------------------------------------------------------------------

#define LA_STAGE_BYTES (2 * TMA_BOX_BYTES)  // a 64-row chunk of two operands: a ring stage, a tile
#define LA_PRODUCER_REGS 24  // the producer warpgroup's registers a thread (one lane loads)

// the consumers' registers a thread for blocks of `wg` consumer warpgroups
// and one producer warpgroup, `blocks` of them an SM. setmaxnreg only moves
// registers within a block: the block holds what ptxas gave every thread at
// launch (the launch bound's share of the 64 K, in steps of 8), the producer
// gives back all but LA_PRODUCER_REGS, and the consumers may take no more
// than that (asking for more waits forever: 4 forward warpgroups hung), nor
// more than 240.
__host__ __device__ constexpr int la_entry_regs(int wg, int blocks) {
  return (65536 / (blocks * (wg + 1) * 128) / 8 * 8) > 255 ? 248
                                                          : 65536 / (blocks * (wg + 1) * 128) / 8 * 8;
}
__host__ __device__ constexpr int la_consumer_regs(int wg, int blocks) {
  return ((la_entry_regs(wg, blocks) * (wg + 1) * 128 - 128 * LA_PRODUCER_REGS) / (128 * wg) / 8 *
          8) > 240
             ? 240
             : (la_entry_regs(wg, blocks) * (wg + 1) * 128 - 128 * LA_PRODUCER_REGS) / (128 * wg) /
                   8 * 8;
}

__device__ __forceinline__ int la_col(int i, int t) { return 8 * (i >> 2) + 2 * t + (i & 1); }

// a = expf(s - m) of a raw score x (s = x / 8)
__device__ __forceinline__ float la_exp(float x, float m) {
  return expf(__fsub_rn(__fmul_rn(x, LA_SCALE), m));
}

// a / l rounded to nearest without a branch, for a = 0 or a in [LA_QUOT_MIN,
// 1] and l in [1, LA_QUOT_MAX_L]: the correctly rounded reciprocal r of l once, then
// per quotient q = a r (within an ulp of a / l) and Markstein's correction q
// + (a - l q) r, its remainder exact in one fma while a / l stays clear of
// the subnormals. The IEEE division (__fdiv_rn, nvcc's `/`) branches to a
// slow path, which splits a chunk's 32 quotients into as many basic blocks
// that nothing interleaves; this is three instructions. chip_smoke.py holds
// it to __fdiv_rn bit for bit on 2^27 random pairs over a in [0, 1] (every
// exponent, the subnormals too) and l in [1, 2^16] (every exponent), and on
// the edges (long_quotient_probe); a warp with an a below LA_QUOT_MIN or an
// l above LA_QUOT_MAX_L (a row sum beyond the core's S limit: the forward
// and the flash backward take any S) takes __fdiv_rn for its chunk
// (la_divide, la_core_cols), the same bits.
#define LA_QUOT_MIN 7.88860905e-31f  // 2^-100
#define LA_QUOT_MAX_L 65536.0f        // 2^16
__device__ __forceinline__ float la_quot(float a, float l, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-l, q, a), r, q);
}
// 1 / l rounded to nearest (PTX rcp.rn: IEEE-rounded, subnormals kept)
__device__ __forceinline__ float la_rcp(float l) {
  float r;
  asm("rcp.rn.f32 %0, %1;" : "=f"(r) : "f"(l));
  return r;
}
struct LaQuot {
  float l, r;
  __device__ __forceinline__ explicit LaQuot(float den) : l(den), r(la_rcp(den)) {}
  __device__ __forceinline__ float operator()(float a) const { return la_quot(a, l, r); }
};

// s = a / l in place for the fragment's two rows (row (i / 2) % 2: l[.],
// q[.]): the branch-free quotient, or the IEEE division where `slow` (an a
// below LA_QUOT_MIN) holds in any lane of the warp
__device__ __forceinline__ void la_divide(float (&s)[32], const float (&l)[2],
                                          const LaQuot (&q)[2], bool slow) {
  if (__any_sync(0xffffffffu, slow)) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fdiv_rn(s[i], l[(i >> 1) & 1]);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = q[(i >> 1) & 1](s[i]);
  }
}

// d (64 x 64 fp32) = A B^T over head_dim, A the 64 rows at `a`, B the 64 rows
// at `b` (each [64 rows][64] in the 128-byte swizzle), 16-wide k-steps in
// order; issued, not waited for
__device__ __forceinline__ void la_ss(float (&d)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int ks = 0; ks < TILE_DH / 16; ++ks)
    wgmma_kmajor<64>(d, a_desc(a + ks * 32), b + ks * 32, ks);
}

// x (64 x 64 fp32, the fragment) as the A registers of its four 16-column
// k-steps: one bf16 term, or (SPLIT) two, hi = bf16(x) and lo = bf16(x - hi)
template <bool SPLIT>
__device__ __forceinline__ void la_pack(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                        const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (SPLIT)
        split_pair(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      else
        hi[kk][r] = pack_f32(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
    }
}

// o += X B with X packed by la_pack (per k-step hi, then lo), B the 64 rows
// at `b` read N-major (row k of B = row k there); first: o = X B
template <bool SPLIT>
__device__ __forceinline__ void la_rs(float (&o)[32], const uint32_t (&hi)[4][4],
                                      const uint32_t (&lo)[4][4], const uint8_t* b, bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = b_desc(b + kk * 2048, TMA_BOX_BYTES);
    wgmma_rs64(o, hi[kk], db, first && kk == 0 ? 0 : 1);
    if constexpr (SPLIT) wgmma_rs64(o, lo[kk], db, 1);
  }
}

// rows r0 and r0 + 8 of the fragment o, times `mul`, as bf16 into `out` (row
// stride ld); rows >= S are not written
__device__ __forceinline__ void la_store(bf16* out, long long ld, const float (&o)[32], float mul,
                                         int r0, int S, int t) {
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    const int c = la_col(i, t);
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + r0 * ld + c) = pack_f32(o[i] * mul, o[i + 1] * mul);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (r0 + 8) * ld + c) =
          pack_f32(o[i + 2] * mul, o[i + 3] * mul);
  }
}

// The chunk loop of a pass with two accumulator sets: step(cur, nxt, c,
// more) for c = 0 .. nc - 1, sets a and b (a fragment, or a struct of
// them) taking turns as cur, `more` a compile-time bool: whether chunk c +
// 1 follows (its products are issued into nxt by the step). The last chunk
// is peeled off, so no product is issued on a path that depends on the
// data: ptxas would serialize every wgmma of the kernel otherwise.
template <class T, class F>
__device__ __forceinline__ void la_chunk_loop(T& a, T& b, int nc, F&& step) {
  int c = 0;
  for (; c + 2 < nc; c += 2) {
    step(a, b, c, std::true_type{});
    step(b, a, c + 1, std::true_type{});
  }
  if (c + 1 < nc) {
    step(a, b, c, std::true_type{});
    step(b, a, c + 1, std::false_type{});
  } else {
    step(a, b, c, std::false_type{});
  }
}

// The same with one accumulator set: step(c, more) in chunk order, the
// next chunk's products issued by the step when `more`
template <class F>
__device__ __forceinline__ void la_chunk_loop1(int nc, F&& step) {
  for (int c = 0; c + 1 < nc; ++c) step(c, std::true_type{});
  step(nc - 1, std::false_type{});
}

// f(mask) for the last chunk (mask: a compile-time bool, whether it holds
// rows >= S, tail its rows below S), f(false) for the others
template <class More, class F>
__device__ __forceinline__ void la_masked(More, int tail, F&& f) {
  if constexpr (More::value)
    f(std::false_type{});
  else if (tail < LA_CHUNK)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// Passes 1 and 2 of the warpgroup's 64 query rows (Q tile qt) over the nc
// key chunks of the ring: each row's max m over every key, then l = sum
// exp(s - m), per lane in key order, then the quad. Chunk c + 1's scores are
// issued before chunk c's are read (two accumulator sets), and a chunk's
// stage is released once its products are done.
__device__ __forceinline__ void la_stats(float (&m)[2], float (&l)[2], Ring& ring,
                                         const uint8_t* qt, int nc, int S, int lane) {
  const int t = lane & 3, tail = S - (nc - 1) * LA_CHUNK;
  float sa[32], sb[32];
  auto issue = [&](float (&d)[32]) {
    const int st = ring.take();
    wgmma_fence();
    la_ss(d, qt, ring.at(st));
    wgmma_commit();
    fence_regs<32>(d);
    return st;
  };
  auto scan = [&](auto&& f) {
    int st = issue(sa);
    la_chunk_loop(sa, sb, nc, [&](float (&cur)[32], float (&nxt)[32], int, auto more) {
      int next = -1;
      if constexpr (decltype(more)::value) {
        next = issue(nxt);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs<32>(cur);
      ring.release(st, lane);
      la_masked(more, tail, [&](auto mask) { f(cur, mask); });
      st = next;
    });
  };
  // the max of the raw scores, then scaled: 1/8 is a power of two and the
  // rounding monotone, so this is the max of the scaled scores
  float mx[2] = {-INFINITY, -INFINITY};
  scan([&](const float (&s)[32], auto mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (!decltype(mask)::value || la_col(i, t) < tail)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  });
  // the function's row max starts at -3e38 and takes the padded keys' -1e30
  const float pad = tail < LA_CHUNK ? NEG_INF : -3.0e38f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(fmaxf(__fmul_rn(la_quad_max(mx[r]), LA_SCALE), -3.0e38f), pad);
    l[r] = 0.0f;
  }
  // padded keys add exp(-1e30 - m) = 0: left out
  scan([&](const float (&s)[32], auto mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (!decltype(mask)::value || la_col(i, t) < tail)
        l[(i >> 1) & 1] += expf(__fsub_rn(__fmul_rn(s[i], LA_SCALE), m[(i >> 1) & 1]));
  });
  l[0] = la_quad_sum(l[0]);
  l[1] = la_quad_sum(l[1]);
}

// p = expf(s - m) / l of the fragment s in place: every a first, then the
// quotients (la_divide); padded keys (mask: columns >= tail) 0
template <class Mask>
__device__ __forceinline__ void la_probs_wg(float (&s)[32], const float (&m)[2],
                                            const float (&l)[2], const LaQuot (&q)[2], int t,
                                            int tail, Mask) {
  bool slow = l[0] > LA_QUOT_MAX_L || l[1] > LA_QUOT_MAX_L;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool live = !Mask::value || la_col(i, t) < tail;
    const float a = live ? la_exp(s[i], m[(i >> 1) & 1]) : 0.0f;
    slow |= live && a < LA_QUOT_MIN;
    s[i] = a;
  }
  la_divide(s, l, q, slow);
}

// The forward's pass 3 over the nc chunks of the ring (K and V): o = p v,
// p = expf(s - m) / l as one bf16 term or (SPLIT) two. Per chunk c: chunk c +
// 1's scores issued, chunk c's softmax, then (chunk c - 1's P V done) its P
// packed and its P V issued, in flight during chunk c + 1's softmax.
template <bool SPLIT>
__device__ __forceinline__ void la_fwd_pv(float (&o)[32], const float (&m)[2],
                                          const float (&l)[2], const LaQuot (&q)[2], Ring& ring,
                                          const uint8_t* qt, int nc, int S, int lane) {
  const int t = lane & 3, tail = S - (nc - 1) * LA_CHUNK;
  float sa[32], sb[32];
  uint32_t hi[4][4], lo[4][4];
  auto issue = [&](float (&d)[32]) {
    const int st = ring.take();
    wgmma_fence();
    la_ss(d, qt, ring.at(st));
    wgmma_commit();
    fence_regs<32>(d);
    return st;
  };
  int st = issue(sa), prev = -1;
  wgmma_commit();  // an empty group in the place of chunk -1's P V
  la_chunk_loop(sa, sb, nc, [&](float (&cur)[32], float (&nxt)[32], int c, auto more) {
    constexpr bool MORE = decltype(more)::value;
    int next = -1;
    if constexpr (MORE) {  // groups in flight: s(c), P V(c - 1), s(c + 1)
      next = issue(nxt);
      wgmma_wait<2>();
    } else {
      wgmma_wait<1>();
    }
    fence_regs<32>(cur);
    la_masked(more, tail, [&](auto mask) { la_probs_wg(cur, m, l, q, t, tail, mask); });
    if constexpr (MORE)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs<32>(o);
    fence_regs<4>(hi);
    if constexpr (SPLIT) fence_regs<4>(lo);
    if (prev >= 0) ring.release(prev, lane);
    la_pack<SPLIT>(hi, lo, cur);
    wgmma_fence();
    la_rs<SPLIT>(o, hi, lo, ring.at(st) + TMA_BOX_BYTES, c == 0);
    wgmma_commit();
    fence_regs<32>(o);
    prev = st;
    st = next;
  });
  wgmma_wait<0>();
  fence_regs<32>(o);
  fence_regs<4>(hi);
  if constexpr (SPLIT) fence_regs<4>(lo);
  ring.release(prev, lane);
}

// The forward: persistent blocks of LA_FWD_WG consumer warpgroups and a
// producer warp over items (image b, head h, group g of LA_FWD_WG 64-query
// tiles), item = (b H + h) ng + g; block i takes items i, i + gridDim.x, ...
// q, k, v through their maps as (columns, S rows, B images), head h at
// column qc (kc, vc) + 64 h; o rows of (b, h) at o + b obs + h 64 + r ots.
// SPLIT: flash (p in two terms); else the fused layer's stage (bf16(p)).
// Shared memory: two slots of the item's Q tiles, then the ring.
template <bool SPLIT>
__global__ void __launch_bounds__((LA_FWD_WG + 1) * 128, 1)
long_attention_fwd(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, int qc, int kc, int vc,
                   bf16* __restrict__ o, long long obs, long long ots, int S, int H, int items) {
  constexpr int WG = LA_FWD_WG;
  __shared__ uint64_t full[LA_FWD_STAGES], empty[LA_FWD_STAGES], qfull[2], qempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* qbuf = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, qbuf + 2 * WG * TMA_BOX_BYTES, LA_STAGE_BYTES, LA_FWD_STAGES, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK, ng = (nc + WG - 1) / WG;
  if (tid == 0) {
    ring_init(full, empty, LA_FWD_STAGES, WG * 4);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], WG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= WG * 4) {  // the producer warpgroup: one lane issues every load
    reg_dealloc<LA_PRODUCER_REGS>();
    if (warp == WG * 4 && lane == 0) {
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int g = item % ng, h = item / ng % H, b = item / ng / H;
        const int qs = n & 1, live = min(WG, nc - g * WG);  // Q tiles with a row below S
        mbar_wait(&qempty[qs], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[qs], live * TMA_BOX_BYTES);
        for (int w = 0; w < live; ++w)
          tma_load(qbuf + (qs * WG + w) * TMA_BOX_BYTES, &qmap, &qfull[qs], qc + h * TILE_DH,
                   (g * WG + w) * LA_CHUNK, b);
        for (int pass = 0; pass < 3; ++pass)
          for (int c = 0; c < nc; ++c) {  // K, and in pass 3 V beside it
            uint64_t* bar;
            uint8_t* st = ring.fill(pass < 2 ? TMA_BOX_BYTES : LA_STAGE_BYTES, &bar);
            tma_load(st, &kmap, bar, kc + h * TILE_DH, c * LA_CHUNK, b);
            if (pass == 2) tma_load(st + TMA_BOX_BYTES, &vmap, bar, vc + h * TILE_DH, c * LA_CHUNK, b);
          }
      }
    }
    return;
  }

  reg_alloc<la_consumer_regs(WG, 1)>();
  const int w = warp >> 2, t = lane & 3;
  const int lrow = (warp & 3) * 16 + (lane >> 2);
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int g = item % ng, h = item / ng % H, b = item / ng / H;
    const int qs = n & 1, tile = g * WG + w;
    if (WG > 1 && tile >= nc) {  // no row below S: keep pace with the ring
      for (int i = 0; i < 3 * nc; ++i) ring.release(ring.take(), lane);
      if (lane == 0) mbar_arrive(&qempty[qs]);
      continue;
    }
    mbar_wait(&qfull[qs], (n >> 1) & 1);
    const uint8_t* qt = qbuf + (qs * WG + w) * TMA_BOX_BYTES;
    float m[2], l[2], acc[32];
    la_stats(m, l, ring, qt, nc, S, lane);
    const LaQuot q[2] = {LaQuot(l[0]), LaQuot(l[1])};
    la_fwd_pv<SPLIT>(acc, m, l, q, ring, qt, nc, S, lane);
    if (lane == 0) mbar_arrive(&qempty[qs]);
    la_store(o + (long long)b * obs + h * TILE_DH, ots, acc, 1.0f, tile * LA_CHUNK + lrow, S, t);
  }
}

static size_t long_fwd_smem() {
  return 1024 + (size_t)(2 * LA_FWD_WG) * TMA_BOX_BYTES + (size_t)LA_FWD_STAGES * LA_STAGE_BYTES;
}

// Passes 3 and 4 for the warpgroup's 64 query rows (Q tile qt, dO tile ot)
// over the nc chunks of the ring (K and V): s = q k^T and dP = dO v^T on SS
// products, then per chunk
//   DQ false (pass 3): p; dot += dP p (per lane in key order); acc += bf16(p) v
//   DQ true  (pass 4): dS = p (dP - dot); acc += dS k
// with the next chunk's SS products issued right behind the RS product. The
// core: P and dS one bf16 term. SPLIT, the flash backward: dS in two terms,
// and its pass 3 forms no att, so no RS product (acc untouched).
template <bool DQ, bool SPLIT = false>
__device__ __forceinline__ void la_core_rows(float (&acc)[32], float (&dot)[2],
                                             const float (&m)[2], const float (&l)[2],
                                             const LaQuot (&q)[2], Ring& ring, const uint8_t* qt,
                                             const uint8_t* ot, int nc, int S, int lane) {
  const int t = lane & 3, tail = S - (nc - 1) * LA_CHUNK;
  float s[32], dp[32];
  uint32_t pa[4][4], pl[4][4];
  auto issue = [&]() {
    const int st = ring.take();
    wgmma_fence();
    la_ss(s, qt, ring.at(st));
    la_ss(dp, ot, ring.at(st) + TMA_BOX_BYTES);
    wgmma_commit();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    return st;
  };
  constexpr bool RS = DQ || !SPLIT;  // an RS product in this pass
  // what the products in flight may read or write besides s and dP
  auto fence_rs = [&]() {
    if constexpr (RS) {
      fence_regs<32>(acc);
      fence_regs<4>(pa);
    }
    if constexpr (RS && SPLIT) fence_regs<4>(pl);
  };
  if (!DQ) dot[0] = dot[1] = 0.0f;
  int st = issue(), prev = -1;
  la_chunk_loop1(nc, [&](int c, auto more) {
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    fence_rs();
    if (prev >= 0) ring.release(prev, lane);
    la_masked(more, tail, [&](auto mask) { la_probs_wg(s, m, l, q, t, tail, mask); });
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (DQ)
        s[i] = s[i] * (dp[i] - dot[(i >> 1) & 1]);
      else
        dot[(i >> 1) & 1] += dp[i] * s[i];
    }
    if constexpr (RS) {
      la_pack<SPLIT>(pa, pl, s);
      wgmma_fence();
      la_rs<SPLIT>(acc, pa, pl, ring.at(st) + (DQ ? 0 : TMA_BOX_BYTES), c == 0);
    }
    prev = st;
    if constexpr (decltype(more)::value)
      st = issue();
    else
      wgmma_commit();
    if constexpr (RS) fence_regs<32>(acc);
  });
  wgmma_wait<0>();
  fence_rs();
  ring.release(prev, lane);
  if (!DQ) {
    dot[0] = la_quad_sum(dot[0]);
    dot[1] = la_quad_sum(dot[1]);
  }
}

// one 64-query chunk's statistics in the key-major pass: each query's row
// max m, row sum l and rowsum(dP p), 64 floats each
struct LaStatRows {
  const float *m, *l, *d;
};

// The key-major pass for the warpgroup's 64 keys (K tile kt, V tile vt) over
// the nc query chunks of the ring (Q and dO): s^T = k q^T and dP^T = v dO^T
// on SS products, p and dS = p (dP - dot) from each column's query
// statistics (stats(c, stage): a LaStatRows; queries >= S: 0), then dV +=
// p^T dO and dK += dS^T q on RS products (the 16-query k-steps in order), P
// and dS one bf16 term (the core) or (SPLIT: flash) two, the next chunk's
// SS products issued once the RS products have read their A registers.
template <bool SPLIT, class Stats>
__device__ __forceinline__ void la_core_cols(float (&dk)[32], float (&dv)[32], Stats&& stats,
                                             Ring& ring, const uint8_t* kt, const uint8_t* vt,
                                             int nc, int S, int lane) {
  const int t = lane & 3, g = lane >> 2, tail = S - (nc - 1) * LA_CHUNK;
  float s[32], dp[32];
  uint32_t pa[4][4], pl[4][4], da[4][4], dl[4][4];
  auto issue = [&]() {
    const int st = ring.take();
    wgmma_fence();
    la_ss(s, kt, ring.at(st));
    la_ss(dp, vt, ring.at(st) + TMA_BOX_BYTES);
    wgmma_commit();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    return st;
  };
  auto fence_packed = [&]() {
    fence_regs<4>(pa);
    fence_regs<4>(da);
    if constexpr (SPLIT) {
      fence_regs<4>(pl);
      fence_regs<4>(dl);
    }
  };
  int st = issue(), prev = -1;
  la_chunk_loop1(nc, [&](int c, auto more) {
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    fence_regs<32>(dk);
    fence_regs<32>(dv);
    fence_packed();
    if (prev >= 0) ring.release(prev, lane);
    // register i: key row (i / 2) % 2, query column q0 + 8 (i / 4) + 2 t +
    // i % 2, whose statistics are the pair j = i / 4 at q0 + 8 j + 2 t
    const LaStatRows rows = stats(c, st);
    const float* st_m = rows.m + 2 * t;
    const float* st_l = rows.l + 2 * t;
    const float* st_d = rows.d + 2 * t;
    la_masked(more, tail, [&](auto mask) {
      auto live = [&](int i) { return !decltype(mask)::value || la_col(i, t) < tail; };
      // la_divide's rule for the warp: the IEEE division where an a falls
      // below LA_QUOT_MIN or a live column's l exceeds LA_QUOT_MAX_L, which
      // only the flash backward's S reaches (the core's S limit keeps l
      // below). The 8 lanes of a quad position t share their 16 columns:
      // lane 4 g + t reads the row sums of pair g (columns 8 g + 2 t, + 1)
      // and takes their reciprocals, the others read them by shuffle.
      float2 lg = make_float2(0.0f, 0.0f);
      bool slow = false;
      if constexpr (SPLIT) {
        lg = *reinterpret_cast<const float2*>(st_l + 8 * g);
        slow = (live(4 * g) && lg.x > LA_QUOT_MAX_L) || (live(4 * g + 1) && lg.y > LA_QUOT_MAX_L);
      }
#pragma unroll
      for (int j = 0; j < LA_CHUNK / 8; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(st_m + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float a = live(i) ? la_exp(s[i], e & 1 ? m2.y : m2.x) : 0.0f;
          slow |= live(i) && a < LA_QUOT_MIN;
          s[i] = a;
        }
      }
      // the quotients, then dS; a column past S reads no statistics of its
      // own: 0
      auto finish = [&](auto ieee) {
        float2 rg = make_float2(0.0f, 0.0f);
        if constexpr (!decltype(ieee)::value) {
          if constexpr (!SPLIT) lg = *reinterpret_cast<const float2*>(st_l + 8 * g);
          rg = make_float2(la_rcp(lg.x), la_rcp(lg.y));
        }
#pragma unroll
        for (int j = 0; j < LA_CHUNK / 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(st_l + 8 * j);
          const float2 d2 = *reinterpret_cast<const float2*>(st_d + 8 * j);
          float2 r2 = l2;
          if constexpr (!decltype(ieee)::value)
            r2 = make_float2(__shfl_sync(0xffffffffu, rg.x, 4 * j + t),
                             __shfl_sync(0xffffffffu, rg.y, 4 * j + t));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            const float l = e & 1 ? l2.y : l2.x;
            const float p = decltype(ieee)::value ? __fdiv_rn(s[i], l)
                                                  : la_quot(s[i], l, e & 1 ? r2.y : r2.x);
            s[i] = live(i) ? p : 0.0f;
            dp[i] = live(i) ? p * (dp[i] - (e & 1 ? d2.y : d2.x)) : 0.0f;
          }
        }
      };
      if (__any_sync(0xffffffffu, slow))
        finish(std::true_type{});
      else
        finish(std::false_type{});
    });
    la_pack<SPLIT>(pa, pl, s);
    la_pack<SPLIT>(da, dl, dp);
    wgmma_fence();
    la_rs<SPLIT>(dv, pa, pl, ring.at(st) + TMA_BOX_BYTES, c == 0);
    la_rs<SPLIT>(dk, da, dl, ring.at(st), c == 0);
    wgmma_commit();
    fence_regs<32>(dk);
    fence_regs<32>(dv);
    prev = st;
    if constexpr (decltype(more)::value) {  // the next chunk's products once A is read
      wgmma_wait<0>();
      fence_regs<32>(dk);
      fence_regs<32>(dv);
      fence_packed();
      st = issue();
    }
  });
  wgmma_wait<0>();
  fence_regs<32>(dk);
  fence_regs<32>(dv);
  fence_packed();
  ring.release(prev, lane);
}

// The fused block's backward core: one block per (image, head) (grid (H,
// B)), LA_CORE_WG consumer warpgroups and a producer warpgroup; qkv (B S, 3 D)
// and datt (B S, D) in through their maps as (columns, S rows, B images),
// att (B S, D) and dqkv (B S, 3 D) out. Phase 1 takes the query tiles in
// rounds of LA_CORE_WG (passes 1-4: att, dq, and each query's statistics
// into shared memory); phase 2 the key tiles (dk, dv), reading those
// statistics. Shared memory: two slots of each warpgroup's pair of tiles (Q
// and dO; K and V) in `slots` slots (2, or 1 where the statistics need the
// room), the ring of `stages`, the statistics.
__global__ void __launch_bounds__((LA_CORE_WG + 1) * 128, LA_CORE_MINB)
long_attention_bwd_kernel(const __grid_constant__ CUtensorMap qkv_map,
                          const __grid_constant__ CUtensorMap datt_map, bf16* __restrict__ att,
                          bf16* __restrict__ dqkv, int S, int D, int slots, int stages) {
  constexpr int WG = LA_CORE_WG;
  __shared__ uint64_t full[LA_CORE_STAGES], empty[LA_CORE_STAGES], tfull[2], tempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* tiles = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, tiles + slots * WG * LA_STAGE_BYTES, LA_STAGE_BYTES, stages, 0};
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK, rounds = (nc + WG - 1) / WG;
  float* rmax = reinterpret_cast<float*>(tiles + (size_t)(slots * WG + stages) * LA_STAGE_BYTES);
  float* rsum = rmax + nc * LA_CHUNK;
  float* rdot = rsum + nc * LA_CHUNK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y, qcol = h * TILE_DH;
  if (tid == 0) {
    ring_init(full, empty, stages, WG * 4);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&tfull[s], 1);
      mbar_init(&tempty[s], WG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= WG * 4) {  // the producer warpgroup: one lane issues every load
    reg_dealloc<LA_PRODUCER_REGS>();
    if (warp == WG * 4 && lane == 0)
      for (int r = 0; r < 2 * rounds; ++r) {
        const bool keys = r >= rounds;  // phase 2
        const int tile0 = (keys ? r - rounds : r) * WG, slot = r % slots;
        const int live = min(WG, nc - tile0);
        mbar_wait(&tempty[slot], ((r / slots) & 1) ^ 1);
        mbar_expect_tx(&tfull[slot], live * LA_STAGE_BYTES);
        for (int w = 0; w < live; ++w) {
          uint8_t* dst = tiles + (slot * WG + w) * LA_STAGE_BYTES;
          const int row = (tile0 + w) * LA_CHUNK;
          if (keys) {
            tma_load(dst, &qkv_map, &tfull[slot], D + qcol, row, b);
            tma_load(dst + TMA_BOX_BYTES, &qkv_map, &tfull[slot], 2 * D + qcol, row, b);
          } else {
            tma_load(dst, &qkv_map, &tfull[slot], qcol, row, b);
            tma_load(dst + TMA_BOX_BYTES, &datt_map, &tfull[slot], qcol, row, b);
          }
        }
        for (int pass = keys ? 3 : 0; pass < 4; ++pass)
          for (int c = 0; c < nc; ++c) {  // phase 1: K (and V in passes 3-4); phase 2: Q, dO
            uint64_t* bar;
            uint8_t* st = ring.fill(pass < 2 ? TMA_BOX_BYTES : LA_STAGE_BYTES, &bar);
            if (keys) {
              tma_load(st, &qkv_map, bar, qcol, c * LA_CHUNK, b);
              tma_load(st + TMA_BOX_BYTES, &datt_map, bar, qcol, c * LA_CHUNK, b);
            } else {
              tma_load(st, &qkv_map, bar, D + qcol, c * LA_CHUNK, b);
              if (pass >= 2)
                tma_load(st + TMA_BOX_BYTES, &qkv_map, bar, 2 * D + qcol, c * LA_CHUNK, b);
            }
          }
      }
    return;
  }

  reg_alloc<la_consumer_regs(WG, LA_CORE_MINB)>();
  const int w = warp >> 2, t = lane & 3;
  const int lrow = (warp & 3) * 16 + (lane >> 2);
  const long long ld = 3LL * D;
  bf16* dq = dqkv + (long long)b * S * ld + qcol;
  for (int r = 0; r < 2 * rounds; ++r) {
    const bool keys = r >= rounds;
    const int slot = r % slots, tile = (keys ? r - rounds : r) * WG + w;
    if (r == rounds) named_sync(1, WG * 128);  // every query's statistics written
    if (WG > 1 && tile >= nc) {  // no row below S: keep pace with the ring
      for (int i = 0; i < (keys ? 1 : 4) * nc; ++i) ring.release(ring.take(), lane);
      if (lane == 0) mbar_arrive(&tempty[slot]);
      continue;
    }
    mbar_wait(&tfull[slot], (r / slots) & 1);
    const uint8_t* ta = tiles + (slot * WG + w) * LA_STAGE_BYTES;
    const int row = tile * LA_CHUNK + lrow;
    if (!keys) {
      float m[2], l[2], dot[2], acc[32];
      la_stats(m, l, ring, ta, nc, S, lane);
      const LaQuot q[2] = {LaQuot(l[0]), LaQuot(l[1])};
      la_core_rows<false>(acc, dot, m, l, q, ring, ta, ta + TMA_BOX_BYTES, nc, S, lane);
      la_store(att + (long long)b * S * D + qcol, D, acc, 1.0f, row, S, t);
      la_core_rows<true>(acc, dot, m, l, q, ring, ta, ta + TMA_BOX_BYTES, nc, S, lane);
      if (lane == 0) mbar_arrive(&tempty[slot]);
      la_store(dq, ld, acc, LA_SCALE, row, S, t);
      if (t == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (row + 8 * i < S) {
            rmax[row + 8 * i] = m[i];
            rsum[row + 8 * i] = l[i];
            rdot[row + 8 * i] = dot[i];
          }
    } else {
      float dk[32], dv[32];
      la_core_cols<false>(
          dk, dv,
          [&](int c, int) {
            return LaStatRows{rmax + c * LA_CHUNK, rsum + c * LA_CHUNK, rdot + c * LA_CHUNK};
          },
          ring, ta, ta + TMA_BOX_BYTES, nc, S, lane);
      if (lane == 0) mbar_arrive(&tempty[slot]);
      la_store(dq + D, ld, dk, LA_SCALE, row, S, t);
      la_store(dq + 2 * D, ld, dv, 1.0f, row, S, t);
    }
  }
}

// the core's dynamic shared memory at S with `slots` tile slots and
// `stages` ring stages
static size_t long_core_smem(int S, int slots, int stages) {
  const size_t sp = (size_t)(S + LA_CHUNK - 1) / LA_CHUNK * LA_CHUNK;
  return 1024 + (size_t)(slots * LA_CORE_WG + stages) * LA_STAGE_BYTES + 3 * sp * sizeof(float);
}

// the core's (tile slots, ring stages) at S: two slots and LA_CORE_STAGES
// stages where they fit beside the statistics, then fewer stages down to 2,
// then one slot; false above long_core_max_seq()
static bool long_core_layout(int S, int* slots, int* stages) {
  for (*slots = 2; *slots >= 1; --*slots)
    for (*stages = LA_CORE_STAGES; *stages >= 2; --*stages)
      if (long_core_smem(S, *slots, *stages) <= LA_CORE_SMEM) return true;
  return false;
}

// the longest sequence the core takes: its statistics beside one tile slot
// and two stages
static int long_core_max_seq() {
  const long long room = LA_CORE_SMEM - (long long)long_core_smem(0, 1, 2);
  return (int)(room / (3 * (long long)sizeof(float)) / LA_CHUNK * LA_CHUNK);
}

// The flash backward's two launches. Launch 1 writes each query's
// statistics (m, l, rowsum(dP p)) to a workspace of three planes a 64-query
// chunk, (b H + h) nc + chunk, each plane 64 floats: a key-major ring stage
// takes a chunk's three in one bulk copy beside its Q and dO boxes.
#define LA_FBWD_STATS (3 * LA_CHUNK)                   // floats of one chunk's statistics
#define LA_FBWD_STATS_BYTES (LA_FBWD_STATS * 4)
#define LA_FBWD_COL_STAGE (LA_STAGE_BYTES + 1024)      // Q, dO, statistics; boxes 1024-aligned

// The flash backward, launch 1 (query-major): persistent blocks of
// LA_FBWD_WG consumer warpgroups and a producer warpgroup over items (image
// b, head h, group g of LA_FBWD_WG 64-query tiles), item = (b H + h) ng + g;
// block i takes items i, i + gridDim.x, ... Per query tile: passes 1-2
// (la_stats: m, l), then la_core_rows' pass 3 (dot) and pass 4 (dq += dS k,
// dS in two terms), the ring streaming K (passes 1-2), then K and V. q, k,
// v, dO through their maps as (columns, S rows, B images), head h at
// column 64 h; dq rows of (b, h) at dq + b obs + h 64 + r ots; the
// statistics of every row of the tile (rows >= S too: zeros in, finite
// out) into `ws`. Shared memory: two slots of the item's Q and dO tiles,
// then the ring.
__global__ void __launch_bounds__((LA_FBWD_WG + 1) * 128, LA_FBWD_MINB)
long_flash_bwd_rows(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, bf16* __restrict__ dq,
                    float* __restrict__ ws, long long obs, long long ots, int S, int H,
                    int items) {
  constexpr int WG = LA_FBWD_WG;
  __shared__ uint64_t full[LA_FBWD_STAGES], empty[LA_FBWD_STAGES], tfull[2], tempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* tiles = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, tiles + 2 * WG * LA_STAGE_BYTES, LA_STAGE_BYTES, LA_FBWD_STAGES, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK, ng = (nc + WG - 1) / WG;
  if (tid == 0) {
    ring_init(full, empty, LA_FBWD_STAGES, WG * 4);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&tfull[s], 1);
      mbar_init(&tempty[s], WG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= WG * 4) {  // the producer warpgroup: one lane issues every load
    reg_dealloc<LA_PRODUCER_REGS>();
    if (warp == WG * 4 && lane == 0) {
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int g = item % ng, h = item / ng % H, b = item / ng / H;
        const int ts = n & 1, live = min(WG, nc - g * WG);  // tiles with a row below S
        mbar_wait(&tempty[ts], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&tfull[ts], live * LA_STAGE_BYTES);
        for (int w = 0; w < live; ++w) {
          uint8_t* dst = tiles + (ts * WG + w) * LA_STAGE_BYTES;
          tma_load(dst, &qmap, &tfull[ts], h * TILE_DH, (g * WG + w) * LA_CHUNK, b);
          tma_load(dst + TMA_BOX_BYTES, &omap, &tfull[ts], h * TILE_DH, (g * WG + w) * LA_CHUNK,
                   b);
        }
        for (int pass = 0; pass < 4; ++pass)
          for (int c = 0; c < nc; ++c) {  // K, and in passes 3-4 V beside it
            uint64_t* bar;
            uint8_t* st = ring.fill(pass < 2 ? TMA_BOX_BYTES : LA_STAGE_BYTES, &bar);
            tma_load(st, &kmap, bar, h * TILE_DH, c * LA_CHUNK, b);
            if (pass >= 2) tma_load(st + TMA_BOX_BYTES, &vmap, bar, h * TILE_DH, c * LA_CHUNK, b);
          }
      }
    }
    return;
  }

  reg_alloc<la_consumer_regs(WG, LA_FBWD_MINB)>();
  const int w = warp >> 2, t = lane & 3;
  const int lrow = (warp & 3) * 16 + (lane >> 2);
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int g = item % ng, h = item / ng % H, b = item / ng / H;
    const int ts = n & 1, tile = g * WG + w;
    if (WG > 1 && tile >= nc) {  // no row below S: keep pace with the ring
      for (int i = 0; i < 4 * nc; ++i) ring.release(ring.take(), lane);
      if (lane == 0) mbar_arrive(&tempty[ts]);
      continue;
    }
    mbar_wait(&tfull[ts], (n >> 1) & 1);
    const uint8_t* qt = tiles + (ts * WG + w) * LA_STAGE_BYTES;
    float m[2], l[2], dot[2], acc[32];
    la_stats(m, l, ring, qt, nc, S, lane);
    const LaQuot q[2] = {LaQuot(l[0]), LaQuot(l[1])};
    la_core_rows<false, true>(acc, dot, m, l, q, ring, qt, qt + TMA_BOX_BYTES, nc, S, lane);
    la_core_rows<true, true>(acc, dot, m, l, q, ring, qt, qt + TMA_BOX_BYTES, nc, S, lane);
    if (lane == 0) mbar_arrive(&tempty[ts]);
    la_store(dq + (long long)b * obs + h * TILE_DH, ots, acc, LA_SCALE, tile * LA_CHUNK + lrow, S,
             t);
    if (t == 0) {
      float* st = ws + ((long long)(b * H + h) * nc + tile) * LA_FBWD_STATS;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        st[lrow + 8 * i] = m[i];
        st[LA_CHUNK + lrow + 8 * i] = l[i];
        st[2 * LA_CHUNK + lrow + 8 * i] = dot[i];
      }
    }
  }
}

// The flash backward, launch 2 (key-major): launch 1's items with key tiles
// in the place of query tiles. Per key tile (K and V in a slot), la_core_cols
// over every query chunk of the ring (Q, dO and the chunk's statistics from
// `ws`): dv = p^T dO, dk = dS^T q / 8, P and dS in two terms. dk, dv rows as
// launch 1's dq.
__global__ void __launch_bounds__((LA_FBWD_WG + 1) * 128, LA_FBWD_MINB)
long_flash_bwd_cols(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, const float* __restrict__ ws,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, long long obs, long long ots,
                    int S, int H, int items) {
  constexpr int WG = LA_FBWD_WG;
  __shared__ uint64_t full[LA_FBWD_STAGES], empty[LA_FBWD_STAGES], tfull[2], tempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* tiles = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, tiles + 2 * WG * LA_STAGE_BYTES, LA_FBWD_COL_STAGE, LA_FBWD_STAGES, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK, ng = (nc + WG - 1) / WG;
  if (tid == 0) {
    ring_init(full, empty, LA_FBWD_STAGES, WG * 4);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&tfull[s], 1);
      mbar_init(&tempty[s], WG * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= WG * 4) {  // the producer warpgroup: one lane issues every load
    reg_dealloc<LA_PRODUCER_REGS>();
    if (warp == WG * 4 && lane == 0) {
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int g = item % ng, h = item / ng % H, b = item / ng / H;
        const int ts = n & 1, live = min(WG, nc - g * WG);
        mbar_wait(&tempty[ts], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&tfull[ts], live * LA_STAGE_BYTES);
        for (int w = 0; w < live; ++w) {
          uint8_t* dst = tiles + (ts * WG + w) * LA_STAGE_BYTES;
          tma_load(dst, &kmap, &tfull[ts], h * TILE_DH, (g * WG + w) * LA_CHUNK, b);
          tma_load(dst + TMA_BOX_BYTES, &vmap, &tfull[ts], h * TILE_DH, (g * WG + w) * LA_CHUNK,
                   b);
        }
        const float* head = ws + (long long)(b * H + h) * nc * LA_FBWD_STATS;
        for (int c = 0; c < nc; ++c) {  // Q, dO and the statistics of query chunk c
          uint64_t* bar;
          uint8_t* st = ring.fill(LA_STAGE_BYTES + LA_FBWD_STATS_BYTES, &bar);
          tma_load(st, &qmap, bar, h * TILE_DH, c * LA_CHUNK, b);
          tma_load(st + TMA_BOX_BYTES, &omap, bar, h * TILE_DH, c * LA_CHUNK, b);
          bulk_load(st + LA_STAGE_BYTES, head + (long long)c * LA_FBWD_STATS, LA_FBWD_STATS_BYTES,
                    bar);
        }
      }
    }
    return;
  }

  reg_alloc<la_consumer_regs(WG, LA_FBWD_MINB)>();
  const int w = warp >> 2, t = lane & 3;
  const int lrow = (warp & 3) * 16 + (lane >> 2);
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int g = item % ng, h = item / ng % H, b = item / ng / H;
    const int ts = n & 1, tile = g * WG + w;
    if (WG > 1 && tile >= nc) {  // no row below S: keep pace with the ring
      for (int i = 0; i < nc; ++i) ring.release(ring.take(), lane);
      if (lane == 0) mbar_arrive(&tempty[ts]);
      continue;
    }
    mbar_wait(&tfull[ts], (n >> 1) & 1);
    const uint8_t* kt = tiles + (ts * WG + w) * LA_STAGE_BYTES;
    float ak[32], av[32];
    la_core_cols<true>(
        ak, av,
        [&](int, int st) {
          const float* p = reinterpret_cast<const float*>(ring.at(st) + LA_STAGE_BYTES);
          return LaStatRows{p, p + LA_CHUNK, p + 2 * LA_CHUNK};
        },
        ring, kt, kt + TMA_BOX_BYTES, nc, S, lane);
    if (lane == 0) mbar_arrive(&tempty[ts]);
    const long long head = (long long)b * obs + h * TILE_DH;
    la_store(dk + head, ots, ak, LA_SCALE, tile * LA_CHUNK + lrow, S, t);
    la_store(dv + head, ots, av, 1.0f, tile * LA_CHUNK + lrow, S, t);
  }
}

// the flash backward's dynamic shared memory: two slots of LA_FBWD_WG tile
// pairs, then the ring of stages of `stage_bytes`
static size_t long_flash_bwd_smem(int stage_bytes) {
  return 1024 + (size_t)(2 * LA_FBWD_WG) * LA_STAGE_BYTES + (size_t)LA_FBWD_STAGES * stage_bytes;
}

// floats of the flash backward's statistics workspace
static long long long_flash_bwd_ws_floats(int B, int S, int H) {
  return (long long)B * H * ((S + LA_CHUNK - 1) / LA_CHUNK) * LA_FBWD_STATS;
}

// s = q k^T and st = k q^T for one 64 x 64 pair of tiles by one warpgroup,
// both through la_ss as the routes take them (the core's query passes and
// its key-major phase): whether the two orders of the operands give the same
// bits. q, k: 64 x 64 bf16 row-major; s, st: 64 x 64 fp32 row-major.
__global__ void __launch_bounds__(128) long_scores_probe(const bf16* __restrict__ q,
                                                         const bf16* __restrict__ k,
                                                         float* __restrict__ s,
                                                         float* __restrict__ st) {
  extern __shared__ uint8_t raw[];
  uint8_t* qt = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint8_t* kt = qt + TMA_BOX_BYTES;
  for (int i = threadIdx.x; i < 64 * 8; i += 128) {  // 16-byte pieces, swizzled as TMA writes them
    const int r = i / 8, c = (i % 8) * 8;
    *reinterpret_cast<uint4*>(qt + sw128(r, c)) = *reinterpret_cast<const uint4*>(q + r * 64 + c);
    *reinterpret_cast<uint4*>(kt + sw128(r, c)) = *reinterpret_cast<const uint4*>(k + r * 64 + c);
  }
  fence_async_smem();
  __syncthreads();
  float a[32], bt[32];
  wgmma_fence();
  la_ss(a, qt, kt);
  la_ss(bt, kt, qt);
  wgmma_commit();
  fence_regs<32>(a);
  fence_regs<32>(bt);
  wgmma_wait<0>();
  fence_regs<32>(a);
  fence_regs<32>(bt);
  const int lane = threadIdx.x & 31, t = lane & 3, r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = r0 + 8 * ((i >> 1) & 1), c = la_col(i, t);
    s[r * 64 + c] = a[i];
    st[r * 64 + c] = bt[i];
  }
}

// la_quot (through LaQuot, as the routes take it) against __fdiv_rn on n
// pseudo-random pairs and the edges: a in [0, 1] with every exponent, the
// subnormals too, l in [1, LA_QUOT_MAX_L] with every exponent. counts[0]
// the pairs with a >= LA_QUOT_MIN or a = 0 (the routes' range) whose bits
// differ, counts[1] those pairs; counts[2], counts[3] the same below it.
#define LA_PROBE_EDGES_A 9
#define LA_PROBE_EDGES_L 12
__global__ void long_quotient_probe(unsigned long long n, unsigned long long* counts) {
  const float edge_a[LA_PROBE_EDGES_A] = {0.0f, 1.4e-45f, 1.17549435e-38f, 7.88860905e-31f,
                                          7.8886084e-31f, 1.0e-10f, 0.5f, 0.99999994f, 1.0f};
  const float edge_l[LA_PROBE_EDGES_L] = {1.0f,     1.00000012f, 2.0f,     3.0f,
                                          7.0f,     577.0f,      1024.00012f, 13056.0f,
                                          15168.0f, 32768.0f,    65535.996f, 65536.0f};
  unsigned long long mine[4] = {0, 0, 0, 0};
  const unsigned long long total = n + LA_PROBE_EDGES_A * LA_PROBE_EDGES_L;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < total; i += (unsigned long long)gridDim.x * blockDim.x) {
    float a, l;
    if (i < n) {  // splitmix64 of the index: a's biased exponent 0 .. 126 and mantissa; l's
      unsigned long long z = (i + 1) * 0x9E3779B97F4A7C15ull;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      z ^= z >> 31;
      const unsigned exp_bits = (unsigned)(z % 127), mant = (unsigned)(z >> 8) & 0x7FFFFFu;
      a = __uint_as_float((exp_bits << 23) | mant);
      l = ldexpf(1.0f + (float)(unsigned)((z >> 40) & 0x7FFFFFu) * (1.0f / 8388608.0f),
                 (int)((z >> 36) & 15u));  // [1, 2^16): exponent 0 .. 15, a random mantissa
    } else {
      const int e = (int)(i - n);
      a = edge_a[e / LA_PROBE_EDGES_L];
      l = edge_l[e % LA_PROBE_EDGES_L];
    }
    const bool in_range = a == 0.0f || a >= LA_QUOT_MIN;
    const bool differ = __float_as_uint(LaQuot(l)(a)) != __float_as_uint(__fdiv_rn(a, l));
    mine[in_range ? 0 : 2] += differ;
    mine[in_range ? 1 : 3] += 1;
  }
  for (int k = 0; k < 4; ++k) {
    unsigned long long v = mine[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(&counts[k], v);
  }
}

// ---------------------------------------------------------------------------
// Host launches, on the caller's stream
// ---------------------------------------------------------------------------

template <class K>
static int la_set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// a persistent launch's blocks: as many of `kernel` at `threads` and `smem`
// as the card holds at once (found once into `per_card`: the same for
// every card of the build), never more than `items`
template <class K>
static int la_persistent_grid(K kernel, int threads, size_t smem, int items, int& per_card,
                              int* grid) {
  LAUNCH(la_set_smem(kernel, smem));
  if (per_card == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    LAUNCH((int)cudaGetDevice(&dev));
    LAUNCH((int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    LAUNCH((int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem));
    per_card = (per_sm > 0 ? per_sm : 1) * sms;
  }
  *grid = items < per_card ? items : per_card;
  return 0;
}

// o = softmax(q k^T / 8) v over B images x H heads of S tokens, q, k and v
// read through their maps as (columns, S rows, B images), head h at column
// qc (kc, vc) + 64 h; SPLIT: p in fp32 (flash), else bf16(p) (the fused
// layer). Persistent: as many blocks as the card holds, never more than items.
template <bool SPLIT>
static int launch_long_attention_fwd(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                     const CUtensorMap& vmap, int qc, int kc, int vc, bf16* o,
                                     long long obs, long long ots, int B, int S, int H,
                                     cudaStream_t st) {
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK;
  const int items = B * H * ((nc + LA_FWD_WG - 1) / LA_FWD_WG);
  const int threads = (LA_FWD_WG + 1) * 128;
  const size_t smem = long_fwd_smem();
  static int per_card = 0;
  int grid;
  LAUNCH(la_persistent_grid(long_attention_fwd<SPLIT>, threads, smem, items, per_card, &grid));
  long_attention_fwd<SPLIT><<<grid, threads, smem, st>>>(qmap, kmap, vmap, qc, kc, vc, o, obs,
                                                         ots, S, H, items);
  return (int)cudaGetLastError();
}

// the flash forward above 256 keys: q, k, v (B, S, H, 64) through (bs, ts)
// strides (ts and, for B > 1, bs multiples of 8), o contiguous
static int launch_long_flash_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                                 long long bs, long long ts, int B, int S, int H,
                                 cudaStream_t st) {
  const uint64_t cols = (uint64_t)H * TILE_DH, lay = B > 1 ? bs : (long long)S * ts;
  CUtensorMap qm, km, vm;
  LAUNCH(tensor_map_strided(&qm, q, cols, S, B, ts, lay));
  LAUNCH(tensor_map_strided(&km, k, cols, S, B, ts, lay));
  LAUNCH(tensor_map_strided(&vm, v, cols, S, B, ts, lay));
  return launch_long_attention_fwd<true>(qm, km, vm, 0, 0, 0, o, (long long)S * cols, cols, B, S,
                                         H, st);
}

// the flash backward above 256 keys: dq, dk, dv contiguous (B, S, H, 64)
// from q, k, v (as launch_long_flash_fwd takes them) and a contiguous dout,
// two persistent launches; ws: long_flash_bwd_ws_floats(B, S, H) floats
static int launch_long_flash_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                                 bf16* dq, bf16* dk, bf16* dv, float* ws, long long bs,
                                 long long ts, int B, int S, int H, cudaStream_t st) {
  const uint64_t cols = (uint64_t)H * TILE_DH, lay = B > 1 ? bs : (long long)S * ts;
  CUtensorMap qm, km, vm, om;
  LAUNCH(tensor_map_strided(&qm, q, cols, S, B, ts, lay));
  LAUNCH(tensor_map_strided(&km, k, cols, S, B, ts, lay));
  LAUNCH(tensor_map_strided(&vm, v, cols, S, B, ts, lay));
  LAUNCH(tensor_map(&om, dout, cols, S, B));
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK;
  const int items = B * H * ((nc + LA_FBWD_WG - 1) / LA_FBWD_WG);
  const int threads = (LA_FBWD_WG + 1) * 128;
  const long long obs = (long long)S * cols;
  static int rows_per_card = 0, cols_per_card = 0;
  int grid;
  const size_t smem_rows = long_flash_bwd_smem(LA_STAGE_BYTES);
  LAUNCH(la_persistent_grid(long_flash_bwd_rows, threads, smem_rows, items, rows_per_card, &grid));
  long_flash_bwd_rows<<<grid, threads, smem_rows, st>>>(qm, km, vm, om, dq, ws, obs, cols, S, H,
                                                        items);
  LAUNCH((int)cudaGetLastError());
  const size_t smem_cols = long_flash_bwd_smem(LA_FBWD_COL_STAGE);
  LAUNCH(la_persistent_grid(long_flash_bwd_cols, threads, smem_cols, items, cols_per_card, &grid));
  long_flash_bwd_cols<<<grid, threads, smem_cols, st>>>(qm, km, vm, om, ws, dk, dv, obs, cols, S,
                                                        H, items);
  return (int)cudaGetLastError();
}

// the fused block's forward stage: att (B S, D) from qkv (B S, 3 D), qkv
// through its map as (3 D columns, S rows, B images)
static int launch_long_attention_stage(const CUtensorMap& qkv_map, bf16* att, int B, int S, int H,
                                       int D, cudaStream_t st) {
  return launch_long_attention_fwd<false>(qkv_map, qkv_map, qkv_map, 0, D, 2 * D, att,
                                          (long long)S * D, D, B, S, H, st);
}

// the fused block's backward core: att and dqkv from qkv and datt, one launch
static int launch_long_attention_bwd(const bf16* qkv, const bf16* datt, bf16* att, bf16* dqkv,
                                     int B, int S, int H, int D, cudaStream_t st) {
  int slots, stages;
  if (!long_core_layout(S, &slots, &stages)) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, om;
  LAUNCH(tensor_map(&qm, qkv, 3 * D, S, B));
  LAUNCH(tensor_map(&om, datt, D, S, B));
  const size_t smem = long_core_smem(S, slots, stages);
  LAUNCH(la_set_smem(long_attention_bwd_kernel, smem));
  long_attention_bwd_kernel<<<dim3(H, B), (LA_CORE_WG + 1) * 128, smem, st>>>(qm, om, att, dqkv,
                                                                               S, D, slots, stages);
  return (int)cudaGetLastError();
}

// long_scores_probe on one pair of 64 x 64 bf16 tiles
static int launch_long_scores_probe(const bf16* q, const bf16* k, float* s, float* st,
                                    cudaStream_t stream) {
  long_scores_probe<<<1, 128, 1024 + 2 * TMA_BOX_BYTES, stream>>>(q, k, s, st);
  return (int)cudaGetLastError();
}

// long_quotient_probe over n pairs; counts: 4 zeroed integers
static int launch_long_quotient_probe(unsigned long long n, unsigned long long* counts,
                                      cudaStream_t stream) {
  long_quotient_probe<<<1056, 256, 0, stream>>>(n, counts);
  return (int)cudaGetLastError();
}
