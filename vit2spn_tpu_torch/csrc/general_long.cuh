// Attention above 256 tokens at head_dim 16, 32 and 48, and at every S at
// head_dim 80 (common.cuh streamed_head_dim: ViT-Huge/14, which has no
// register-row kernels), for Hopper (sm_90a), bf16 in and out: the S > 256
// route of the general geometry (common.cuh general_route), behind the same
// four bf16 attention functions as csrc/long_attention.cuh, whose routes are
// written for head_dim 64:
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
// only once the row's max and sum over every key are known (no running max,
// no rescaled sum): several passes over the keys, the scores recomputed in
// each.
//
// All four are long_attention.cuh's wgmma / TMA design on the head_dim
// (the gw_ helpers below, its la_ helpers where nothing depends on the
// head_dim): a warpgroup owns 64 rows; the scores and dP are SS products
// over DH / 16 k-steps of 16, P and dS are packed from the accumulator
// registers into the A registers of RS products whose N is DH (o, att, dQ,
// dK, dV: DH / 2 accumulator registers a thread), in one bf16 term or, in
// the flash pair, two (la_pack<true> / gw_pack<KS, true>: per 16-wide
// k-step hi, then lo); the operands arrive by TMA through a ring of 64-row
// chunks kept in flight by one lane of a producer warpgroup that gives its
// registers to the consumers (setmaxnreg); the forward's passes and every
// statistics pass issue chunk c + 1's scores before chunk c's softmax (two
// accumulator sets); the quotient is la_quot (three branch-free
// instructions with the IEEE division's bits, __fdiv_rn for a warp whose
// chunk holds an a below 2^-100 or an l above 2^16). The forward runs
// persistent blocks of GL_FWD_WG consumer warpgroups over (image, head,
// GL_FWD_WG query tiles) items; the core one block per (image, head),
// gl_core_minb blocks an SM (two; one at 80), its rows phase (passes 1-4:
// m, l, then dot = rowsum(dP p) with att, then dQ) and its cols phase (per
// 64 keys every query chunk: s^T = k q^T and dP^T from each query's
// statistics in shared memory, dV and dK) in ONE launch, so the layer
// backward's launch count does not change with S. The flash backward is
// long_attention.cuh's two persistent launches on the head_dim: the rows
// launch (gl_flash_rows_kernel: passes 1-2, then the core's passes 3-4
// with dS in two terms and no att) writes each query's m, l and dot to the
// workspace in 64-query chunk planes (LA_FBWD_STATS floats a chunk,
// vit2spn_flash_bwd_workspace_floats); the cols launch
// (gl_flash_cols_kernel: the core's cols phase with P and dS in two terms)
// takes a chunk's statistics by one bulk copy in the ring stage beside its
// Q and dO boxes, so S is not bounded by shared memory. Both run one
// consumer warpgroup a block (a second, swept, was slower at head_dim 16-48
// and 12% faster only at 80, S = 577), GL_FBWD_STAGES ring stages,
// gl_fbwd_minb blocks an SM (two, 232 registers, at head_dim 16-48; one,
// 240, at 80, where two slots of 32 KB tile pairs and the ring leave room
// for one block anyway).
//
// A row of a head is DH bf16: 32, 64, 96 or 160 bytes, and TMA and wgmma
// have no swizzle for 96 or 160. So every operand is read as 64-row tiles
// of GwShape<DH>::SLABS 64-column slabs in the 128-byte swizzle (one at
// head_dim 16-48, two at 80), through a 4-D tensor map (DH values, heads,
// S rows, B images) whose box (64 values, one head, 64 rows, one image) is
// wider than the head: TMA writes zeros past DH (and past S) and fetches
// nothing for them. The products read only the head's columns: the scores'
// k-steps stop at DH (at 80, four in slab 0 and one in slab 1) and the RS
// products take N = DH across the slabs (the descriptor's leading offset
// steps from slab 0 to slab 1). A head_dim-16-48 tile is the head_dim-64
// route's 8 KB, so the core keeps its S limit, long_core_max_seq() =
// 15,168; at 80 a tile is 16 KB and the statistics beside one tile slot and
// two ring stages leave room for 11,072 queries (gl_core_max_seq).
//
// Orders of the sums, fixed, so that two runs give the same bits, and those
// of the mma.sync kernels these replace: the wgmma accumulator has the
// m16n8 fragment positions (register i: row (i / 2) % 2 of the thread's two,
// column 8 (i / 4) + 2 t + i % 2), so l and dot sum per lane over its keys
// 8 j + 2 t, 8 j + 2 t + 1 in ascending order across every chunk, then the
// quad's shuffles (xor 1, then xor 2); the scores over head_dim in k-steps
// of 16; o, att and dQ over 16-key k-steps in ascending order, dK and dV
// over 16-query k-steps in ascending order, hi before lo where a term is
// split (on the card every output equals the mma.sync kernels' bit for
// bit: tools/gl_long_sweep.py --parent). Both phases of the core and the
// stage form the same p, so the core's att equals the stage's bit for bit.
//
// What bounds it on this card: at ViT-Tiny's width at 384 px (S = 577, B =
// 64) the products are 2 S^2 dh a (image, head) each (2 in the forward, 6
// in the core, 5 in the flash backward, its P and dS products twice), which
// leaves the CUDA cores' work per score and pass (a scale, a subtraction,
// an expf, the quotient, the hi / lo splits) in front at head_dim 16-48.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (tools/gl_long_sweep.py)
// at that shape: the stage 0.5763 / 0.3137 / 0.2234 ms at head_dim 16 / 32
// / 48 (2.9-7.6% of its bound, ~2.6x bf16 SDPA), the core 1.3929 / 0.9660 /
// 0.5758 ms (3.6-8.6%), the flash backward 1.3873 / 0.7637 / 0.5812 ms
// (3.0-7.1%; the mma.sync kernels 1.7395 / 1.1763 / 0.9888); at ViT-Huge/14
// (B = 64, S = 257) 0.3258, 1.4012 and 1.0757 ms (1.9646). A forward that
// kept each exp(s - m) of pass 2 would save at most what GL_ONE_PASS_PROBE
// measures (18-31% of the stage). Why the S <= 256 kernels keep S <= 256:
// tools/gl_short_probe.py times these at S = 197 beside them. Limits: head
// dim 16, 32, 48 or 80; rows 16-byte aligned.

#pragma once

#include "common.cuh"
#include "long_attention.cuh"  // Ring, la_quot / la_divide, the chunk loops, split_pair

// ---------------------------------------------------------------------------
// Fragment helpers of csrc/flash_attention.cu's S <= 256 kernels (mma.sync)
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
// The wgmma routes: the forward (stage and flash) and the fused backward core
// ---------------------------------------------------------------------------

#ifndef GL_FWD_WG
#define GL_FWD_WG 2  // the forward's consumer warpgroups: one 64-query tile each
#endif
#ifndef GL_FWD_RING
#define GL_FWD_RING 0  // the forward's ring stages; 0: gl_fwd_stages' default
#endif
#ifndef GL_CORE_MINB
#define GL_CORE_MINB 0  // the core's blocks an SM; 0: gl_core_minb's default
#endif
#ifndef GL_CORE_STAGES
#define GL_CORE_STAGES 4  // the core's ring, where the statistics leave the room (at least 2)
#endif
// tools/gl_long_sweep.py's probe of a one-pass forward: 1 takes the
// forward's pass-3 p from the raw score without its scale, subtraction and
// expf, as if a pass-2 store had kept each a (the bits are then wrong: a
// measurement only)
#ifndef GL_ONE_PASS_PROBE
#define GL_ONE_PASS_PROBE 0
#endif
#define GL_CORE_WG 1  // the core's consumer warpgroups

// a 64-row tile of one operand at head_dim DH in 64-column slabs
template <int DH>
struct GwShape {
  static_assert(DH % 16 == 0 && DH <= 128, "head_dim a multiple of 16 up to 128");
  static constexpr int SLABS = (DH + 63) / 64;
  static constexpr int TILE = SLABS * TMA_BOX_BYTES;  // one operand's tile, bytes
  static constexpr int STAGE = 2 * TILE;              // a ring stage or a tile slot: two operands
  static constexpr int ACC = DH / 2;                  // a 64 x DH fp32 fragment's registers a thread
};

// the forward's ring: 16 KB stages up to head_dim 48, 32 KB at 80
template <int DH>
__host__ __device__ constexpr int gl_fwd_stages() {
  return GL_FWD_RING ? GL_FWD_RING : DH > 64 ? 4 : 6;
}
// the core's blocks an SM, which set its consumers' registers: two (232
// registers) up to head_dim 48; one (240) at 80, whose cols phase holds dK
// and dV at N = 80 beside the scores and spilled at two
template <int DH>
__host__ __device__ constexpr int gl_core_minb() {
  return GL_CORE_MINB ? GL_CORE_MINB : DH > 64 ? 1 : 2;
}
// the core's dynamic shared memory that leaves room for gl_core_minb blocks
// an SM (228 KB, 1 KB of it the system's a block, and the static mbarriers)
template <int DH>
__host__ __device__ constexpr int gl_core_shared_smem() {
  return 233472 / gl_core_minb<DH>() - 1024 - 256;
}

// Host: the 4-D map (DH values, `heads`, S rows, B images) over bf16 rows,
// head j of row s of image b at base + b lay + s ts + j DH (elements; ts and
// lay multiples of 8), read in boxes of 64 values x 1 head x 64 rows x 1
// image with the 128-byte swizzle: values past DH and rows past S read as
// zeros.
static int gw_tensor_map(CUtensorMap* map, const void* base, int dh, int heads, int S, int B,
                         long long ts, long long lay) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return (int)cudaErrorSharedObjectInitFailed;
  static thread_local bool bound = false;  // a current context for the driver call (hopper.cuh)
  if (!bound) {
    LAUNCH((int)cudaFree(nullptr));
    bound = true;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)ts * 2, (cuuint64_t)lay * 2};
  const cuuint32_t box[4] = {TMA_BOX, 1, TMA_BOX, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) return 0;
  fprintf(stderr, "vit2spn: cuTensorMapEncodeTiled: %d at %p, %d x %d heads x %d x %d\n", (int)r,
          base, dh, heads, S, B);
  return (int)cudaErrorInvalidValue;
}

// the box at (value c0, head c1, row c2, image c3) into `dst`, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the 64-row tile of head `head` from row `row` of image b: its slabs
template <int DH>
__device__ __forceinline__ void gw_load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                        int head, int row, int b) {
#pragma unroll
  for (int s = 0; s < GwShape<DH>::SLABS; ++s)
    tma_load4(dst + s * TMA_BOX_BYTES, map, bar, 64 * s, head, row, b);
}

// d (64 x N fp32, N <= 64) = A B^T over head_dim, A the 64 rows of tile a,
// B the N rows of tile b from row `b` on, the DH / 16 k-steps in order;
// issued, not waited for. One descriptor a tile, each k-step's offset added
// to its address field (16-byte units, no carry below 256 KB): one live
// descriptor an operand, not one a k-step (at head_dim 80 the core spilled
// with ten)
template <int DH, int N = 64>
__device__ __forceinline__ void gw_ss(float (&d)[N / 2], const uint8_t* a, const uint8_t* b) {
  const uint64_t da = a_desc(a), db = k_desc(b);
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const int off = (ks / 4 * TMA_BOX_BYTES + ks % 4 * 32) >> 4;
    Wgmma<N>::template mma<0, 0, 0>(d, da + off, db + off, ks);
  }
}

// d (64 x N fp32) = A B (+ d when acc != 0), A from registers as
// wgmma_rs64 takes it, B N-major (b_desc) across the slabs
template <int N> struct GwRs;
template <> struct GwRs<16> {
  __device__ __forceinline__ static void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};
template <> struct GwRs<32> {
  __device__ __forceinline__ static void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};
template <> struct GwRs<48> {
  __device__ __forceinline__ static void mma(float (&d)[24], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};
template <> struct GwRs<80> {
  __device__ __forceinline__ static void mma(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
};

// o += X B with X packed by la_pack (per 16-key k-step hi, then with SPLIT
// lo), B the KS 16-row k-steps of the tile at `b` read N-major (row k of B
// = row k there), N = DH; first: o = X B
template <int DH, bool SPLIT, int KS = 4>
__device__ __forceinline__ void gw_rs(float (&o)[DH / 2], const uint32_t (&hi)[KS][4],
                                      const uint32_t (&lo)[KS][4], const uint8_t* b, bool first) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t db = b_desc(b + kk * 2048, TMA_BOX_BYTES);
    GwRs<DH>::mma(o, hi[kk], db, first && kk == 0 ? 0 : 1);
    if constexpr (SPLIT) GwRs<DH>::mma(o, lo[kk], db, 1);
  }
}

// x (64 x 16 KS fp32, the fragment) in the A registers of its KS 16-column
// k-steps, as la_pack: one bf16 term, or (SPLIT) two
template <int KS, bool SPLIT>
__device__ __forceinline__ void gw_pack(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4],
                                        const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (SPLIT)
        split_pair(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
      else
        hi[kk][r] = pack_f32(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
    }
}

// rows r0 and r0 + 8 of the 64 x DH fragment o, times `mul`, as bf16 into
// `out` (row stride ld); rows >= S are not written
template <int DH>
__device__ __forceinline__ void gw_store(bf16* out, long long ld, const float (&o)[DH / 2],
                                         float mul, int r0, int S, int t) {
#pragma unroll
  for (int i = 0; i < DH / 2; i += 4) {
    const int c = la_col(i, t);
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(out + r0 * ld + c) = pack_f32(o[i] * mul, o[i + 1] * mul);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(out + (r0 + 8) * ld + c) =
          pack_f32(o[i + 2] * mul, o[i + 3] * mul);
  }
}

// a = expf(s - m) of a raw score x (s = x scale)
__device__ __forceinline__ float gw_exp(float x, float m, float scale) {
  return expf(__fsub_rn(__fmul_rn(x, scale), m));
}

// Passes 1 and 2 of the warpgroup's 64 query rows (Q tile qt) over the nc
// key chunks of the ring, as la_stats: each row's max m over every key,
// then l = sum exp(s - m), per lane in key order, then the quad; chunk c +
// 1's scores issued before chunk c's are read (two accumulator sets).
template <int DH>
__device__ __forceinline__ void gw_stats(float (&m)[2], float (&l)[2], Ring& ring,
                                         const uint8_t* qt, int nc, int S, float scale,
                                         int lane) {
  const int t = lane & 3, tail = S - (nc - 1) * LA_CHUNK;
  float sa[32], sb[32];
  auto issue = [&](float (&d)[32]) {
    const int st = ring.take();
    wgmma_fence();
    gw_ss<DH>(d, qt, ring.at(st));
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
  // the max of the raw scores, then scaled: the rounding of x scale (scale
  // > 0) does not decrease with x, so this is the max of the scaled scores
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
    m[r] = fmaxf(fmaxf(__fmul_rn(la_quad_max(mx[r]), scale), -3.0e38f), pad);
    l[r] = 0.0f;
  }
  // padded keys add exp(-1e30 - m) = 0: left out
  scan([&](const float (&s)[32], auto mask) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (!decltype(mask)::value || la_col(i, t) < tail)
        l[(i >> 1) & 1] += gw_exp(s[i], m[(i >> 1) & 1], scale);
  });
  l[0] = la_quad_sum(l[0]);
  l[1] = la_quad_sum(l[1]);
}

// p = expf(s - m) / l of the fragment s in place: every a first, then the
// quotients (la_divide); padded keys (mask: columns >= tail) 0. PROBE: a
// from the raw score in [0.5, 1.5] without the expf (GL_ONE_PASS_PROBE)
template <bool PROBE = false, class Mask>
__device__ __forceinline__ void gw_probs(float (&s)[32], const float (&m)[2], const float (&l)[2],
                                         const LaQuot (&q)[2], int t, int tail, float scale,
                                         Mask) {
  bool slow = l[0] > LA_QUOT_MAX_L || l[1] > LA_QUOT_MAX_L;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const bool live = !Mask::value || la_col(i, t) < tail;
    const float e = PROBE ? fminf(fabsf(s[i]), 1.0f) + 0.5f : gw_exp(s[i], m[(i >> 1) & 1], scale);
    const float a = live ? e : 0.0f;
    slow |= live && a < LA_QUOT_MIN;
    s[i] = a;
  }
  la_divide(s, l, q, slow);
}

// The forward's pass 3 over the nc chunks of the ring (K and V tiles), as
// la_fwd_pv: o = p v, p one bf16 term or (SPLIT) two. Per chunk c: chunk c +
// 1's scores issued, chunk c's softmax, then (chunk c - 1's P V done) its P
// packed and its P V issued, in flight during chunk c + 1's softmax.
template <int DH, bool SPLIT>
__device__ __forceinline__ void gw_fwd_pv(float (&o)[DH / 2], const float (&m)[2],
                                          const float (&l)[2], const LaQuot (&q)[2], Ring& ring,
                                          const uint8_t* qt, int nc, int S, float scale,
                                          int lane) {
  const int t = lane & 3, tail = S - (nc - 1) * LA_CHUNK;
  float sa[32], sb[32];
  uint32_t hi[4][4], lo[4][4];
  auto issue = [&](float (&d)[32]) {
    const int st = ring.take();
    wgmma_fence();
    gw_ss<DH>(d, qt, ring.at(st));
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
    la_masked(more, tail, [&](auto mask) {
      gw_probs<GL_ONE_PASS_PROBE != 0>(cur, m, l, q, t, tail, scale, mask);
    });
    if constexpr (MORE)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs<DH / 2>(o);
    fence_regs<4>(hi);
    if constexpr (SPLIT) fence_regs<4>(lo);
    if (prev >= 0) ring.release(prev, lane);
    la_pack<SPLIT>(hi, lo, cur);
    wgmma_fence();
    gw_rs<DH, SPLIT>(o, hi, lo, ring.at(st) + GwShape<DH>::TILE, c == 0);
    wgmma_commit();
    fence_regs<DH / 2>(o);
    prev = st;
    st = next;
  });
  wgmma_wait<0>();
  fence_regs<DH / 2>(o);
  fence_regs<4>(hi);
  if constexpr (SPLIT) fence_regs<4>(lo);
  ring.release(prev, lane);
}

// The forward: persistent blocks of GL_FWD_WG consumer warpgroups and a
// producer warpgroup over items (image b, head h, group g of GL_FWD_WG
// 64-query tiles), item = (b H + h) ng + g; block i takes items i, i +
// gridDim.x, ... q, k, v through their 4-D maps, head h at head qh (kh, vh)
// + h of the map; o rows of (b, h) at o + b obs + h DH + r ots. SPLIT: flash
// (p in two terms); else the fused layer's stage (bf16(p)). Shared memory:
// two slots of the item's Q tiles, then the ring (K in passes 1-2, K and V
// in pass 3).
template <int DH, bool SPLIT>
__global__ void __launch_bounds__((GL_FWD_WG + 1) * 128, 1)
gl_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, int qh, int kh, int vh,
              bf16* __restrict__ o, long long obs, long long ots, int S, int H, int items,
              float scale) {
  using G = GwShape<DH>;
  constexpr int WG = GL_FWD_WG, STAGES = gl_fwd_stages<DH>();
  __shared__ uint64_t full[STAGES], empty[STAGES], qfull[2], qempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* qbuf = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, qbuf + 2 * WG * G::TILE, G::STAGE, STAGES, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK, ng = (nc + WG - 1) / WG;
  if (tid == 0) {
    ring_init(full, empty, STAGES, WG * 4);
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
        mbar_expect_tx(&qfull[qs], live * G::TILE);
        for (int w = 0; w < live; ++w)
          gw_load<DH>(qbuf + (qs * WG + w) * G::TILE, &qmap, &qfull[qs], qh + h,
                      (g * WG + w) * LA_CHUNK, b);
        for (int pass = 0; pass < 3; ++pass)
          for (int c = 0; c < nc; ++c) {  // K, and in pass 3 V beside it
            uint64_t* bar;
            uint8_t* st = ring.fill(pass < 2 ? G::TILE : G::STAGE, &bar);
            gw_load<DH>(st, &kmap, bar, kh + h, c * LA_CHUNK, b);
            if (pass == 2) gw_load<DH>(st + G::TILE, &vmap, bar, vh + h, c * LA_CHUNK, b);
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
    const uint8_t* qt = qbuf + (qs * WG + w) * G::TILE;
    float m[2], l[2], acc[G::ACC];
    gw_stats<DH>(m, l, ring, qt, nc, S, scale, lane);
    const LaQuot q[2] = {LaQuot(l[0]), LaQuot(l[1])};
    gw_fwd_pv<DH, SPLIT>(acc, m, l, q, ring, qt, nc, S, scale, lane);
    if (lane == 0) mbar_arrive(&qempty[qs]);
    gw_store<DH>(o + (long long)b * obs + h * DH, ots, acc, 1.0f, tile * LA_CHUNK + lrow, S, t);
  }
}

template <int DH>
static size_t gl_fwd_smem() {
  return 1024 + (size_t)(2 * GL_FWD_WG) * GwShape<DH>::TILE +
         (size_t)gl_fwd_stages<DH>() * GwShape<DH>::STAGE;
}

// Passes 3 and 4 of the core for the warpgroup's 64 query rows (Q tile qt,
// dO tile ot) over the nc chunks of the ring (K and V), as la_core_rows: s =
// q k^T and dP = dO v^T on SS products, then per chunk
//   DQ false (pass 3): p; dot += dP p (per lane in key order); acc += bf16(p) v
//   DQ true  (pass 4): dS = p (dP - dot); acc += bf16(dS) k
// with the next chunk's SS products issued right behind the RS product. The
// core: P and dS one bf16 term. SPLIT, the flash backward: dS in two terms,
// and its pass 3 forms no att, so no RS product (acc untouched).
template <int DH, bool DQ, bool SPLIT = false>
__device__ __forceinline__ void gw_core_rows(float (&acc)[DH / 2], float (&dot)[2],
                                             const float (&m)[2], const float (&l)[2],
                                             const LaQuot (&q)[2], Ring& ring, const uint8_t* qt,
                                             const uint8_t* ot, int nc, int S, float scale,
                                             int lane) {
  const int t = lane & 3, tail = S - (nc - 1) * LA_CHUNK;
  float s[32], dp[32];
  uint32_t pa[4][4], pl[4][4];
  auto issue = [&]() {
    const int st = ring.take();
    wgmma_fence();
    gw_ss<DH>(s, qt, ring.at(st));
    gw_ss<DH>(dp, ot, ring.at(st) + GwShape<DH>::TILE);
    wgmma_commit();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    return st;
  };
  constexpr bool RS = DQ || !SPLIT;  // an RS product in this pass
  // what the products in flight may read or write besides s and dP
  auto fence_rs = [&]() {
    if constexpr (RS) {
      fence_regs<DH / 2>(acc);
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
    la_masked(more, tail, [&](auto mask) { gw_probs(s, m, l, q, t, tail, scale, mask); });
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
      gw_rs<DH, SPLIT>(acc, pa, pl, ring.at(st) + (DQ ? 0 : GwShape<DH>::TILE), c == 0);
    }
    prev = st;
    if constexpr (decltype(more)::value)
      st = issue();
    else
      wgmma_commit();
    if constexpr (RS) fence_regs<DH / 2>(acc);
  });
  wgmma_wait<0>();
  fence_rs();
  ring.release(prev, lane);
  if (!DQ) {
    dot[0] = la_quad_sum(dot[0]);
    dot[1] = la_quad_sum(dot[1]);
  }
}

// The cols phase for the warpgroup's 64 keys (K tile kt, V tile vt) over
// the nc query chunks of the ring (Q and dO), as la_core_cols, in steps of
// NQ queries (a chunk's 64, or at head_dim 80 two steps of 32, whose smaller
// score fragments leave the registers for dK and dV at N = 80): s^T = k q^T
// and dP^T = v dO^T on SS products, p and dS = p (dP - dot) from each
// column's query statistics (stats(c, stage): a LaStatRows of chunk c;
// queries >= S 0), then dV += p^T dO and dK += dS^T q on RS products (the
// 16-query k-steps in order), P and dS one bf16 term (the core) or (SPLIT:
// flash) two, the next step's SS products issued once the RS products have
// read their A registers.
template <int DH, bool SPLIT = false, class Stats>
__device__ __forceinline__ void gw_core_cols(float (&dk)[DH / 2], float (&dv)[DH / 2],
                                             Stats&& stats, Ring& ring, const uint8_t* kt,
                                             const uint8_t* vt, int nc, int S, float scale,
                                             int lane) {
  constexpr int NQ = DH > 64 ? 32 : 64, PARTS = LA_CHUNK / NQ, KS = NQ / 16;
  const int t = lane & 3, g = lane >> 2, tail = S - (nc - 1) * LA_CHUNK;
  float s[NQ / 2], dp[NQ / 2];
  uint32_t pa[KS][4], pl[KS][4], da[KS][4], dl[KS][4];
  int st = -1;
  auto issue = [&](int part) {  // step `part` of a chunk; part 0 takes the chunk's stage
    if (part == 0) st = ring.take();
    wgmma_fence();
    gw_ss<DH, NQ>(s, kt, ring.at(st) + part * NQ * 128);
    gw_ss<DH, NQ>(dp, vt, ring.at(st) + GwShape<DH>::TILE + part * NQ * 128);
    wgmma_commit();
    fence_regs<NQ / 2>(s);
    fence_regs<NQ / 2>(dp);
  };
  auto fence_acc = [&]() {
    fence_regs<DH / 2>(dk);
    fence_regs<DH / 2>(dv);
    fence_regs<KS>(pa);
    fence_regs<KS>(da);
    if constexpr (SPLIT) {
      fence_regs<KS>(pl);
      fence_regs<KS>(dl);
    }
  };
  issue(0);
  la_chunk_loop1(nc * PARTS, [&](int n, auto more) {
    const int c = n / PARTS, part = n % PARTS, q0 = part * NQ;
    wgmma_wait<0>();
    fence_regs<NQ / 2>(s);
    fence_regs<NQ / 2>(dp);
    fence_acc();
    // register i: key row (i / 2) % 2, query column q0 + 8 (i / 4) + 2 t +
    // i % 2, whose statistics are the pair j = i / 4 at q0 + 8 j + 2 t
    const LaStatRows rows = stats(c, st);
    const float* st_m = rows.m + q0 + 2 * t;
    const float* st_l = rows.l + q0 + 2 * t;
    const float* st_d = rows.d + q0 + 2 * t;
    // the 8 lanes of a quad position t share their columns: lane 4 g + t
    // takes the reciprocals of pair jg's row sums (columns q0 + 8 jg + 2 t,
    // + 1), the others read them by shuffle
    const int jg = g % (NQ / 8);
    auto softmax = [&](auto mask) {
      auto live = [&](int i) { return !decltype(mask)::value || q0 + la_col(i, t) < tail; };
      // la_divide's rule for the warp: the IEEE division where an a falls
      // below LA_QUOT_MIN or a live column's l exceeds LA_QUOT_MAX_L, which
      // only the flash backward's S reaches (the core's S limit keeps every
      // l below)
      float2 lg = make_float2(0.0f, 0.0f);
      bool slow = false;
      if constexpr (SPLIT) {
        lg = *reinterpret_cast<const float2*>(st_l + 8 * jg);
        slow = (live(4 * jg) && lg.x > LA_QUOT_MAX_L) ||
               (live(4 * jg + 1) && lg.y > LA_QUOT_MAX_L);
      }
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
        const float2 m2 = *reinterpret_cast<const float2*>(st_m + 8 * j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float a = live(i) ? gw_exp(s[i], e & 1 ? m2.y : m2.x, scale) : 0.0f;
          slow |= live(i) && a < LA_QUOT_MIN;
          s[i] = a;
        }
      }
      // the quotients, then dS; a column past S reads no statistics of its
      // own: 0
      auto finish = [&](auto ieee) {
        float2 rg = make_float2(0.0f, 0.0f);
        if constexpr (!decltype(ieee)::value) {
          if constexpr (!SPLIT) lg = *reinterpret_cast<const float2*>(st_l + 8 * jg);
          rg = make_float2(la_rcp(lg.x), la_rcp(lg.y));
        }
#pragma unroll
        for (int j = 0; j < NQ / 8; ++j) {
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
    };
    // columns past S only in the last chunk, and there in any of its steps
    if constexpr (PARTS == 1)
      la_masked(more, tail, softmax);
    else if (c == nc - 1 && tail < q0 + NQ)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
    gw_pack<KS, SPLIT>(pa, pl, s);
    gw_pack<KS, SPLIT>(da, dl, dp);
    wgmma_fence();
    gw_rs<DH, SPLIT, KS>(dv, pa, pl, ring.at(st) + GwShape<DH>::TILE + q0 * 128, n == 0);
    gw_rs<DH, SPLIT, KS>(dk, da, dl, ring.at(st) + q0 * 128, n == 0);
    wgmma_commit();
    fence_regs<DH / 2>(dk);
    fence_regs<DH / 2>(dv);
    if constexpr (decltype(more)::value) {  // the next step's products once A is read
      wgmma_wait<0>();
      fence_acc();
      if (part == PARTS - 1) ring.release(st, lane);
      issue((n + 1) % PARTS);
    }
  });
  wgmma_wait<0>();
  fence_acc();
  ring.release(st, lane);
}

// The fused block's backward core: one block per (image, head) (grid (H,
// B)), GL_CORE_WG consumer warpgroups and a producer warpgroup; qkv (B S,
// 3 D) and datt (B S, D) in through their 4-D maps (3 H and H heads), att
// (B S, D) and dqkv (B S, 3 D) out. Phase 1 takes the query tiles in rounds
// of GL_CORE_WG (passes 1-4: att, dq, and each query's statistics into
// shared memory); phase 2 the key tiles (dk, dv), reading those statistics.
// Shared memory: `slots` slots of each warpgroup's pair of tiles (Q and dO;
// K and V), the ring of `stages`, the statistics.
template <int DH>
__global__ void __launch_bounds__((GL_CORE_WG + 1) * 128, gl_core_minb<DH>())
gl_core_kernel(const __grid_constant__ CUtensorMap qkv_map,
               const __grid_constant__ CUtensorMap datt_map, bf16* __restrict__ att,
               bf16* __restrict__ dqkv, int S, int H, int slots, int stages, float scale) {
  using G = GwShape<DH>;
  constexpr int WG = GL_CORE_WG;
  __shared__ uint64_t full[GL_CORE_STAGES], empty[GL_CORE_STAGES], tfull[2], tempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* tiles = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, tiles + slots * WG * G::STAGE, G::STAGE, stages, 0};
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK, rounds = (nc + WG - 1) / WG;
  float* rmax = reinterpret_cast<float*>(tiles + (size_t)(slots * WG + stages) * G::STAGE);
  float* rsum = rmax + nc * LA_CHUNK;
  float* rdot = rsum + nc * LA_CHUNK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y, D = H * DH;
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
        mbar_expect_tx(&tfull[slot], live * G::STAGE);
        for (int w = 0; w < live; ++w) {
          uint8_t* dst = tiles + (slot * WG + w) * G::STAGE;
          const int row = (tile0 + w) * LA_CHUNK;
          if (keys) {
            gw_load<DH>(dst, &qkv_map, &tfull[slot], H + h, row, b);
            gw_load<DH>(dst + G::TILE, &qkv_map, &tfull[slot], 2 * H + h, row, b);
          } else {
            gw_load<DH>(dst, &qkv_map, &tfull[slot], h, row, b);
            gw_load<DH>(dst + G::TILE, &datt_map, &tfull[slot], h, row, b);
          }
        }
        for (int pass = keys ? 3 : 0; pass < 4; ++pass)
          for (int c = 0; c < nc; ++c) {  // phase 1: K (and V in passes 3-4); phase 2: Q, dO
            uint64_t* bar;
            uint8_t* st = ring.fill(pass < 2 ? G::TILE : G::STAGE, &bar);
            if (keys) {
              gw_load<DH>(st, &qkv_map, bar, h, c * LA_CHUNK, b);
              gw_load<DH>(st + G::TILE, &datt_map, bar, h, c * LA_CHUNK, b);
            } else {
              gw_load<DH>(st, &qkv_map, bar, H + h, c * LA_CHUNK, b);
              if (pass >= 2) gw_load<DH>(st + G::TILE, &qkv_map, bar, 2 * H + h, c * LA_CHUNK, b);
            }
          }
      }
    return;
  }

  reg_alloc<la_consumer_regs(WG, gl_core_minb<DH>())>();
  const int w = warp >> 2, t = lane & 3;
  const int lrow = (warp & 3) * 16 + (lane >> 2);
  const long long ld = 3LL * D;
  bf16* dq = dqkv + (long long)b * S * ld + h * DH;
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
    const uint8_t* ta = tiles + (slot * WG + w) * G::STAGE;
    const int row = tile * LA_CHUNK + lrow;
    if (!keys) {
      float m[2], l[2], dot[2], acc[G::ACC];
      gw_stats<DH>(m, l, ring, ta, nc, S, scale, lane);
      const LaQuot q[2] = {LaQuot(l[0]), LaQuot(l[1])};
      gw_core_rows<DH, false>(acc, dot, m, l, q, ring, ta, ta + G::TILE, nc, S, scale, lane);
      gw_store<DH>(att + (long long)b * S * D + h * DH, D, acc, 1.0f, row, S, t);
      gw_core_rows<DH, true>(acc, dot, m, l, q, ring, ta, ta + G::TILE, nc, S, scale, lane);
      if (lane == 0) mbar_arrive(&tempty[slot]);
      gw_store<DH>(dq, ld, acc, scale, row, S, t);
      if (t == 0)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (row + 8 * i < S) {
            rmax[row + 8 * i] = m[i];
            rsum[row + 8 * i] = l[i];
            rdot[row + 8 * i] = dot[i];
          }
    } else {
      float dk[G::ACC], dv[G::ACC];
      gw_core_cols<DH>(
          dk, dv,
          [&](int c, int) {
            return LaStatRows{rmax + c * LA_CHUNK, rsum + c * LA_CHUNK, rdot + c * LA_CHUNK};
          },
          ring, ta, ta + G::TILE, nc, S, scale, lane);
      if (lane == 0) mbar_arrive(&tempty[slot]);
      gw_store<DH>(dq + D, ld, dk, scale, row, S, t);
      gw_store<DH>(dq + 2 * D, ld, dv, 1.0f, row, S, t);
    }
  }
}

// the core's dynamic shared memory at S with `slots` tile slots and
// `stages` ring stages
template <int DH>
static size_t gl_core_smem(int S, int slots, int stages) {
  const size_t sp = (size_t)(S + LA_CHUNK - 1) / LA_CHUNK * LA_CHUNK;
  return 1024 + (size_t)(slots * GL_CORE_WG + stages) * GwShape<DH>::STAGE +
         3 * sp * sizeof(float);
}

// the longest S the core takes at head_dim DH: its statistics beside one
// tile slot and two stages, and at most long_core_max_seq() (the head_dim-64
// core's, whose layout the 8 KB tiles of head_dim 16-48 share: 15,168);
// at 80 (16 KB tiles) (232,192 - 99,328) / 12 bytes = 11,072 queries
template <int DH>
static int gl_core_max_seq() {
  const long long room = LA_CORE_SMEM - (long long)gl_core_smem<DH>(0, 1, 2);
  const int fit = (int)(room / (3 * (long long)sizeof(float)) / LA_CHUNK * LA_CHUNK);
  return fit < long_core_max_seq() ? fit : long_core_max_seq();
}

// the core's (tile slots, ring stages) at S: two slots and GL_CORE_STAGES
// stages, then fewer stages down to 2, then one slot, first within
// gl_core_shared_smem (gl_core_minb blocks an SM), then within one block's
// LA_CORE_SMEM; false above gl_core_max_seq
template <int DH>
static bool gl_core_layout(int S, int* slots, int* stages) {
  if (S > gl_core_max_seq<DH>()) return false;
  const size_t rooms[2] = {(size_t)gl_core_shared_smem<DH>(), LA_CORE_SMEM};
  for (const size_t room : rooms)
    for (*slots = 2; *slots >= 1; --*slots)
      for (*stages = GL_CORE_STAGES; *stages >= 2; --*stages)
        if (gl_core_smem<DH>(S, *slots, *stages) <= room) return true;
  return false;
}

// ---------------------------------------------------------------------------
// The flash backward: rows launch (statistics, dQ), cols launch (dK, dV)
// ---------------------------------------------------------------------------

// the flash backward's ring stages (both launches)
#define GL_FBWD_STAGES 4

// the flash backward's blocks an SM, which set its consumers' registers:
// two (232 registers) up to head_dim 48, one (240) at 80, where two slots
// of 32 KB tile pairs and the ring leave room for one block anyway
template <int DH>
__host__ __device__ constexpr int gl_fbwd_minb() {
  return DH > 64 ? 1 : 2;
}
// a cols ring stage: the Q and dO tiles, then the chunk's statistics
// (LA_FBWD_STATS_BYTES) padded so that the next stage's boxes stay
// 1024-aligned
template <int DH>
__host__ __device__ constexpr int gl_fbwd_col_stage() {
  return GwShape<DH>::STAGE + 1024;
}

// The flash backward, launch 1 (query-major), long_flash_bwd_rows on the
// head_dim: persistent blocks of one consumer warpgroup and a producer
// warpgroup over items (image b, head h, 64-query tile), item = (b H + h)
// nc + tile; block i takes items i, i + gridDim.x, ... Per query tile:
// passes 1-2 (gw_stats: m, l), then gw_core_rows' pass 3 (dot) and pass 4
// (dq += dS k, dS in two terms), the ring streaming K (passes 1-2), then K
// and V. q, k, v, dO through their 4-D maps, head h at head h of the map;
// dq rows of (b, h) at dq + b obs + h DH + r ots; the statistics of every
// row of the tile (rows >= S too: zeros in, finite out) into `ws` in
// long_attention.cuh's chunk planes (LA_FBWD_STATS floats a 64-query
// chunk). Shared memory: two slots of the item's Q and dO tiles, then the
// ring.
template <int DH>
__global__ void __launch_bounds__(2 * 128, gl_fbwd_minb<DH>())
gl_flash_rows_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, bf16* __restrict__ dq,
                     float* __restrict__ ws, long long obs, long long ots, int S, int H,
                     int items, float scale) {
  using G = GwShape<DH>;
  __shared__ uint64_t full[GL_FBWD_STAGES], empty[GL_FBWD_STAGES], tfull[2], tempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* tiles = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, tiles + 2 * G::STAGE, G::STAGE, GL_FBWD_STAGES, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK;
  if (tid == 0) {
    ring_init(full, empty, GL_FBWD_STAGES, 4);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&tfull[s], 1);
      mbar_init(&tempty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup: one lane issues every load
    reg_dealloc<LA_PRODUCER_REGS>();
    if (warp == 4 && lane == 0) {
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int tile = item % nc, h = item / nc % H, b = item / nc / H, ts = n & 1;
        uint8_t* dst = tiles + ts * G::STAGE;
        mbar_wait(&tempty[ts], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&tfull[ts], G::STAGE);
        gw_load<DH>(dst, &qmap, &tfull[ts], h, tile * LA_CHUNK, b);
        gw_load<DH>(dst + G::TILE, &omap, &tfull[ts], h, tile * LA_CHUNK, b);
        for (int pass = 0; pass < 4; ++pass)
          for (int c = 0; c < nc; ++c) {  // K, and in passes 3-4 V beside it
            uint64_t* bar;
            uint8_t* st = ring.fill(pass < 2 ? G::TILE : G::STAGE, &bar);
            gw_load<DH>(st, &kmap, bar, h, c * LA_CHUNK, b);
            if (pass >= 2) gw_load<DH>(st + G::TILE, &vmap, bar, h, c * LA_CHUNK, b);
          }
      }
    }
    return;
  }

  reg_alloc<la_consumer_regs(1, gl_fbwd_minb<DH>())>();
  const int t = lane & 3, lrow = warp * 16 + (lane >> 2);
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int tile = item % nc, h = item / nc % H, b = item / nc / H, ts = n & 1;
    mbar_wait(&tfull[ts], (n >> 1) & 1);
    const uint8_t* qt = tiles + ts * G::STAGE;
    float m[2], l[2], dot[2], acc[G::ACC];
    gw_stats<DH>(m, l, ring, qt, nc, S, scale, lane);
    const LaQuot q[2] = {LaQuot(l[0]), LaQuot(l[1])};
    gw_core_rows<DH, false, true>(acc, dot, m, l, q, ring, qt, qt + G::TILE, nc, S, scale, lane);
    gw_core_rows<DH, true, true>(acc, dot, m, l, q, ring, qt, qt + G::TILE, nc, S, scale, lane);
    if (lane == 0) mbar_arrive(&tempty[ts]);
    gw_store<DH>(dq + (long long)b * obs + h * DH, ots, acc, scale, tile * LA_CHUNK + lrow, S, t);
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

// The flash backward, launch 2 (key-major), long_flash_bwd_cols on the
// head_dim: launch 1's items with key tiles in the place of query tiles. Per
// key tile (K and V in a slot), gw_core_cols<DH, true> over every query
// chunk of the ring (each stage Q, dO and the chunk's statistics from `ws`
// in one bulk copy): dv = p^T dO, dk = dS^T q / sqrt(dh), P and dS in two
// terms. dk, dv rows as launch 1's dq.
template <int DH>
__global__ void __launch_bounds__(2 * 128, gl_fbwd_minb<DH>())
gl_flash_cols_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ ws,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, long long obs, long long ots,
                     int S, int H, int items, float scale) {
  using G = GwShape<DH>;
  __shared__ uint64_t full[GL_FBWD_STAGES], empty[GL_FBWD_STAGES], tfull[2], tempty[2];
  extern __shared__ uint8_t raw[];
  uint8_t* tiles = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring ring{full, empty, tiles + 2 * G::STAGE, gl_fbwd_col_stage<DH>(), GL_FBWD_STAGES, 0};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK;
  if (tid == 0) {
    ring_init(full, empty, GL_FBWD_STAGES, 4);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&tfull[s], 1);
      mbar_init(&tempty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4) {  // the producer warpgroup: one lane issues every load
    reg_dealloc<LA_PRODUCER_REGS>();
    if (warp == 4 && lane == 0) {
      int n = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
        const int tile = item % nc, h = item / nc % H, b = item / nc / H, ts = n & 1;
        uint8_t* dst = tiles + ts * G::STAGE;
        mbar_wait(&tempty[ts], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&tfull[ts], G::STAGE);
        gw_load<DH>(dst, &kmap, &tfull[ts], h, tile * LA_CHUNK, b);
        gw_load<DH>(dst + G::TILE, &vmap, &tfull[ts], h, tile * LA_CHUNK, b);
        const float* head = ws + (long long)(b * H + h) * nc * LA_FBWD_STATS;
        for (int c = 0; c < nc; ++c) {  // Q, dO and the statistics of query chunk c
          uint64_t* bar;
          uint8_t* st = ring.fill(G::STAGE + LA_FBWD_STATS_BYTES, &bar);
          gw_load<DH>(st, &qmap, bar, h, c * LA_CHUNK, b);
          gw_load<DH>(st + G::TILE, &omap, bar, h, c * LA_CHUNK, b);
          bulk_load(st + G::STAGE, head + (long long)c * LA_FBWD_STATS, LA_FBWD_STATS_BYTES, bar);
        }
      }
    }
    return;
  }

  reg_alloc<la_consumer_regs(1, gl_fbwd_minb<DH>())>();
  const int t = lane & 3, lrow = warp * 16 + (lane >> 2);
  int n = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++n) {
    const int tile = item % nc, h = item / nc % H, b = item / nc / H, ts = n & 1;
    mbar_wait(&tfull[ts], (n >> 1) & 1);
    const uint8_t* kt = tiles + ts * G::STAGE;
    float ak[G::ACC], av[G::ACC];
    gw_core_cols<DH, true>(
        ak, av,
        [&](int, int st) {
          const float* p = reinterpret_cast<const float*>(ring.at(st) + G::STAGE);
          return LaStatRows{p, p + LA_CHUNK, p + 2 * LA_CHUNK};
        },
        ring, kt, kt + G::TILE, nc, S, scale, lane);
    if (lane == 0) mbar_arrive(&tempty[ts]);
    const long long head = (long long)b * obs + h * DH;
    gw_store<DH>(dk + head, ots, ak, scale, tile * LA_CHUNK + lrow, S, t);
    gw_store<DH>(dv + head, ots, av, 1.0f, tile * LA_CHUNK + lrow, S, t);
  }
}

// the flash backward's dynamic shared memory: two slots of tile pairs, then
// the ring of stages of `stage_bytes`
template <int DH>
static size_t gl_fbwd_smem(int stage_bytes) {
  return 1024 + (size_t)2 * GwShape<DH>::STAGE + (size_t)GL_FBWD_STAGES * stage_bytes;
}

// ---------------------------------------------------------------------------
// Launches on the caller's stream
// ---------------------------------------------------------------------------

template <class K>
static int gl_set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// the forward over B images x H heads of S tokens, q, k and v through their
// 4-D maps at heads qh (kh, vh) + h; o rows of (b, h) at o + b obs + h DH +
// r ots. Persistent: as many blocks as the card holds, never more than the
// items.
template <int DH, bool SPLIT>
static int gl_launch_fwd(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                         int qh, int kh, int vh, bf16* o, long long obs, long long ots, int B,
                         int S, int H, cudaStream_t st) {
  const int nc = (S + LA_CHUNK - 1) / LA_CHUNK;
  const int items = B * H * ((nc + GL_FWD_WG - 1) / GL_FWD_WG);
  const int threads = (GL_FWD_WG + 1) * 128;
  const size_t smem = gl_fwd_smem<DH>();
  static int per_card = 0;
  int grid;
  LAUNCH(la_persistent_grid(gl_fwd_kernel<DH, SPLIT>, threads, smem, items, per_card, &grid));
  gl_fwd_kernel<DH, SPLIT><<<grid, threads, smem, st>>>(qm, km, vm, qh, kh, vh, o, obs, ots, S, H,
                                                        items, attention_scale(DH));
  return (int)cudaGetLastError();
}

// the flash forward: q, k, v (B, S, H, DH) through (bs, ts) strides (ts
// and, for B > 1, bs multiples of 8; 16-byte aligned), o contiguous
template <int DH>
static int gl_launch_flash_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int S,
                               int H, long long bs, long long ts, cudaStream_t st) {
  const long long lay = B > 1 ? bs : (long long)S * ts, ots = (long long)H * DH;
  CUtensorMap qm, km, vm;
  LAUNCH(gw_tensor_map(&qm, q, DH, H, S, B, ts, lay));
  LAUNCH(gw_tensor_map(&km, k, DH, H, S, B, ts, lay));
  LAUNCH(gw_tensor_map(&vm, v, DH, H, S, B, ts, lay));
  return gl_launch_fwd<DH, true>(qm, km, vm, 0, 0, 0, o, S * ots, ots, B, S, H, st);
}

// the fused block's forward stage: att (B S, D) from qkv (B S, 3 D), its
// thirds as 3 H heads of one map
template <int DH>
static int gl_launch_stage(const bf16* qkv, bf16* att, int B, int S, int H, int D,
                           cudaStream_t st) {
  CUtensorMap m;
  LAUNCH(gw_tensor_map(&m, qkv, DH, 3 * H, S, B, 3LL * D, 3LL * S * D));
  return gl_launch_fwd<DH, false>(m, m, m, 0, H, 2 * H, att, (long long)S * D, D, B, S, H, st);
}

// the fused block's backward core: att and dqkv from qkv and datt, one
// launch; S <= gl_core_max_seq<DH>()
template <int DH>
static int gl_launch_core(const bf16* qkv, const bf16* datt, bf16* att, bf16* dqkv, int B, int S,
                          int H, int D, cudaStream_t st) {
  int slots, stages;
  if (D != H * DH || !gl_core_layout<DH>(S, &slots, &stages)) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, om;
  LAUNCH(gw_tensor_map(&qm, qkv, DH, 3 * H, S, B, 3LL * D, 3LL * S * D));
  LAUNCH(gw_tensor_map(&om, datt, DH, H, S, B, D, (long long)S * D));
  const size_t smem = gl_core_smem<DH>(S, slots, stages);
  LAUNCH(gl_set_smem(gl_core_kernel<DH>, smem));
  gl_core_kernel<DH><<<dim3(H, B), (GL_CORE_WG + 1) * 128, smem, st>>>(
      qm, om, att, dqkv, S, H, slots, stages, attention_scale(DH));
  return (int)cudaGetLastError();
}

// the flash backward: dq, dk, dv contiguous (B, S, H, DH) from q, k, v (as
// gl_launch_flash_fwd takes them) and a contiguous dout, two persistent
// launches; ws: long_flash_bwd_ws_floats(B, S, H) floats
template <int DH>
static int gl_launch_flash_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                               bf16* dq, bf16* dk, bf16* dv, float* ws, int B, int S, int H,
                               long long bs, long long ts, cudaStream_t st) {
  const long long lay = B > 1 ? bs : (long long)S * ts, ots = (long long)H * DH;
  CUtensorMap qm, km, vm, om;
  LAUNCH(gw_tensor_map(&qm, q, DH, H, S, B, ts, lay));
  LAUNCH(gw_tensor_map(&km, k, DH, H, S, B, ts, lay));
  LAUNCH(gw_tensor_map(&vm, v, DH, H, S, B, ts, lay));
  LAUNCH(gw_tensor_map(&om, dout, DH, H, S, B, ots, S * ots));
  const int items = B * H * ((S + LA_CHUNK - 1) / LA_CHUNK), threads = 2 * 128;
  const float scale = attention_scale(DH);
  static int rows_per_card = 0, cols_per_card = 0;
  int grid;
  const size_t smem_rows = gl_fbwd_smem<DH>(GwShape<DH>::STAGE);
  LAUNCH(la_persistent_grid(gl_flash_rows_kernel<DH>, threads, smem_rows, items, rows_per_card,
                            &grid));
  gl_flash_rows_kernel<DH><<<grid, threads, smem_rows, st>>>(qm, km, vm, om, dq, ws, S * ots, ots,
                                                             S, H, items, scale);
  LAUNCH((int)cudaGetLastError());
  const size_t smem_cols = gl_fbwd_smem<DH>(gl_fbwd_col_stage<DH>());
  LAUNCH(la_persistent_grid(gl_flash_cols_kernel<DH>, threads, smem_cols, items, cols_per_card,
                            &grid));
  gl_flash_cols_kernel<DH><<<grid, threads, smem_cols, st>>>(qm, km, vm, om, ws, dk, dv, S * ots,
                                                             ots, S, H, items, scale);
  return (int)cudaGetLastError();
}
