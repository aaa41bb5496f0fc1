// Attention forward and backward for Hopper (sm_90a), everything fp32 inside,
// bf16 or fp32 in and out.
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
// The inputs are cast to fp32 and every value stays fp32 until the outputs
// are rounded to the input dtype: P is never rounded before P v or P^T dO,
// nor dS before dS k and dS^T q. That is what tells this function apart from
// the fused block's attention (csrc/layer_fwd.cuh, attention_bwd.cuh), which
// rounds P and dS to bf16 for the tensor cores; a bf16 mma of P would turn
// this kernel into that other function. So every product here is an fp32 FMA
// on the CUDA cores.
//
// What bounds it on this card: the fp32 FMA rate. At ViT-Tiny (S = 197, dh
// 64, B = 128: 384 (image, head) pairs) the forward moves 38.7 MB (11.6 us at
// 3.35 TB/s) and does 3.82 GFLOP, the backward 67.8 MB and 9.54 GFLOP: at the
// 989 TFLOP/s bf16 tensor rate both would be bound by bytes, but at the 67
// TFLOP/s the card has outside the tensor cores the products take 57 us and
// 142 us. The design keeps the FMA units fed from registers and shared memory:
//
//   * a block takes 64 rows (queries, or keys in the backward's second
//     phase) of one (image, head), 8 per warp, and stages all S rows of the
//     other side in shared memory (as the input type: bf16 is widened at use)
//     with rows 68 elements apart, so that lane c reading row 32 j + c and
//     lanes reading across one row both meet no bank conflict;
//   * each lane holds an 8 x 8 register tile of scores (its 8 rows against
//     columns c, 32 + c, ..., 224 + c), summed over dh in ascending order, so
//     that both backward phases recompute the same scores bit for bit;
//   * the products with P (or dS) go through a per-warp 8 x 32 slab of shared
//     memory, read back as broadcast float4, each lane accumulating two of the
//     64 output dims.
//
// The backward is two launches and no atomics: the first, per query tile,
// computes the softmax statistics (row max, row sum, rowsum(dP * P)) into a
// workspace and dQ; the second, per key tile, walks every query, recomputes
// P^T and dS^T from those statistics and sums dV and dK in registers. Every
// sum stays inside one warp, so two runs give the same bits. Keys >= S get
// probability exactly 0, queries >= S are left out of dK and dV, and pad rows
// are never written: the Pallas kernels' padding to 256, without the padding.
//
// Layout: q, k, v are read in place through strides, as the views the split
// of the block's (B, S, 3D) qkv gives them: element (b, s, h, d) at
// b * bs + s * ts + h * 64 + d. o, dO, dq, dk and dv are contiguous (B, S, H,
// 64). Limits: head_dim 64, S <= 256.

#include "common.cuh"

#define FA_DH 64
#define FA_RW 8                     // rows per warp
#define FA_WARPS 8
#define FA_ROWS (FA_RW * FA_WARPS)  // rows per block
#define FA_MAX_S 256
#define FA_NJ (FA_MAX_S / 32)       // column groups: lane c holds column 32 j + c
#define FA_LD 68                    // elements per staged row of the other side

// 2 or 4 consecutive elements as floats
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows r0 .. r0 + n - 1 of one (image, head) (global row stride ts) into
// shared memory with row stride LD, as TS; rows >= S are zeros.
template <int LD, typename TS, typename TG>
__device__ __forceinline__ void stage(TS* dst, const TG* src, long long ts, int r0, int n,
                                      int S) {
  for (int i = threadIdx.x; i < n * (FA_DH / 2); i += blockDim.x) {
    const int r = i / (FA_DH / 2);
    const int c = 2 * (i % (FA_DH / 2));
    float2 x = make_float2(0.0f, 0.0f);
    if (r0 + r < S) x = ld2(src + (r0 + r) * ts + c);
    st2(dst + r * LD + c, x.x, x.y);
  }
}

// acc[i][j] = sum over d ascending of A[i][d] * B[32 j + lane][d]: A the warp's
// 8 fp32 rows (stride FA_DH, read as broadcasts), B the staged rows. Groups
// with 32 j >= S stay 0.
template <typename T>
__device__ __forceinline__ void dot_rows(float acc[FA_RW][FA_NJ], const float* A, const T* B,
                                         int S, int lane) {
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j) {
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) acc[i][j] = 0.0f;
    if (32 * j < S) {
      const T* br = B + (32 * j + lane) * FA_LD;
#pragma unroll 2
      for (int d = 0; d < FA_DH; d += 4) {
        const float4 b = ld4(br + d);
#pragma unroll
        for (int i = 0; i < FA_RW; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(A + i * FA_DH + d);
          acc[i][j] = fmaf(a.x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b.w, acc[i][j]);
        }
      }
    }
  }
}

// acc[i][0..1] = sum over columns c of w[i][c] * R[c][2 lane .. 2 lane + 1]:
// w is the register tile (column 32 j + lane in w[i][j]), passed through the
// warp's 8 x 32 slab `slab`; R the staged rows.
template <typename T>
__device__ __forceinline__ void product(float acc[FA_RW][2], const float w[FA_RW][FA_NJ],
                                        float* slab, const T* R, int S, int lane) {
#pragma unroll
  for (int i = 0; i < FA_RW; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j) {
    if (32 * j < S) {
      __syncwarp();  // the slab's last readers are done
#pragma unroll
      for (int i = 0; i < FA_RW; ++i) slab[i * 32 + lane] = w[i][j];
      __syncwarp();
      const T* r = R + (32 * j) * FA_LD + 2 * lane;
#pragma unroll 2
      for (int c = 0; c < 32; c += 4) {
        float2 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = ld2(r + (c + u) * FA_LD);
#pragma unroll
        for (int i = 0; i < FA_RW; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(slab + i * 32 + c);
          acc[i][0] = fmaf(p.x, x[0].x, acc[i][0]);
          acc[i][1] = fmaf(p.x, x[0].y, acc[i][1]);
          acc[i][0] = fmaf(p.y, x[1].x, acc[i][0]);
          acc[i][1] = fmaf(p.y, x[1].y, acc[i][1]);
          acc[i][0] = fmaf(p.z, x[2].x, acc[i][0]);
          acc[i][1] = fmaf(p.z, x[2].y, acc[i][1]);
          acc[i][0] = fmaf(p.w, x[3].x, acc[i][0]);
          acc[i][1] = fmaf(p.w, x[3].y, acc[i][1]);
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

// rows w0 + i < S of acc * mul into out (row stride ts), two dims per lane
template <typename T>
__device__ __forceinline__ void store_rows(T* out, long long ts, const float acc[FA_RW][2],
                                           float mul, int w0, int S, int lane) {
#pragma unroll
  for (int i = 0; i < FA_RW; ++i)
    if (w0 + i < S) st2(out + (w0 + i) * ts + 2 * lane, acc[i][0] * mul, acc[i][1] * mul);
}

__host__ __device__ __forceinline__ int padded(int S) { return (S + 31) / 32 * 32; }

// ---------------------------------------------------------------------------
// Forward: one block per 64 queries of one (image, head)
// ---------------------------------------------------------------------------

template <typename T>
static size_t fwd_smem(int S) {
  return (size_t)2 * padded(S) * FA_LD * sizeof(T) + (size_t)FA_ROWS * FA_DH * 4 +
         (size_t)FA_WARPS * FA_RW * 32 * 4;
}

template <typename T>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, long long bs, long long ts, float scale) {
  const int SP = padded(S);
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* Ks = reinterpret_cast<T*>(fa_smem);
  T* Vs = Ks + SP * FA_LD;
  float* Qs = reinterpret_cast<float*>(Vs + SP * FA_LD);  // this block's queries
  float* slabs = Qs + FA_ROWS * FA_DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  stage<FA_LD>(Ks, k + head, ts, 0, SP, S);
  stage<FA_LD>(Vs, v + head, ts, 0, SP, S);
  stage<FA_DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  __syncthreads();
  const int w0 = r0 + warp * FA_RW;
  if (w0 >= S) return;  // from here on every warp works alone

  float s[FA_RW][FA_NJ], mx[FA_RW], sum[FA_RW];
  dot_rows(s, Qs + warp * FA_RW * FA_DH, Ks, S, lane);
  softmax_rows(s, mx, sum, scale, S, lane);
  float acc[FA_RW][2];
  product(acc, s, slabs + warp * FA_RW * 32, Vs, S, lane);
  const long long ots = (long long)H * FA_DH;
  store_rows(o + (long long)b * S * ots + h * FA_DH, ots, acc, 1.0f, w0, S, lane);
}

// ---------------------------------------------------------------------------
// Backward, phase 1: one block per 64 queries: statistics and dQ
// ---------------------------------------------------------------------------

template <typename T>
static size_t bwd_rows_smem(int S) {
  return (size_t)2 * padded(S) * FA_LD * sizeof(T) + (size_t)2 * FA_ROWS * FA_DH * 4 +
         (size_t)FA_WARPS * FA_RW * 32 * 4;
}

template <typename T>
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
flash_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dq, float* __restrict__ stats, int S, int H,
                      long long bs, long long ts, float scale) {
  const int SP = padded(S);
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* Ks = reinterpret_cast<T*>(fa_smem);
  T* Vs = Ks + SP * FA_LD;
  float* Qs = reinterpret_cast<float*>(Vs + SP * FA_LD);
  float* Os = Qs + FA_ROWS * FA_DH;  // dO of this block's queries
  float* slabs = Os + FA_ROWS * FA_DH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FA_ROWS;
  const long long head = (long long)b * bs + h * FA_DH;
  const long long ots = (long long)H * FA_DH;
  const long long ohead = (long long)b * S * ots + h * FA_DH;
  stage<FA_LD>(Ks, k + head, ts, 0, SP, S);
  stage<FA_LD>(Vs, v + head, ts, 0, SP, S);
  stage<FA_DH>(Qs, q + head, ts, r0, FA_ROWS, S);
  stage<FA_DH>(Os, dout + ohead, ots, r0, FA_ROWS, S);
  __syncthreads();
  const int w0 = r0 + warp * FA_RW;
  if (w0 >= S) return;

  float p[FA_RW][FA_NJ], dp[FA_RW][FA_NJ], mx[FA_RW], sum[FA_RW];
  dot_rows(p, Qs + warp * FA_RW * FA_DH, Ks, S, lane);
  dot_rows(dp, Os + warp * FA_RW * FA_DH, Vs, S, lane);
  softmax_rows(p, mx, sum, scale, S, lane);
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
  float acc[FA_RW][2];
  product(acc, dp, slabs + warp * FA_RW * 32, Ks, S, lane);
  store_rows(dq + ohead, ots, acc, scale, w0, S, lane);
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

// ---------------------------------------------------------------------------
// Backward, phase 2: one block per 64 keys, every query: dK and dV
// ---------------------------------------------------------------------------

template <typename T>
static size_t bwd_cols_smem(int S) {
  return (size_t)2 * padded(S) * FA_LD * sizeof(T) + (size_t)2 * FA_ROWS * FA_DH * 4 +
         (size_t)3 * padded(S) * 4 + (size_t)FA_WARPS * FA_RW * 32 * 4;
}

template <typename T>
__global__ void __launch_bounds__(FA_WARPS * 32, 1)
flash_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ stats, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int H, long long bs, long long ts,
                      float scale) {
  const int SP = padded(S);
  extern __shared__ __align__(16) unsigned char fa_smem[];
  T* Qs = reinterpret_cast<T*>(fa_smem);
  T* Os = Qs + SP * FA_LD;  // dO, every query
  float* Kt = reinterpret_cast<float*>(Os + SP * FA_LD);  // this block's keys
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
  stage<FA_LD>(Qs, q + head, ts, 0, SP, S);
  stage<FA_LD>(Os, dout + ohead, ots, 0, SP, S);
  stage<FA_DH>(Kt, k + head, ts, r0, FA_ROWS, S);
  stage<FA_DH>(Vt, v + head, ts, r0, FA_ROWS, S);
  const float* st = stats + ((long long)(b * H + h) * S) * 3;
  for (int c = threadIdx.x; c < SP; c += blockDim.x) {  // pad queries: inert
    rmax[c] = c < S ? st[c * 3 + 0] : 0.0f;
    rsum[c] = c < S ? st[c * 3 + 1] : 1.0f;
    rdot[c] = c < S ? st[c * 3 + 2] : 0.0f;
  }
  __syncthreads();
  const int w0 = r0 + warp * FA_RW;
  if (w0 >= S) return;

  // P^T and dP^T: rows are this warp's keys, columns the queries 32 j + lane
  float p[FA_RW][FA_NJ], ds[FA_RW][FA_NJ];
  dot_rows(p, Kt + warp * FA_RW * FA_DH, Qs, S, lane);
  dot_rows(ds, Vt + warp * FA_RW * FA_DH, Os, S, lane);
#pragma unroll
  for (int j = 0; j < FA_NJ; ++j) {
    const int c = 32 * j + lane;
    const bool live = c < S;
    const float m = rmax[live ? c : 0], l = rsum[live ? c : 0], dt = rdot[live ? c : 0];
#pragma unroll
    for (int i = 0; i < FA_RW; ++i) {
      // the scores and P of phase 1, bit for bit (same sums, same order)
      const float pr = live ? expf(__fsub_rn(__fmul_rn(p[i][j], scale), m)) / l : 0.0f;
      p[i][j] = pr;
      ds[i][j] = pr * (ds[i][j] - dt);
    }
  }
  float* slab = slabs + warp * FA_RW * 32;
  float acc[FA_RW][2];
  product(acc, p, slab, Os, S, lane);  // dV = P^T dO
  store_rows(dv + ohead, ots, acc, 1.0f, w0, S, lane);
  product(acc, ds, slab, Qs, S, lane);  // dK = dS^T q / sqrt(dh)
  store_rows(dk + ohead, ots, acc, scale, w0, S, lane);
}

// ---------------------------------------------------------------------------
// Host entries
// ---------------------------------------------------------------------------

template <typename K>
static int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

static bool bad_shape(int B, int S, int H, long long bs, long long ts) {
  return B <= 0 || S <= 0 || S > FA_MAX_S || H <= 0 || ts < (long long)H * FA_DH ||
         bs < (long long)S * ts || (ts & 1) || (bs & 1);
}

template <typename T>
static int fwd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               long long bs, long long ts, cudaStream_t st) {
  const size_t smem = fwd_smem<T>(S);
  LAUNCH(set_smem(flash_fwd_kernel<T>, smem));
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  flash_fwd_kernel<T><<<grid, FA_WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, bs, ts, 1.0f / sqrtf((float)FA_DH));
  return (int)cudaGetLastError();
}

template <typename T>
static int bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
               void* dk, void* dv, void* stats, int B, int S, int H, long long bs,
               long long ts, cudaStream_t st) {
  const dim3 grid((S + FA_ROWS - 1) / FA_ROWS, H, B);
  const float scale = 1.0f / sqrtf((float)FA_DH);
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* dO = static_cast<const T*>(dout);
  float* ws = static_cast<float*>(stats);
  size_t smem = bwd_rows_smem<T>(S);
  LAUNCH(set_smem(flash_bwd_rows_kernel<T>, smem));
  flash_bwd_rows_kernel<T><<<grid, FA_WARPS * 32, smem, st>>>(
      Q, K, V, dO, static_cast<T*>(dq), ws, S, H, bs, ts, scale);
  LAUNCH((int)cudaGetLastError());
  smem = bwd_cols_smem<T>(S);
  LAUNCH(set_smem(flash_bwd_cols_kernel<T>, smem));
  flash_bwd_cols_kernel<T><<<grid, FA_WARPS * 32, smem, st>>>(
      Q, K, V, dO, ws, static_cast<T*>(dk), static_cast<T*>(dv), S, H, bs, ts, scale);
  return (int)cudaGetLastError();
}

// q, k, v: (B, S, H, 64) read through (bs, ts) strides; o contiguous (B, S,
// H, 64); all bf16, or all fp32 with `fp32` set.
extern "C" int vit2spn_flash_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int H, long long bs, long long ts, int fp32,
                                 void* stream) {
  if (bad_shape(B, S, H, bs, ts)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? fwd<float>(q, k, v, o, B, S, H, bs, ts, st)
              : fwd<bf16>(q, k, v, o, B, S, H, bs, ts, st);
}

// dout, dq, dk, dv contiguous (B, S, H, 64); stats: workspace_floats fp32.
extern "C" int vit2spn_flash_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, void* dq, void* dk, void* dv, void* stats,
                                 int B, int S, int H, long long bs, long long ts, int fp32,
                                 void* stream) {
  if (bad_shape(B, S, H, bs, ts)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? bwd<float>(q, k, v, dout, dq, dk, dv, stats, B, S, H, bs, ts, st)
              : bwd<bf16>(q, k, v, dout, dq, dk, dv, stats, B, S, H, bs, ts, st);
}

// the row statistics between the two backward launches
extern "C" long long vit2spn_flash_bwd_workspace_floats(int B, int S, int H) {
  return (long long)B * H * S * 3;
}

extern "C" int vit2spn_flash_fwd_launches() { return 1; }

extern "C" int vit2spn_flash_bwd_launches() { return 2; }
