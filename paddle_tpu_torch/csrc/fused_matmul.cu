// Matrix product with a norm prologue and a bias/activation epilogue (K6),
// and with a rotary-embedding epilogue (K7), written by hand for Hopper.
//
// Replaces two TPU kernels in paddle_tpu/ops/pallas/fused_ops.py:
//   * K6 `_matmul_kernel` (launched by `pallas_call` in `fused_matmul`):
//     out = act(norm(x) W + b). The norm (LayerNorm or RMSNorm, fp32
//     statistics over the full K, then * norm_weight + norm_bias) runs on
//     x's rows before the product, and the normalized rows are rounded to
//     x's type before they enter it, as the TPU kernel rounds them. The
//     product accumulates in fp32; bias and activation (gelu, gelu_tanh,
//     silu, relu, the formulas of `_act_apply`) run on the fp32 sum, which
//     is rounded once.
//   * K7 `_matmul_rope_kernel` (in `fused_matmul_rope`): out = rope(x W + b)
//     over x (B*S, K). Row r has position r % seq + pos_offset; within each
//     head of head_dim columns, column i < head_dim/2 pairs with column
//     i + head_dim/2 (rotate-half), freq_i = 1 / theta^(i / (head_dim/2)),
//     all in fp32 with accurate sincosf (at S = 2048 the angle reaches 2047
//     rad), then one store.
//
// Layouts. W is torch's (N, K) row-major weight, read as x W^T, so both
// operands are K-contiguous ("TN"): no call makes a transposed copy. x is
// (M, K) row-major. K must be a multiple of 8 (16-byte rows); M, N and K
// edges are ragged, with no padding copy.
//
// Translation. The TPU kernel keeps a (block_m, K) panel of x and a (K,
// block_n) panel of W resident in VMEM. A Hopper block cannot hold full-K
// panels, so it walks K in tiles. The bodies:
//   * bf16 / fp16, K6 `gemm_wgmma` and K7 `gemm_rope_wgmma`: one
//     warp-specialized mainloop (`gemm_mainloop`) and two epilogues. A
//     block owns a 128 x 128 output tile: two consumer warpgroups of 64
//     rows run `wgmma` m64n128k16 with fp32 accumulators in registers,
//     both operands K-major in shared memory; one producer warp's one
//     thread keeps a ring of 3 stages of TMA tiles (x 128 x 64 and W
//     128 x 64, 128-byte swizzle, 32 KB a stage) in flight, each stage
//     guarded by a `full` and an `empty` mbarrier. TMA's zero fill covers
//     ragged M, N and K % 64. 96 KB of ring and 288 threads a block let two
//     blocks share an SM (at most 112 registers a thread, no `setmaxnreg`).
//     At K6's shape it measured faster than a 128 x 256 tile (one block an
//     SM, a producer warpgroup handing its registers over), than one block
//     an SM with 4-6 stages, and than two-CTA clusters that multicast W
//     (PERF.md). The tensor maps are encoded per call.
//     Both epilogues work on the fp32 accumulator in registers, round once,
//     stage the tile through the freed ring (a 272-byte pitch, so a warp's
//     writes hit 32 banks) and store rows with 16-byte streaming
//     (evict-first) writes, or element by element when N % 8 != 0 leaves
//     rows unaligned. K6's adds the bias and applies the activation (the
//     formulas of `apply_act`, accurate tanhf and erff). K7's adds the bias
//     and rotates: a thread holds columns 8n + 2t + e of rows g and g + 8 in
//     acc[4n + e] and acc[4n + 2 + e], and head_dim / 2 is a multiple of 8,
//     so column c's partner c + head_dim / 2 is fragment n + head_dim / 16
//     of the same thread. Each thread takes its head_dim / 8 frequencies
//     (one powf each) and one sincosf a (row, frequency), which serves both
//     columns of the pair in every head of the tile; head_dim is a template
//     parameter (16, 32, 64, 128), so the pairing is fixed at compile time
//     and the accumulators stay in registers.
//     K6's norm prologue is a row pass, `norm_rows`, launched before the
//     product (the wrapper calls `fused_norm_rows`, then `fused_matmul` on
//     its rows): one warp a row computes the statistics in fp32, as the TPU
//     kernel and K4 do (mean, then the mean of the centered squares; RMSNorm
//     the mean of squares), and writes norm(x) * norm_weight + norm_bias,
//     rounded to x's type, into an (m, k) buffer that the wrapper
//     allocates. Its sums run in another order than the plain version's,
//     so a few normalized values a million land one rounding of x's type
//     apart (chip_smoke.py counts them). It costs 2 x M x K x 2 bytes more
//     traffic (16.8 MB each way at the GPT-2 345M shape, about 10 us) where
//     a per-block prologue would redo the statistics in each of the N / 128
//     column blocks.
//   * fp32 (K6 and K7), `gemm_f32`: 64 x 128 output tile, FMA on the CUDA
//     cores (tensor cores would round the inputs to TF32), 16-wide k-tiles,
//     4 x 8 outputs a thread; the norm prologue makes an fp32 statistics
//     pass over the block's rows and normalizes each x tile on its way to
//     shared memory; the epilogue stages the fp32 tile in shared memory
//     (`store_tile`) and applies the activation or the rotation there.
//
// Bounds at the path shapes (bf16, 989 TFLOP/s, 3.35 TB/s):
//   * K6, GPT-2 345M fc1 with gelu_tanh, 8192 x 1024 -> 4096: 68.7 GFLOP,
//     69.5 us; its bytes (x, W, out: 92 MB) take 27.5 us. Bound by operations.
//   * K6, block-0 qkv with LayerNorm, 8192 x 1024 -> 3072: 51.5 GFLOP, 52.1 us.
//   * K7, LLaMA-770M q/k, 8192 x 1536 -> 1536: 38.7 GFLOP, 39.1 us; its
//     bytes (55 MB) take 16.4 us. Bound by operations; the rotation adds
//     about 6 fp32 operations and 1/hd of a sincosf an output, off the
//     tensor cores.
// What the design does about it: the products run on wgmma fed by TMA, and
// both epilogues finish in registers and one store.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;            // output columns a block owns (all bodies)
constexpr int kStageLD = kBN + 4;   // fp32 epilogue tile pitch
constexpr int kBM = 128;            // output rows of a bf16 / fp16 block
// fp32 body
constexpr int kFBM = 64;
constexpr int kFBK = 16;

enum Act { kNone = 0, kGelu = 1, kGeluTanh = 2, kSilu = 3, kRelu = 4 };
enum Norm { kNoNorm = 0, kLayerNorm = 1, kRmsNorm = 2 };

struct Args {
  const void* x;      // (m, k)
  const void* w;      // (n, k)
  const void* bias;   // (n,) or null
  const void* nw;     // (k,) or null: norm weight
  const void* nb;     // (k,) or null: norm bias
  void* out;          // (m, n)
  int m, n, k;
  int norm, act;
  float eps;
  int rope, seq, head_dim, pos_offset;
  float theta;
};

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float in(float v) { return v; }
  static __device__ __forceinline__ float out(float v) { return v; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) { return __float2bfloat16_rn(v); }
};
template <>
struct Cvt<__half> {
  static __device__ __forceinline__ float in(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half out(float v) { return __float2half_rn(v); }
};

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case kGelu: return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
    case kGeluTanh:
      return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case kSilu: return v / (1.f + expf(-v));
    case kRelu: return v > 0.f ? v : 0.f;
    default: return v;
  }
}

// 8 consecutive values of a K-contiguous row as fp32 (K % 8 == 0, so the 8
// never straddle the end of a row)
template <typename T>
__device__ __forceinline__ void load8(float (&v)[8], const T* p) {
  if constexpr (sizeof(T) == 2) {
    alignas(16) T raw[8];
    *reinterpret_cast<uint4*>(raw) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Cvt<T>::in(raw[e]);
  } else {
    const float4 lo = *reinterpret_cast<const float4*>(p);
    const float4 hi = *reinterpret_cast<const float4*>(p + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
}

// Per-row mean and rstd of the block's rows [m0, m0 + rows) over the full K,
// one warp a row: LayerNorm mean then centered variance, RMSNorm mean of
// squares (mean 0). Lane 0's sums are kept, so every reader sees one value.
__device__ void row_stats(const Args& a, int m0, int rows, float* mean_s,
                          float* rstd_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* x = static_cast<const float*>(a.x);
  for (int r = warp; r < rows; r += kThreads / 32) {
    float mean = 0.f, rstd = 0.f;
    if (m0 + r < a.m) {
      const float* row = x + static_cast<long long>(m0 + r) * a.k;
      if (a.norm == kLayerNorm) {
        float sum = 0.f;
        for (int c = lane * 8; c < a.k; c += 256) {
          float v[8];
          load8(v, row + c);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += v[e];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        mean = __shfl_sync(0xffffffffu, sum, 0) / a.k;
      }
      float sq = 0.f;
      for (int c = lane * 8; c < a.k; c += 256) {
        float v[8];
        load8(v, row + c);
#pragma unroll
        for (int e = 0; e < 8; ++e) sq += (v[e] - mean) * (v[e] - mean);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      rstd = rsqrtf(__shfl_sync(0xffffffffu, sq, 0) / a.k + a.eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
  __syncthreads();
}

// The normalized value of x[row, kg + e] (fp32, before the type rounding).
__device__ __forceinline__ float normalize(const Args& a, float v, float mean,
                                           float rstd, int kg) {
  const float* nw = static_cast<const float*>(a.nw);
  const float* nb = static_cast<const float*>(a.nb);
  v = (v - mean) * rstd;
  return v * (nw ? nw[kg] : 1.f) + (nb ? nb[kg] : 0.f);
}

// gemm_f32's epilogue, after the block's fp32 tile (bias added) sits in
// `stage`: K6 applies the activation, K7 the rotation; rows are stored with
// 16-byte writes where the row allows them.
__device__ void store_tile(const Args& a, const float* stage, int m0, int n0) {
  float* out = static_cast<float*>(a.out);
  const bool vec_ok = a.n % 8 == 0;
  const int half = a.head_dim / 2;
  for (int idx = threadIdx.x; idx < kFBM * kBN / 8; idx += kThreads) {
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.m || gc >= a.n) continue;
    const float* src = stage + r * kStageLD + c;
    alignas(16) float v[8];
    if (a.rope) {
      // 8 consecutive columns lie in one half of one head (half % 8 == 0)
      const int j = gc % a.head_dim;
      const bool first = j < half;
      const float* other = first ? src + half : src - half;
      const float pos = static_cast<float>(gr % a.seq + a.pos_offset);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = (first ? j : j - half) + e;
        const float freq = 1.f / powf(a.theta, static_cast<float>(i) / static_cast<float>(half));
        float sn, cs;
        sincosf(pos * freq, &sn, &cs);
        v[e] = first ? src[e] * cs - other[e] * sn : src[e] * cs + other[e] * sn;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = apply_act(src[e], a.act);
    }
    float* dst = out + static_cast<long long>(gr) * a.n + gc;
    if (vec_ok && gc + 8 <= a.n) {
      reinterpret_cast<float4*>(dst)[0] = *reinterpret_cast<const float4*>(v);
      reinterpret_cast<float4*>(dst)[1] = *reinterpret_cast<const float4*>(v + 4);
    } else {
      for (int e = 0; e < 8 && gc + e < a.n; ++e) dst[e] = v[e];
    }
  }
}

template <typename T>
__device__ __forceinline__ float bias_of(const Args& a, int gc) {
  const T* b = static_cast<const T*>(a.bias);
  return (b && gc < a.n) ? Cvt<T>::in(b[gc]) : 0.f;
}

// ------------------------------------------------------------ fp32 body

__global__ void __launch_bounds__(kThreads) gemm_f32(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);     // [2][kFBK][kFBM + 4], k-major
  float* bs = as + 2 * kFBK * (kFBM + 4);              // [2][kFBK][kBN + 4], k-major
  float* mean_s = bs + 2 * kFBK * (kBN + 4);
  float* rstd_s = mean_s + kFBM;
  float* stage = reinterpret_cast<float*>(smem_raw);   // after the loop
  constexpr int ALD = kFBM + 4, BLD = kBN + 4;

  const int m0 = blockIdx.y * kFBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;   // rows ty*4.., cols tx+16j
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);

  if (a.norm) row_stats(a, m0, kFBM, mean_s, rstd_s);

  // a k-tile: A 64 x 16 (256 float4, one a thread), B 128 x 16 (two a thread)
  float4 ra, rb[2];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int kt) {
    {
      const int r = tid / 4, kg = kt * kFBK + (tid % 4) * 4;
      ra = (m0 + r < a.m && kg < a.k)
               ? *reinterpret_cast<const float4*>(x + static_cast<long long>(m0 + r) * a.k + kg)
               : zero;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c / 4, kg = kt * kFBK + (c % 4) * 4;
      rb[i] = (n0 + r < a.n && kg < a.k)
                  ? *reinterpret_cast<const float4*>(w + static_cast<long long>(n0 + r) * a.k + kg)
                  : zero;
    }
  };
  auto put = [&](int buf, int kt) {
    {
      const int r = tid / 4, kc = (tid % 4) * 4, kg = kt * kFBK + kc;
      float v[4] = {ra.x, ra.y, ra.z, ra.w};
      if (a.norm && m0 + r < a.m && kg < a.k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = normalize(a, v[e], mean_s[r], rstd_s[r], kg + e);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) as[(buf * kFBK + kc + e) * ALD + r] = v[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c / 4, kc = (c % 4) * 4;
      const float v[4] = {rb[i].x, rb[i].y, rb[i].z, rb[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) bs[(buf * kFBK + kc + e) * BLD + r] = v[e];
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int ktiles = (a.k + kFBK - 1) / kFBK;
  fetch(0);
  put(0, 0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) fetch(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(buf * kFBK + kk) * ALD + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[(buf * kFBK + kk) * BLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) put(buf ^ 1, kt + 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = tx + 16 * j;
    const float b = bias_of<float>(a, n0 + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) stage[(ty * 4 + i) * kStageLD + c] = acc[i][j] + b;
  }
  __syncthreads();
  store_tile(a, stage, m0, n0);
}

// --------------------------------------------- bf16 / fp16 bodies (K6, K7)

constexpr int kNormRows = 8;                      // norm_rows: one warp a row
constexpr int kGBK = 64;                          // k-tile: one 128-byte row
constexpr int kGConsumers = 256;                  // two consumer warpgroups
constexpr uint32_t kGTileBytes = kBM * kGBK * 2;  // an x tile: 16 KB

// The wgmma bodies' shape: a 128 x 128 output tile, a producer warp, 3
// stages of 32 KB, two blocks an SM.
struct GemmCfg {
  static constexpr int kBN = 128;
  static constexpr int kStages = 3;
  static constexpr int kInFlight = 1;   // k-tiles of wgmma a consumer keeps queued
  static constexpr int kThreads = kGConsumers + 32;
  static constexpr int kBlocksPerSm = 2;
  static constexpr uint32_t kStageBytes = kGTileBytes + kBN * kGBK * 2;
  static constexpr int kOutLD = kBN + 8;   // staged output pitch: 16 bytes over
  static constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kStages * sizeof(uint64_t);
  static_assert(kBM * kOutLD * 2 <= kStages * kStageBytes, "the output tile fits the ring");
};
static_assert(kBM == 128, "two 64-row consumer warpgroups");
using Acc = float[GemmCfg::kBN / 2];   // a consumer thread's fragment of the tile

// The norm prologue as a row pass: norm(x) * norm_weight + norm_bias,
// rounded to T, into xn (m, k). One warp a row. The statistics are the
// TPU kernel's, in fp32: LayerNorm the mean, then the mean of the centered
// squares; RMSNorm the mean of squares (mean 0); rstd = rsqrt(var + eps).
// Lane 0's sums are broadcast, so every lane uses one value. Then
// y = c * rstd * w + b as three fp32 roundings (no FMA contraction), the
// plain version's sequence; its sums run in another order, so a value
// within an fp32 error of a rounding boundary of T may take the other
// neighbour.
template <typename T>
__global__ void __launch_bounds__(kNormRows * 32) norm_rows(const Args a, T* xn) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kNormRows + warp;
  if (r >= a.m) return;
  const T* row = static_cast<const T*>(a.x) + static_cast<long long>(r) * a.k;
  const T* nw = static_cast<const T*>(a.nw);
  const T* nb = static_cast<const T*>(a.nb);
  float mean = 0.f;
  if (a.norm == kLayerNorm) {
    float sum = 0.f;
    for (int c = lane * 8; c < a.k; c += 256) {
      float v[8];
      load8(v, row + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    mean = __shfl_sync(0xffffffffu, sum, 0) / a.k;
  }
  float sq = 0.f;
  for (int c = lane * 8; c < a.k; c += 256) {
    float v[8];
    load8(v, row + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[e] - mean;
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(__shfl_sync(0xffffffffu, sq, 0) / a.k + a.eps);
  T* dst = xn + static_cast<long long>(r) * a.k;
  for (int c = lane * 8; c < a.k; c += 256) {
    float v[8], w[8], b[8];
    load8(v, row + c);
    if (nw) load8(w, nw + c);
    if (nb) load8(b, nb + c);
    alignas(16) T y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float t = __fmul_rn(__fsub_rn(v[e], mean), rstd);
      if (nw) t = __fmul_rn(t, w[e]);
      if (nb) t = __fadd_rn(t, b[e]);
      y[e] = Cvt<T>::out(t);
    }
    *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(y);
  }
}

// The k-loop of the block's 128 x 128 tile of x W^T; x and W arrive by TMA
// as 128 x 64 tiles. A consumer thread returns true with its fragment of
// the fp32 sums in `acc` (hopper::Wgmma's layout, rows wg*64 .. wg*64 + 63
// of the tile for warpgroup wg); the producer warp's threads return false.
template <typename T>
__device__ __forceinline__ bool gemm_mainloop(const CUtensorMap* tx, const CUtensorMap* tw,
                                              const Args& a, unsigned char* ring, Acc& acc) {
  using C = GemmCfg;
  using hopper::desc_sw128;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * C::kBN;
  const int ktiles = (a.k + kGBK - 1) / kGBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kGConsumers / 32);   // one arrival a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kGConsumers) {
    // the producer: one thread keeps the ring full
    if (threadIdx.x == kGConsumers) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % C::kStages;
        if (kt >= C::kStages) hopper::mbar_wait(&empty[s], (kt / C::kStages - 1) & 1);
        unsigned char* st = ring + s * C::kStageBytes;
        hopper::mbar_expect_tx(&full[s], C::kStageBytes);
        hopper::tma_load_2d(st, tx, &full[s], kt * kGBK, m0);
        hopper::tma_load_2d(st + kGTileBytes, tw, &full[s], kt * kGBK, n0);
      }
    }
    return false;
  }

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % C::kStages;
    hopper::mbar_wait(&full[s], (kt / C::kStages) & 1);
    const unsigned char* xs = ring + s * C::kStageBytes + wg * 64 * 128;
    const unsigned char* ws = ring + s * C::kStageBytes + kGTileBytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGBK / 16; ++kk)
      hopper::Wgmma<T, C::kBN>::ss(acc, desc_sw128(xs + kk * 32, 16, 1024),
                                   desc_sw128(ws + kk * 32, 16, 1024), kt > 0 || kk > 0);
    hopper::wgmma_commit();
    // kInFlight k-tiles' products stay in flight; the one before is done
    // with its stage
    hopper::wgmma_wait<C::kInFlight>();
    hopper::fence_regs(acc);
    // release k-tile `done`'s stage if the producer will refill it
    const int done = kt - C::kInFlight;
    if (done >= 0 && done + C::kStages < ktiles && lane == 0)
      hopper::mbar_arrive(&empty[done % C::kStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  return true;
}

// The consumers' common epilogue: round the fp32 fragments to T once,
// stage the tile through the ring (free once both warpgroups are past
// their last product: the first barrier) and store its rows.
template <typename T>
__device__ __forceinline__ void store_wgmma_tile(const Args& a, unsigned char* ring,
                                                 const Acc& acc) {
  using C = GemmCfg;
  constexpr int BN = C::kBN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  hopper::bar_sync(1, kGConsumers);
  T* stage = reinterpret_cast<T*>(ring);
  const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + r0 * C::kOutLD + n * 8 + 2 * t) =
        hopper::pack2<T>(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(stage + (r0 + 8) * C::kOutLD + n * 8 + 2 * t) =
        hopper::pack2<T>(acc[4 * n + 2], acc[4 * n + 3]);
  }
  hopper::bar_sync(1, kGConsumers);
  T* out = static_cast<T*>(a.out);
  const bool vec_ok = a.n % 8 == 0;   // else rows are not 16-byte aligned
  for (int i = threadIdx.x; i < kBM * BN / 8; i += kGConsumers) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.m || gc >= a.n) continue;
    const T* src = stage + r * C::kOutLD + c;
    T* dst = out + static_cast<long long>(gr) * a.n + gc;
    if (vec_ok) {
      // evict-first: the output is not read again here, and x and W stay
      // in L2 for the other blocks (faster at the path shapes: PERF.md)
      __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(src));
    } else {
      for (int e = 0; e < 8 && gc + e < a.n; ++e) dst[e] = src[e];
    }
  }
}

// the ring starts on a 1024-byte boundary, where the 128-byte swizzle repeats
__device__ __forceinline__ unsigned char* ring_of(unsigned char* smem) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
}

// K6: act(x W^T + b) for one 128 x 128 output tile (the norm, if any,
// already applied by norm_rows).
template <typename T>
__global__ void __launch_bounds__(GemmCfg::kThreads, GemmCfg::kBlocksPerSm)
    gemm_wgmma(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw, const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = ring_of(smem_raw);
  Acc acc;
  if (!gemm_mainloop<T>(&tx, &tw, a, ring, acc)) return;
  // bias and activation on the fp32 sums, in registers
  const int n0 = blockIdx.x * GemmCfg::kBN, t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < GemmCfg::kBN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = bias_of<T>(a, n0 + n * 8 + 2 * t + e);
      acc[4 * n + e] = apply_act(acc[4 * n + e] + b, a.act);
      acc[4 * n + 2 + e] = apply_act(acc[4 * n + 2 + e] + b, a.act);
    }
  store_wgmma_tile<T>(a, ring, acc);
}

// K7: rope(x W^T + b) for one 128 x 128 output tile, HD = head_dim. The
// tile covers 128 / HD whole heads. A thread's fragment n (columns
// 8n .. 8n + 7) lies in head n / (HD / 8) at fragment f = n % (HD / 8) of
// it; for f < HD / 16 its partners are fragment n + HD / 16, and column
// 8f + 2t + e rotates by pos * freq_(8f + 2t + e).
template <typename T, int HD>
__global__ void __launch_bounds__(GemmCfg::kThreads, GemmCfg::kBlocksPerSm)
    gemm_rope_wgmma(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw, const Args a) {
  static_assert(HD % 16 == 0 && GemmCfg::kBN % HD == 0, "whole heads, half a multiple of 8");
  constexpr int kHalfFrags = HD / 16;   // 8-column fragments in half a head
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = ring_of(smem_raw);
  Acc acc;
  if (!gemm_mainloop<T>(&tx, &tw, a, ring, acc)) return;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * GemmCfg::kBN;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < GemmCfg::kBN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = bias_of<T>(a, n0 + n * 8 + 2 * t + e);
      acc[4 * n + e] += b;
      acc[4 * n + 2 + e] += b;
    }
  // positions of the thread's rows g and g + 8
  const int row = m0 + wg * 64 + warp * 16 + g;
  const float pos[2] = {static_cast<float>(row % a.seq + a.pos_offset),
                        static_cast<float>((row + 8) % a.seq + a.pos_offset)};
#pragma unroll
  for (int f = 0; f < kHalfFrags; ++f)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float freq = 1.f / powf(a.theta, static_cast<float>(8 * f + 2 * t + e) /
                                                 static_cast<float>(HD / 2));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sn, cs;
        sincosf(pos[r] * freq, &sn, &cs);
#pragma unroll
        for (int h = 0; h < GemmCfg::kBN / HD; ++h) {
          const int lo = 4 * (h * (HD / 8) + f) + 2 * r + e, hi = lo + 4 * kHalfFrags;
          const float x1 = acc[lo], x2 = acc[hi];
          acc[lo] = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
          acc[hi] = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
        }
      }
    }
  store_wgmma_tile<T>(a, ring, acc);
}

// ---------------------------------------------------------------- launch

size_t f32_smem() {
  const size_t loop = sizeof(float) * (2 * kFBK * (kFBM + 4) + 2 * kFBK * (kBN + 4) + 2 * kFBM);
  const size_t epi = sizeof(float) * kFBM * kStageLD;
  return loop > epi ? loop : epi;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A wgmma body over (m, n): x and W get a tensor map each, dims (k, rows),
// boxes of 64 x 128, encoded per call.
template <typename T>
cudaError_t launch_wgmma(void (*kernel)(CUtensorMap, CUtensorMap, Args), const Args& a,
                         cudaStream_t stream) {
  using C = GemmCfg;
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(a.k), static_cast<cuuint64_t>(a.m)};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(a.k), static_cast<cuuint64_t>(a.n)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(a.k) * 2};
  const cuuint32_t x_box[2] = {kGBK, kBM}, w_box[2] = {kGBK, C::kBN};
  if (!hopper::make_map(&tx, a.x, hopper::kIsHalf<T>, 2, x_dims, row_bytes, x_box) ||
      !hopper::make_map(&tw, a.w, hopper::kIsHalf<T>, 2, w_dims, row_bytes, w_box))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + C::kBN - 1) / C::kBN, (a.m + kBM - 1) / kBM);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(tx, tw, a);
  return cudaGetLastError();
}

// K7 in bf16 / fp16: one instantiation a head_dim.
template <typename T>
cudaError_t launch_k7(const Args& a, cudaStream_t stream) {
  switch (a.head_dim) {
    case 16: return launch_wgmma<T>(gemm_rope_wgmma<T, 16>, a, stream);
    case 32: return launch_wgmma<T>(gemm_rope_wgmma<T, 32>, a, stream);
    case 64: return launch_wgmma<T>(gemm_rope_wgmma<T, 64>, a, stream);
    case 128: return launch_wgmma<T>(gemm_rope_wgmma<T, 128>, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Args& a, int dtype, void* stream) {
  if (a.m <= 0 || a.n <= 0 || a.k <= 0 || a.k % 8 != 0 || !aligned16(a.x) ||
      !aligned16(a.w) || !aligned16(a.out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bm = dtype == 0 ? kFBM : kBM;
  const long long m_tiles = (static_cast<long long>(a.m) + bm - 1) / bm;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const size_t smem = f32_smem();
    cudaError_t err = cudaFuncSetAttribute(
        gemm_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((a.n + kBN - 1) / kBN, static_cast<unsigned>(m_tiles));
    gemm_f32<<<grid, kThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // the bf16 / fp16 K6 takes normalized rows from fused_norm_rows
  if (dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (a.rope) {
    return static_cast<int>(dtype == 1 ? launch_k7<__nv_bfloat16>(a, st)
                                       : launch_k7<__half>(a, st));
  }
  if (a.norm != kNoNorm) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dtype == 1 ? launch_wgmma<__nv_bfloat16>(gemm_wgmma<__nv_bfloat16>, a, st)
                                     : launch_wgmma<__half>(gemm_wgmma<__half>, a, st));
}

}  // namespace

// K6's row pass (bf16 / fp16; the fp32 body normalizes its own tiles). x
// and out (m, k) contiguous; norm_weight and norm_bias (k,) contiguous or
// null; one type. dtype: 1 = bfloat16, 2 = float16. norm: 1 LayerNorm,
// 2 RMSNorm. out = norm(x) * norm_weight + norm_bias rounded to the type.
// Returns a cudaError_t: the launch's own, or cudaErrorInvalidValue for
// arguments the kernel does not take (another dtype, k not a multiple of
// 8, pointers not 16-byte aligned).
extern "C" int fused_norm_rows(const void* x, const void* norm_weight,
                               const void* norm_bias, void* out, int m, int k,
                               int dtype, int norm, float eps, void* stream) {
  if (m <= 0 || k <= 0 || k % 8 != 0 || (norm != kLayerNorm && norm != kRmsNorm) ||
      !aligned16(x) || !aligned16(norm_weight) || !aligned16(norm_bias) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, nullptr, nullptr, norm_weight, norm_bias, nullptr, m, 0, k, norm, kNone,
               eps, 0, 1, 2, 0, 1.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((m + kNormRows - 1) / kNormRows);
  if (dtype == 1)
    norm_rows<__nv_bfloat16><<<blocks, kNormRows * 32, 0, st>>>(
        a, static_cast<__nv_bfloat16*>(out));
  else if (dtype == 2)
    norm_rows<__half><<<blocks, kNormRows * 32, 0, st>>>(a, static_cast<__half*>(out));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K6's product. x (m, k), w (n, k), out (m, n) contiguous; bias (n,),
// norm_weight and norm_bias (k,) contiguous or null; one type. dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. norm: 0 none, 1 LayerNorm, 2 RMSNorm
// (float32 only: in bf16 / fp16 x is the output of fused_norm_rows and
// norm is 0). act: 0 none, 1 gelu, 2 gelu_tanh, 3 silu, 4 relu. Returns a
// cudaError_t: the launch's own, or cudaErrorInvalidValue for arguments
// the kernel does not take (k not a multiple of 8, pointers not 16-byte
// aligned, a norm in bf16 / fp16).
extern "C" int fused_matmul(const void* x, const void* w, const void* bias,
                            const void* norm_weight, const void* norm_bias,
                            void* out, int m, int n, int k, int dtype, int norm,
                            int act, float eps, void* stream) {
  if (norm < kNoNorm || norm > kRmsNorm || act < kNone || act > kRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, norm_weight, norm_bias, out, m, n, k, norm, act, eps,
               0, 1, 2, 0, 1.f};
  return run(a, dtype, stream);
}

// K7. x (m = batch * seq, k), w (n, k), out (m, n) contiguous; bias (n,) or
// null; one type. n must be a multiple of head_dim, and head_dim one of
// 16, 32, 64 and 128.
extern "C" int fused_matmul_rope(const void* x, const void* w, const void* bias,
                                 void* out, int m, int n, int k, int dtype,
                                 int seq, int head_dim, float theta,
                                 int pos_offset, void* stream) {
  if (seq <= 0 || (head_dim != 16 && head_dim != 32 && head_dim != 64 && head_dim != 128) ||
      n % head_dim != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, nullptr, nullptr, out, m, n, k, kNoNorm, kNone, 0.f,
               1, seq, head_dim, pos_offset, theta};
  return run(a, dtype, stream);
}
