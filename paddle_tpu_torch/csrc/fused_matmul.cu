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
// panels, so it walks K in tiles. Three bodies:
//   * K6, bf16 / fp16, `gemm_wgmma`: warp-specialized. A block owns a
//     128 x 128 output tile: two consumer warpgroups of 64 rows run
//     `wgmma` m64n128k16 with fp32 accumulators in registers, both
//     operands K-major in shared memory; one producer warp's one thread
//     keeps a ring of 3 stages of TMA tiles (x 128 x 64 and W 128 x 64,
//     128-byte swizzle, 32 KB a stage) in flight, each stage guarded by a
//     `full` and an `empty` mbarrier. TMA's zero fill covers ragged M, N
//     and K % 64. 96 KB of ring and 288 threads a block let two blocks
//     share an SM (90 registers a thread, no `setmaxnreg`). At this shape
//     it measured faster than a 128 x 256 tile (one block an SM, a producer
//     warpgroup handing its registers over), than one block an SM with 4-6
//     stages, and than two-CTA clusters that multicast W (PERF.md). The
//     epilogue adds the bias and
//     applies the activation to the fp32 accumulator in registers (the
//     formulas of `apply_act`, accurate tanhf and erff), rounds once, stages
//     the tile through the freed ring (a 272-byte pitch, so a
//     warp's writes hit 32 banks) and stores rows with 16-byte streaming
//     (evict-first) writes, or element by element when N % 8 != 0 leaves
//     rows unaligned.
//     The norm prologue is a row pass, `norm_rows`, launched by the same
//     call before the product: one warp a row computes the statistics once
//     (mean then centered variance, as the TPU kernel) and writes
//     norm(x) * norm_weight + norm_bias, rounded to x's type, into a
//     scratch (M, K) buffer that the wrapper allocates; the product reads
//     that. The rows are rounded where the TPU kernel rounds them; its
//     statistics are summed in fp64 where the TPU kernel sums in fp32, so
//     a normalized value within an fp32 error of a rounding boundary may
//     take the other neighbour (chip_smoke.py counts them). It costs
//     2 x M x K x 2 bytes more traffic (16.8 MB each way at the GPT-2 345M
//     shape, about 10 us) where the per-block prologue redid the
//     statistics in each of the N / 128 column blocks.
//   * K7, bf16 / fp16, `gemm_mma` (for K7 only; its move onto the wgmma
//     mainloop is later work): 128 x 128 output tile, 8 warps of 64 x 32,
//     `mma.sync.m16n8k16` with fragments read by `ldmatrix`, 32-wide
//     k-tiles with the next tile's global loads in flight in registers,
//     two shared-memory buffers and one barrier a tile. Its epilogue
//     stages the fp32 tile through shared memory so that column c can pair
//     with c + head_dim/2 (they sit in different fragments); a tile of 128
//     columns covers whole heads, so head_dim must divide 128.
//   * fp32 (K6 and K7), `gemm_f32`: 64 x 128 output tile, FMA on the CUDA
//     cores (tensor cores would round the inputs to TF32), 16-wide k-tiles,
//     4 x 8 outputs a thread; the norm prologue makes a statistics pass over
//     the block's rows and normalizes each x tile on its way to shared
//     memory.
//
// Bounds at the path shapes (bf16, 989 TFLOP/s, 3.35 TB/s):
//   * K6, GPT-2 345M fc1 with gelu_tanh, 8192 x 1024 -> 4096: 68.7 GFLOP,
//     69.5 us; its bytes (x, W, out: 92 MB) take 27.5 us. Bound by operations.
//   * K6, block-0 qkv with LayerNorm, 8192 x 1024 -> 3072: 51.5 GFLOP, 52.1 us.
//   * K7, LLaMA-770M q/k, 8192 x 1536 -> 1536: 38.7 GFLOP, 39.1 us; its
//     bytes (55 MB) take 16.4 us. Bound by operations.
// What the design does about it: K6's products run on wgmma fed by TMA, and
// its epilogue never leaves the chip; K7 is still on mma.sync, well below
// its bound.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;            // output columns a block owns (all bodies)
constexpr int kStageLD = kBN + 4;   // fp32 epilogue tile pitch
// K7's bf16 / fp16 body
constexpr int kBM = 128;
constexpr int kBK = 32;
constexpr int kLDS = kBK + 8;       // 80-byte rows: ldmatrix reads hit 32 banks
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

// The epilogue after the block's fp32 tile (bias added) sits in `stage`:
// K6 applies the activation, K7 the rotation; rows are stored with 16-byte
// writes where the row allows them.
template <typename T, int BM>
__device__ void store_tile(const Args& a, const float* stage, int m0, int n0) {
  T* out = static_cast<T*>(a.out);
  const bool vec_ok = a.n % 8 == 0;
  const int half = a.head_dim / 2;
  for (int idx = threadIdx.x; idx < BM * kBN / 8; idx += kThreads) {
    const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= a.m || gc >= a.n) continue;
    const float* src = stage + r * kStageLD + c;
    float v[8];
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
    T* dst = out + static_cast<long long>(gr) * a.n + gc;
    if (vec_ok && gc + 8 <= a.n) {
      alignas(16) T o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = Cvt<T>::out(v[e]);
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
      } else {
        reinterpret_cast<float4*>(dst)[0] = *reinterpret_cast<const float4*>(o);
        reinterpret_cast<float4*>(dst)[1] = *reinterpret_cast<const float4*>(o + 4);
      }
    } else {
      for (int e = 0; e < 8 && gc + e < a.n; ++e) dst[e] = Cvt<T>::out(v[e]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float bias_of(const Args& a, int gc) {
  const T* b = static_cast<const T*>(a.bias);
  return (b && gc < a.n) ? Cvt<T>::in(b[gc]) : 0.f;
}

// --------------------------------------------- K7's bf16 / fp16 body

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* as = reinterpret_cast<uint16_t*>(smem_raw);   // [2][kBM][kLDS]
  uint16_t* bs = as + 2 * kBM * kLDS;                      // [2][kBN][kLDS]
  float* stage = reinterpret_cast<float*>(smem_raw);       // after the loop

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;   // warp tile: rows wm*64, cols wn*32
  const int g = lane >> 2, t = lane & 3;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);

  // a k-tile of A and of B is 512 16-byte chunks each: two a thread
  uint4 ra[2], rb[2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c / 4, kg = kt * kBK + (c % 4) * 8;
      ra[i] = (m0 + r < a.m && kg < a.k)
                  ? *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * a.k + kg)
                  : zero;
      rb[i] = (n0 + r < a.n && kg < a.k)
                  ? *reinterpret_cast<const uint4*>(w + static_cast<long long>(n0 + r) * a.k + kg)
                  : zero;
    }
  };
  auto put = [&](int buf, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c / 4, kc = (c % 4) * 8;
      *reinterpret_cast<uint4*>(as + (buf * kBM + r) * kLDS + kc) = ra[i];
      *reinterpret_cast<uint4*>(bs + (buf * kBN + r) * kLDS + kc) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int ktiles = (a.k + kBK - 1) / kBK;
  fetch(0);
  put(0, 0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ktiles) fetch(kt + 1);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], as + (buf * kBM + wm * 64 + i * 16 + lane % 16) * kLDS +
                               kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        // lanes 0-7: n-tile j at k, 8-15: j at k+8, 16-23: j+1 at k, 24-31: j+1 at k+8
        uint32_t r[4];
        ldmatrix_x4(r, bs + (buf * kBN + wn * 32 + j * 8 + lane % 8 + (lane / 16) * 8) * kLDS +
                           kk + ((lane / 8) % 2) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mma<T>::run(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < ktiles) put(buf ^ 1, kt + 1);
    __syncthreads();
  }

  // the loop ended on a barrier: the A/B buffers are free for the stage
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = wn * 32 + j * 8 + 2 * t;
    const float b0 = bias_of<T>(a, n0 + c), b1 = bias_of<T>(a, n0 + c + 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = wm * 64 + i * 16 + g;
      stage[r * kStageLD + c] = acc[i][j][0] + b0;
      stage[r * kStageLD + c + 1] = acc[i][j][1] + b1;
      stage[(r + 8) * kStageLD + c] = acc[i][j][2] + b0;
      stage[(r + 8) * kStageLD + c + 1] = acc[i][j][3] + b1;
    }
  }
  __syncthreads();
  store_tile<T, kBM>(a, stage, m0, n0);
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
  store_tile<float, kFBM>(a, stage, m0, n0);
}

// ----------------------------------------------- K6's bf16 / fp16 bodies

constexpr int kNormRows = 8;                      // norm_rows: one warp a row
constexpr int kGBK = 64;                          // k-tile: one 128-byte row
constexpr int kGConsumers = 256;                  // two consumer warpgroups
constexpr uint32_t kGTileBytes = kBM * kGBK * 2;  // an x tile: 16 KB

// gemm_wgmma's shape: a 128 x 128 output tile, a producer warp, 3 stages
// of 32 KB, two blocks an SM.
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

// The norm prologue as a row pass: norm(x) * norm_weight + norm_bias,
// rounded to T, into xn (m, k). One warp a row. The statistics are summed
// in fp64, which holds the sum of K 16-bit values (and of their fp32
// squares) to the last bit of fp32, and rounded once to fp32: mean, then
// the centered values in fp32, their mean square, rstd = rsqrt(var + eps)
// in fp64 rounded to fp32, and y = c * rstd * w + b as three fp32 roundings
// (no FMA contraction). That is the plain version's sequence operation for
// operation, so both round every normalized value to T the same way; with
// fp32 sums in two different orders a few values a million land on the
// other side of a rounding boundary, and their one-unit difference shows
// in outputs near 0. RMSNorm: the mean square of x, mean 0.
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
    double sum = 0.0;
    for (int c = lane * 8; c < a.k; c += 256) {
      float v[8];
      load8(v, row + c);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    mean = static_cast<float>(__shfl_sync(0xffffffffu, sum, 0) / a.k);
  }
  double sq = 0.0;
  for (int c = lane * 8; c < a.k; c += 256) {
    float v[8];
    load8(v, row + c);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const double d = __fsub_rn(v[e], mean);
      sq += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float var = static_cast<float>(__shfl_sync(0xffffffffu, sq, 0) / a.k);
  const float rstd = static_cast<float>(rsqrt(static_cast<double>(__fadd_rn(var, a.eps))));
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

// act(x W^T + b) for one 128 x 128 output tile (the norm, if any, already
// applied by norm_rows). x and W arrive by TMA as 128 x 64 tiles.
template <typename T>
__global__ void __launch_bounds__(GemmCfg::kThreads, GemmCfg::kBlocksPerSm)
    gemm_wgmma(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw, const Args a) {
  using C = GemmCfg;
  constexpr int BN = C::kBN;
  using hopper::desc_sw128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
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
        hopper::tma_load_2d(st, &tx, &full[s], kt * kGBK, m0);
        hopper::tma_load_2d(st + kGTileBytes, &tw, &full[s], kt * kGBK, n0);
      }
    }
    return;
  }

  // a consumer warpgroup: output rows wg*64 .. wg*64 + 63 of the tile
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  float acc[BN / 2];
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % C::kStages;
    hopper::mbar_wait(&full[s], (kt / C::kStages) & 1);
    const unsigned char* xs = ring + s * C::kStageBytes + wg * 64 * 128;
    const unsigned char* ws = ring + s * C::kStageBytes + kGTileBytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGBK / 16; ++kk)
      hopper::Wgmma<T, BN>::ss(acc, desc_sw128(xs + kk * 32, 16, 1024),
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

  // bias and activation on the fp32 sums, in registers
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = bias_of<T>(a, n0 + n * 8 + 2 * t + e);
      acc[4 * n + e] = apply_act(acc[4 * n + e] + b, a.act);
      acc[4 * n + 2 + e] = apply_act(acc[4 * n + 2 + e] + b, a.act);
    }
  // both warpgroups are past their last product: the ring is free
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

// ---------------------------------------------------------------- launch

size_t mma_smem() {
  const size_t loop = sizeof(uint16_t) * 2 * (kBM + kBN) * kLDS;
  const size_t epi = sizeof(float) * kBM * kStageLD;
  return loop > epi ? loop : epi;
}

size_t f32_smem() {
  const size_t loop = sizeof(float) * (2 * kFBK * (kFBM + 4) + 2 * kFBK * (kBN + 4) + 2 * kFBM);
  const size_t epi = sizeof(float) * kFBM * kStageLD;
  return loop > epi ? loop : epi;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
                   const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// K6 in bf16 / fp16: the row pass into `scratch` when there is a norm,
// then the product. x and W get a tensor map each: dims (k, rows), boxes
// of 64 x 128.
template <typename T>
cudaError_t launch_k6(Args a, void* scratch, cudaStream_t stream) {
  using C = GemmCfg;
  if (a.norm != kNoNorm) {
    if (scratch == nullptr || !aligned16(scratch)) return cudaErrorInvalidValue;
    norm_rows<T><<<(a.m + kNormRows - 1) / kNormRows, kNormRows * 32, 0, stream>>>(
        a, static_cast<T*>(scratch));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    a.x = scratch;
    a.norm = kNoNorm;
  }
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(a.k), static_cast<cuuint64_t>(a.m)};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(a.k), static_cast<cuuint64_t>(a.n)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(a.k) * 2};
  const cuuint32_t x_box[2] = {kGBK, kBM}, w_box[2] = {kGBK, C::kBN};
  if (!hopper::make_map(&tx, a.x, hopper::kIsHalf<T>, 2, x_dims, row_bytes, x_box) ||
      !hopper::make_map(&tw, a.w, hopper::kIsHalf<T>, 2, w_dims, row_bytes, w_box))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_wgmma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + C::kBN - 1) / C::kBN, (a.m + kBM - 1) / kBM);
  gemm_wgmma<T><<<grid, C::kThreads, C::kSmem, stream>>>(tx, tw, a);
  return cudaGetLastError();
}

int run(const Args& a, int dtype, void* scratch, void* stream) {
  if (a.m <= 0 || a.n <= 0 || a.k <= 0 || a.k % 8 != 0 || !aligned16(a.x) ||
      !aligned16(a.w) || !aligned16(a.out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bm = dtype == 0 ? kFBM : kBM;
  const long long m_tiles = (static_cast<long long>(a.m) + bm - 1) / bm;
  if (m_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.n + kBN - 1) / kBN, static_cast<unsigned>(m_tiles));
  if (dtype == 0) return launch(gemm_f32, f32_smem(), grid, st, a);
  if (a.rope) {   // K7
    if (dtype == 1) return launch(gemm_mma<__nv_bfloat16>, mma_smem(), grid, st, a);
    if (dtype == 2) return launch(gemm_mma<__half>, mma_smem(), grid, st, a);
  } else {        // K6
    if (dtype == 1) return launch_k6<__nv_bfloat16>(a, scratch, st);
    if (dtype == 2) return launch_k6<__half>(a, scratch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// K6. x (m, k), w (n, k), out (m, n) contiguous; bias (n,), norm_weight and
// norm_bias (k,) contiguous or null; one type. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. norm: 0 none, 1 LayerNorm, 2 RMSNorm. act: 0
// none, 1 gelu, 2 gelu_tanh, 3 silu, 4 relu. scratch: an (m, k) buffer of
// x's type for the normalized rows (bf16 / fp16 with a norm; else unused,
// may be null). Returns a cudaError_t: the launch's own, or
// cudaErrorInvalidValue for arguments the kernel does not take (k not a
// multiple of 8, pointers not 16-byte aligned, no scratch where it is
// needed).
extern "C" int fused_matmul(const void* x, const void* w, const void* bias,
                            const void* norm_weight, const void* norm_bias,
                            void* scratch, void* out, int m, int n, int k,
                            int dtype, int norm, int act, float eps,
                            void* stream) {
  if (norm < kNoNorm || norm > kRmsNorm || act < kNone || act > kRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, norm_weight, norm_bias, out, m, n, k, norm, act, eps,
               0, 1, 2, 0, 1.f};
  return run(a, dtype, scratch, stream);
}

// K7. x (m = batch * seq, k), w (n, k), out (m, n) contiguous; bias (n,) or
// null; one type. n must be a multiple of head_dim, and head_dim an even
// divisor of 128 with head_dim / 2 a multiple of 8 (16, 32, 64 or 128).
extern "C" int fused_matmul_rope(const void* x, const void* w, const void* bias,
                                 void* out, int m, int n, int k, int dtype,
                                 int seq, int head_dim, float theta,
                                 int pos_offset, void* stream) {
  if (seq <= 0 || head_dim <= 0 || head_dim % 16 != 0 || kBN % head_dim != 0 ||
      n % head_dim != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, bias, nullptr, nullptr, out, m, n, k, kNoNorm, kNone, 0.f,
               1, seq, head_dim, pos_offset, theta};
  return run(a, dtype, nullptr, stream);
}
