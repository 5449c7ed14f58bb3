// Flash-attention forward (FlashAttention-2) for Hopper, written by hand.
//
// Replaces the TPU kernel `_fwd_kernel` in
// paddle_tpu/ops/pallas/flash_attention.py (launched by `pallas_call` in
// `_flash_fwd_bhsd`, public entry `flash_attention_fwd`). Same function:
// online softmax over key/value tiles with fp32 running max `m`, sum `l`
// and accumulator; the -1e30 mask value; the bottom-right causal offset
// `seq_k - seq_q` with key tiles wholly above the diagonal skipped; 0 for
// rows that see no key; LSE = m + log(max(l, 1e-30)) per query row.
//
// Translation. On the TPU the key/value axis is the innermost, sequential
// grid axis and m/l/acc live in VMEM scratch across grid steps. Here the
// blocks of a grid run in parallel and share nothing, so one thread block
// owns one (batch*head, 64-query tile) pair and walks the key/value tiles
// in a loop, keeping m/l/acc in registers. Q/K/V are read in their BSHD
// layout through the strides the wrapper passes, so the JAX wrapper's
// BSHD<->BHSD transposes (two copies each way) and its pad of the head
// dim to 128 lanes do not exist here.
//
// Two bodies, one function:
//   * bf16 / fp16: four warps, 16 query rows each. S = Q K^T and O += P V
//     run on the tensor cores through `mma.sync.m16n8k16` with fp32
//     accumulation; P is rounded to the input type before P V, as the TPU
//     kernel rounds `p.astype(v.dtype)`. The S accumulator fragment is
//     reused in registers as the A operand of P V.
//   * fp32: plain FMA on the CUDA cores (tensor cores would round the
//     inputs to TF32). 128 threads, each owning an 8x4 piece of S and an
//     8x(d/16) piece of O; S/P go through shared memory for the row
//     statistics.
//
// Bound at the GPT-2 small path shape (B=4, S=1024, H=12, d=64, bf16,
// causal), per call: q, k, v and out are 6.29 MB each, 25.2 MB together,
// 7.5 us at 3.35 TB/s; the FLOPs are 4*B*H*S^2*d/2 = 6.4 GFLOP, 6.5 us at
// 989 TFLOP/s. So the call is bound by bytes at about 7.5 us, and a
// forward makes 12 such calls (one a layer). What the design does about
// it: every input byte is read from device memory once per query tile
// (K/V tiles are re-read by the 16 query tiles of a head, from L2), and
// no (S, S) matrix ever leaves the chip. What it does not do yet: the
// loads are synchronous (no cp.async/TMA ring overlapping the next tile
// with this tile's math) and the products use mma.sync, not wgmma, so the
// kernel sits well above the bound; that is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;       // (B, seq_q, H, D), contiguous, input type
  float* lse;    // (B, H, seq_q), contiguous, fp32
  long long q_sb, q_ss, q_sh;   // element strides of the BSHD inputs
  long long k_sb, k_ss, k_sh;   // (the head dim is contiguous)
  long long v_sb, v_ss, v_sh;
  int heads, seq_q, seq_k;
  float scale;
  int causal;
};

// Key/value tiles this query tile must visit: all of them, or, when
// causal, those that start at or before the last key its last row sees.
__device__ __forceinline__ int kv_tiles(const Args& a, int q0) {
  int n = (a.seq_k + kBlockK - 1) / kBlockK;
  if (a.causal) {
    const int last = q0 + kBlockQ - 1 + (a.seq_k - a.seq_q);
    n = last < 0 ? 0 : min(n, last / kBlockK + 1);
  }
  return n;
}

__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  return col < a.seq_k && (!a.causal || row + (a.seq_k - a.seq_q) >= col);
}

// ------------------------------------------------------------ fp32 body

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Args a) {
  constexpr int QLD = D + 1;        // padded rows: conflict-free column reads
  constexpr int VLD = D;
  constexpr int PLD = kBlockK + 1;
  constexpr int NC = D / 16;        // O columns a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBlockQ * QLD;
  float* vs = ks + kBlockK * QLD;
  float* ps = vs + kBlockK * VLD;
  float* row_s = ps + kBlockQ * PLD;

  const int tid = threadIdx.x;
  // the heaviest causal tiles (last query rows) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * QLD + c] = q0 + r < a.seq_q ? q[(q0 + r) * a.q_ss + c] : 0.f;
  }
  const int n_kv = kv_tiles(a, q0);
  const int ty = tid / 16, tx = tid % 16;   // S/O piece: rows ty*8.., cols tx+16c
  const int sr = tid >> 1, sh = tid & 1;    // row statistics: row sr, half sh
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  float m_i = kNegInf, l_i = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();   // the previous tile's K/V/P are consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < a.seq_k;
      ks[r * QLD + c] = ok ? k[(k0 + r) * a.k_ss + c] : 0.f;
      vs[r * VLD + c] = ok ? v[(k0 + r) * a.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qa[8], kb[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qa[i] = qs[(ty * 8 + i) * QLD + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = ks[(tx + 16 * c) * QLD + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qa[i], kb[c], s[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty * 8 + i, col = tx + 16 * c;
        ps[r * PLD + col] =
            visible(a, q0 + r, k0 + col) ? s[i][c] * a.scale : kNegInf;
      }
    __syncthreads();

    {  // online softmax: two threads a row, 32 columns each
      float* row = ps + sr * PLD + sh * 32;
      float mx = kNegInf;
      for (int c = 0; c < 32; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      // a row that has seen no key yet keeps p = 0 (exp(-1e30 + 1e30) = 1)
      const bool live = m_new > 0.5f * kNegInf;
      float sum = 0.f;
      for (int c = 0; c < 32; ++c) {
        const float e = live ? __expf(row[c] - m_new) : 0.f;
        row[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = __expf(m_i - m_new);
      l_i = alpha * l_i + sum;
      m_i = m_new;
      if (sh == 0) row_s[sr] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float al = row_s[ty * 8 + i];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pa[8], vb[NC];
#pragma unroll
      for (int i = 0; i < 8; ++i) pa[i] = ps[(ty * 8 + i) * PLD + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) vb[n] = vs[kk * VLD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pa[i], vb[n], acc[i][n]);
    }
  }

  __syncthreads();
  const float l = fmaxf(l_i, 1e-30f);
  if (sh == 0) {
    row_s[sr] = l;
    if (q0 + sr < a.seq_q)
      a.lse[static_cast<long long>(blockIdx.y) * a.seq_q + q0 + sr] =
          m_i + logf(l);
  }
  __syncthreads();
  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = q0 + ty * 8 + i;
    if (qp >= a.seq_q) continue;
    const float li = row_s[ty * 8 + i];
    float* orow = o + ((static_cast<long long>(b) * a.seq_q + qp) * a.heads + h) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) orow[tx + 16 * n] = acc[i][n] / li;
  }
}

// ----------------------------------------------------- bf16 / fp16 body

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
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
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
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t pair(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// ROWS rows of D 16-bit values from a strided source into a shared tile
// with row pitch D + 8, 16 bytes a thread; rows at or past `limit` are 0.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src,
                                          long long stride, int row0,
                                          int limit) {
  constexpr int LD = D + 8, PER_ROW = D / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(const Args a) {
  constexpr int LD = D + 8;          // +16 bytes a row: fragment reads hit 32 banks
  constexpr int NS = kBlockK / 8;    // S n-tiles a warp owns (16 x 64)
  constexpr int NO = D / 8;          // O n-tiles a warp owns (16 x D)
  constexpr int KQ = D / 16;         // k-steps of Q K^T
  constexpr int KP = kBlockK / 16;   // k-steps of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* ks = qs + kBlockQ * LD;
  uint16_t* vs = ks + kBlockK * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const uint16_t* q = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;

  load_rows<D, kBlockQ>(qs, q, a.q_ss, q0, a.seq_q);
  __syncthreads();
  const int wr = warp * 16;
  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const uint16_t* p = qs + (wr + g) * LD + kk * 16 + 2 * t;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  const int row0 = q0 + wr + g, row1 = row0 + 8;   // the two rows a thread holds
  const int n_kv = kv_tiles(a, q0);
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();   // the previous tile's K/V are consumed
    load_rows<D, kBlockK>(ks, k, a.k_ss, k0, a.seq_k);
    load_rows<D, kBlockK>(vs, v, a.v_ss, k0, a.seq_k);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint16_t* p = ks + (n * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(p),
                                *reinterpret_cast<const uint32_t*>(p + 8)};
        Mma<T>::run(s[n], qf[kk], bf);
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        s[n][e] = visible(a, row, col) ? s[n][e] * a.scale : kNegInf;
        if (e < 2) mx0 = fmaxf(mx0, s[n][e]);
        else mx1 = fmaxf(mx1, s[n][e]);
      }
    // the four threads of a fragment group hold one row between them
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const bool live0 = mn0 > 0.5f * kNegInf, live1 = mn1 > 0.5f * kNegInf;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = live0 ? __expf(s[n][0] - mn0) : 0.f;
      s[n][1] = live0 ? __expf(s[n][1] - mn0) : 0.f;
      s[n][2] = live1 ? __expf(s[n][2] - mn1) : 0.f;
      s[n][3] = live1 ? __expf(s[n][3] - mn1) : 0.f;
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      // the S accumulator of n-tiles 2kk, 2kk+1 is the A fragment of P V
      const uint32_t pf[4] = {Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                              Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                              Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const uint16_t* p = vs + (kk * 16 + 2 * t) * LD + n * 8 + g;
        const uint32_t bf[2] = {pair(p[0], p[LD]), pair(p[8 * LD], p[9 * LD])};
        Mma<T>::run(acc[n], pf, bf);
      }
    }
  }

  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  uint32_t* o = static_cast<uint32_t*>(a.o);   // pairs of output values
  if (row0 < a.seq_q) {
    const long long base = ((static_cast<long long>(b) * a.seq_q + row0) * a.heads + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[(base + n * 8 + 2 * t) / 2] = Mma<T>::pack(acc[n][0] / L0, acc[n][1] / L0);
    if (t == 0)
      a.lse[static_cast<long long>(blockIdx.y) * a.seq_q + row0] = m0 + logf(L0);
  }
  if (row1 < a.seq_q) {
    const long long base = ((static_cast<long long>(b) * a.seq_q + row1) * a.heads + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[(base + n * 8 + 2 * t) / 2] = Mma<T>::pack(acc[n][2] / L1, acc[n][3] / L1);
    if (t == 0)
      a.lse[static_cast<long long>(blockIdx.y) * a.seq_q + row1] = m1 + logf(L1);
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
                   const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
size_t f32_smem() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1) + kBlockQ);
}

template <int D>
size_t mma_smem() {
  return sizeof(uint16_t) * (kBlockQ + 2 * kBlockK) * (D + 8);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. head_dim: 64 or 128.
// Returns a cudaError_t: the launch's own, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype,
    float scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0 ||
      static_cast<long long>(batch) * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse),
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               heads, seq_q, seq_k, scale, causal};
  const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, batch * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch(flash_fwd_f32<64>, f32_smem<64>(), grid, st, a);
  if (dtype == 0 && head_dim == 128)
    return launch(flash_fwd_f32<128>, f32_smem<128>(), grid, st, a);
  if (dtype == 1 && head_dim == 64)
    return launch(flash_fwd_mma<__nv_bfloat16, 64>, mma_smem<64>(), grid, st, a);
  if (dtype == 1 && head_dim == 128)
    return launch(flash_fwd_mma<__nv_bfloat16, 128>, mma_smem<128>(), grid, st, a);
  if (dtype == 2 && head_dim == 64)
    return launch(flash_fwd_mma<__half, 64>, mma_smem<64>(), grid, st, a);
  if (dtype == 2 && head_dim == 128)
    return launch(flash_fwd_mma<__half, 128>, mma_smem<128>(), grid, st, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
