// Flash-attention backward (FlashAttention-2) for Hopper, written by hand:
// K2 (dQ) and K3 (dK, dV).
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// paddle_tpu/ops/pallas/flash_attention.py (launched by the two
// `pallas_call`s of `_flash_bwd_bhsd`, behind the `_flash_attention`
// custom_vjp). Same function: P = exp(S * scale - lse) recomputed from the
// forward's per-row LSE under the mask (the guard, not exp underflow,
// keeps P at 0 for rows that see no key, whose LSE is about -1e30);
// dP = dO V^T; dS = P * (dP - Delta) * scale with Delta = rowsum(dO * O)
// computed outside (as the JAX package does); dQ = dS K, dK = dS^T Q,
// dV = P^T dO; the bottom-right causal offset `seq_k - seq_q`; P and dS
// rounded to the input type before their products, as the TPU kernels
// round `p.astype(do.dtype)` and `ds.astype(k.dtype)`.
//
// Translation. The TPU splits the backward in two kernels so that neither
// needs atomics: dQ sums over key tiles, dK/dV over query tiles, each in
// VMEM scratch across the sequential innermost grid axis. The split stays
// (it keeps the gradients deterministic), and the sequential axis becomes
// a loop inside one thread block:
//   * K2: one block per (batch*head, 64-query tile), looping over key
//     tiles up to the diagonal (K1's structure and fragment layout).
//   * K3: one block per (batch*head, 64-key tile), looping over query
//     tiles from the diagonal on. It computes the transposed score tile
//     S^T = K Q^T directly, with lse and Delta indexed per column, so
//     P^T and dS^T come out of the accumulator already in the layout that
//     `mma.sync.m16n8k16` takes as its A operand: no transpose of P.
// Inputs are read in their BSHD layout through the strides the wrapper
// passes (q, k and v are views into the fused qkv projection); dq, dk and
// dv are written contiguous (B, S, H, D); lse and Delta are (B, H, seq_q)
// fp32.
//
// Two bodies, one function each kernel:
//   * bf16 / fp16: four warps, 16 rows each, products on the tensor cores
//     through `mma.sync.m16n8k16` with fp32 accumulation.
//   * fp32: plain FMA on the CUDA cores (tensor cores would round the
//     inputs to TF32), S/dS through shared memory.
// At D = 128, K3 walks 32-query tiles, so that the dK and dV accumulators
// (D fp32 registers a thread) and the score tiles fit in registers.
//
// Bound at the GPT-2 345M training shape (B=8, S=1024, H=16, d=64, bf16,
// causal), per call: q, k, v, o, dO are 16.78 MB each. K2 reads q, k, v,
// dO, lse and Delta and writes dQ: 84.9 MB, 25.3 us at 3.35 TB/s; it
// does 3 products of 2d FLOPs for each of the 524,800 visible (q, k)
// pairs of each of the 128 heads, 25.8 GFLOP, 26.1 us at 989 TFLOP/s.
// K3 reads the same and writes dK and dV: 101.7 MB, 30.4 us; 4 products,
// 34.4 GFLOP, 34.8 us. Both are bound by operations. What the design does
// about it: no (S, S) matrix leaves the chip, and all products run on the
// tensor cores. What it does not do yet: loads are synchronous (no
// cp.async/TMA ring), the products use mma.sync rather than wgmma, and
// K and V tiles are re-read from L2 by every query tile; that is later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;       // query tile of K2, key tile of K3
constexpr int kThreads = 128;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, H, seq_q), fp32
  const float* delta;   // (B, H, seq_q), fp32
  void* dq;             // (B, seq_q, H, D), contiguous, input type
  void* dk;             // (B, seq_k, H, D), contiguous, input type
  void* dv;
  long long q_sb, q_ss, q_sh;   // element strides of the BSHD inputs
  long long k_sb, k_ss, k_sh;   // (the head dim is contiguous)
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;   // of dO
  int heads, seq_q, seq_k;
  float scale;
  int causal;
};

__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  return row < a.seq_q && col < a.seq_k &&
         (!a.causal || row + (a.seq_k - a.seq_q) >= col);
}

// K2: key tiles the query tile starting at q0 must visit (all, or those
// that start at or before the last key its last row sees).
__device__ __forceinline__ int dq_key_tiles(const Args& a, int q0) {
  int n = (a.seq_k + kBlock - 1) / kBlock;
  if (a.causal) {
    const int last = q0 + kBlock - 1 + (a.seq_k - a.seq_q);
    n = last < 0 ? 0 : min(n, last / kBlock + 1);
  }
  return n;
}

// K3: the first query tile (of BQ rows) that sees a key of the tile
// starting at k0: tile i runs when k0 <= i*BQ + BQ - 1 + (seq_k - seq_q).
template <int BQ>
__device__ __forceinline__ int dkv_first_query_tile(const Args& a, int k0) {
  if (!a.causal) return 0;
  const int t = k0 - (a.seq_k - a.seq_q) - (BQ - 1);
  return t <= 0 ? 0 : (t + BQ - 1) / BQ;
}

__device__ __forceinline__ long long out_row(const Args& a, int b, int h,
                                             int seq, int row, int d) {
  return ((static_cast<long long>(b) * seq + row) * a.heads + h) * d;
}

// ------------------------------------------------------------ fp32 bodies

// ROWS rows of D floats from a strided source into a shared tile of row
// pitch D + 1; rows at or past `limit` are 0.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long stride, int row0,
                                              int limit) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = row0 + r < limit ? src[(row0 + r) * stride + c] : 0.f;
  }
}

// lse and Delta of BQ query rows from q0 into shared memory (0 past the end).
template <int BQ>
__device__ __forceinline__ void load_row_stats(const Args& a, float* lse,
                                               float* delta, int q0) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool ok = q0 + r < a.seq_q;
    const long long at = static_cast<long long>(blockIdx.y) * a.seq_q + q0 + r;
    lse[r] = ok ? a.lse[at] : 0.f;
    delta[r] = ok ? a.delta[at] : 0.f;
  }
}

// K2, fp32. 128 threads; thread (ty, tx) owns query rows ty*8.. of S/dP
// (columns tx + 16c) and of dQ (columns tx + 16n).
template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32(const Args a) {
  constexpr int LD = D + 1, PLD = kBlock + 1, NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* dos = qs + kBlock * LD;
  float* ks = dos + kBlock * LD;
  float* vs = ks + kBlock * LD;
  float* dss = vs + kBlock * LD;
  float* lse = dss + kBlock * PLD;
  float* delta = lse + kBlock;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;   // heaviest first
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dout = static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_rows_f32<D, kBlock>(qs, q, a.q_ss, q0, a.seq_q);
  load_rows_f32<D, kBlock>(dos, dout, a.o_ss, q0, a.seq_q);
  load_row_stats<kBlock>(a, lse, delta, q0);
  const int ty = tid / 16, tx = tid % 16;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;

  const int n_kv = dq_key_tiles(a, q0);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();   // the previous tile's K and dS are consumed
    load_rows_f32<D, kBlock>(ks, k, a.k_ss, k0, a.seq_k);
    load_rows_f32<D, kBlock>(vs, v, a.v_ss, k0, a.seq_k);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; ++kk) {
      float qa[8], da[8], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qa[i] = qs[(ty * 8 + i) * LD + kk];
        da[i] = dos[(ty * 8 + i) * LD + kk];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kb[c] = ks[(tx + 16 * c) * LD + kk];
        vb[c] = vs[(tx + 16 * c) * LD + kk];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qa[i], kb[c], s[i][c]);
          dp[i][c] = fmaf(da[i], vb[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty * 8 + i, col = tx + 16 * c;
        const float p = visible(a, q0 + r, k0 + col)
                            ? expf(s[i][c] * a.scale - lse[r]) : 0.f;
        dss[r * PLD + col] = p * (dp[i][c] - delta[r]) * a.scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlock; ++kk) {
      float sa[8], kb[NC];
#pragma unroll
      for (int i = 0; i < 8; ++i) sa[i] = dss[(ty * 8 + i) * PLD + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) kb[n] = ks[kk * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(sa[i], kb[n], acc[i][n]);
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qp = q0 + ty * 8 + i;
    if (qp >= a.seq_q) continue;
    float* row = dq + out_row(a, b, h, a.seq_q, qp, D);
#pragma unroll
    for (int n = 0; n < NC; ++n) row[tx + 16 * n] = acc[i][n];
  }
}

// K3, fp32. Thread (ty, tx) owns keys ty*8.. of S^T/dP^T (query columns
// tx + 16c) and of dK/dV (columns tx + 16n).
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_f32(const Args a) {
  constexpr int BQ = D == 64 ? 64 : 32;    // query tile
  constexpr int CQ = BQ / 16;              // query columns a thread owns
  constexpr int LD = D + 1, PLD = BQ + 1, NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + kBlock * LD;
  float* qs = vs + kBlock * LD;
  float* dos = qs + BQ * LD;
  float* pts = dos + BQ * LD;
  float* dsts = pts + kBlock * PLD;
  float* lse = dsts + kBlock * PLD;
  float* delta = lse + BQ;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBlock;      // the first key tiles see the most
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* dout = static_cast<const float*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_rows_f32<D, kBlock>(ks, k, a.k_ss, k0, a.seq_k);
  load_rows_f32<D, kBlock>(vs, v, a.v_ss, k0, a.seq_k);
  const int ty = tid / 16, tx = tid % 16;
  float dk[8][NC], dv[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk[i][n] = dv[i][n] = 0.f;

  const int n_q = (a.seq_q + BQ - 1) / BQ;
  for (int it = dkv_first_query_tile<BQ>(a, k0); it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();   // the previous tile's Q, dO, P^T and dS^T are consumed
    load_rows_f32<D, BQ>(qs, q, a.q_ss, q0, a.seq_q);
    load_rows_f32<D, BQ>(dos, dout, a.o_ss, q0, a.seq_q);
    load_row_stats<BQ>(a, lse, delta, q0);
    __syncthreads();

    float st[8][CQ], dpt[8][CQ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < CQ; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; ++kk) {
      float ka[8], va[8], qb[CQ], db[CQ];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ka[i] = ks[(ty * 8 + i) * LD + kk];
        va[i] = vs[(ty * 8 + i) * LD + kk];
      }
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        qb[c] = qs[(tx + 16 * c) * LD + kk];
        db[c] = dos[(tx + 16 * c) * LD + kk];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CQ; ++c) {
          st[i][c] = fmaf(ka[i], qb[c], st[i][c]);
          dpt[i][c] = fmaf(va[i], db[c], dpt[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < CQ; ++c) {
        const int key = ty * 8 + i, col = tx + 16 * c;
        const float p = visible(a, q0 + col, k0 + key)
                            ? expf(st[i][c] * a.scale - lse[col]) : 0.f;
        pts[key * PLD + col] = p;
        dsts[key * PLD + col] = p * (dpt[i][c] - delta[col]) * a.scale;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BQ; ++kk) {
      float pa[8], sa[8], ob[NC], qb[NC];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pa[i] = pts[(ty * 8 + i) * PLD + kk];
        sa[i] = dsts[(ty * 8 + i) * PLD + kk];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        ob[n] = dos[kk * LD + tx + 16 * n];
        qb[n] = qs[kk * LD + tx + 16 * n];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          dv[i][n] = fmaf(pa[i], ob[n], dv[i][n]);
          dk[i][n] = fmaf(sa[i], qb[n], dk[i][n]);
        }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kp = k0 + ty * 8 + i;
    if (kp >= a.seq_k) continue;
    const long long base = out_row(a, b, h, a.seq_k, kp, D);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dkp[base + tx + 16 * n] = dk[i][n];
      dvp[base + tx + 16 * n] = dv[i][n];
    }
  }
}

// ----------------------------------------------------- bf16 / fp16 bodies

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

__device__ __forceinline__ uint32_t word(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// The A fragment (rows r0 + g, r0 + g + 8; k-step kk) of a row-major tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t* f, const uint16_t* tile,
                                       int r0, int kk, int g, int t) {
  const uint16_t* p = tile + (r0 + g) * LD + kk * 16 + 2 * t;
  f[0] = word(p);
  f[1] = word(p + 8 * LD);
  f[2] = word(p + 8);
  f[3] = word(p + 8 * LD + 8);
}

// The B fragment of X^T for n-tile n, k-step kk, where X is a row-major
// tile whose rows are the product's columns (S = Q K^T takes K this way).
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t* f, const uint16_t* tile,
                                        int n, int kk, int g, int t) {
  const uint16_t* p = tile + (n * 8 + g) * LD + kk * 16 + 2 * t;
  f[0] = word(p);
  f[1] = word(p + 8);
}

// The B fragment of X itself for n-tile n, k-step kk (k runs down X's
// rows: dQ = dS K takes K this way).
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t* f, const uint16_t* tile,
                                       int n, int kk, int g, int t) {
  const uint16_t* p = tile + (kk * 16 + 2 * t) * LD + n * 8 + g;
  f[0] = pair(p[0], p[LD]);
  f[1] = pair(p[8 * LD], p[9 * LD]);
}

// The accumulator of n-tiles 2kk and 2kk+1, rounded to T, as the A
// fragment of k-step kk of the next product.
template <typename T>
__device__ __forceinline__ void acc_as_a(uint32_t* f, float (*c)[4],
                                         int kk) {
  f[0] = Mma<T>::pack(c[2 * kk][0], c[2 * kk][1]);
  f[1] = Mma<T>::pack(c[2 * kk][2], c[2 * kk][3]);
  f[2] = Mma<T>::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  f[3] = Mma<T>::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Write a warp's 16 x D fp32 accumulator as rows r0 + g and r0 + g + 8 of a
// contiguous (B, seq, H, D) output of type T.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const Args& a, void* dst, int b,
                                           int h, int seq, int r0, int g,
                                           int t, float (*acc)[4]) {
  uint32_t* o = static_cast<uint32_t*>(dst);   // pairs of output values
  const int rows[2] = {r0 + g, r0 + g + 8};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (rows[half] >= seq) continue;
    const long long base = out_row(a, b, h, seq, rows[half], D);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      o[(base + n * 8 + 2 * t) / 2] =
          Mma<T>::pack(acc[n][2 * half], acc[n][2 * half + 1]);
  }
}

// K2, bf16/fp16: warp w owns query rows 16w.. of the tile.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_mma(const Args a) {
  constexpr int LD = D + 8;          // +16 bytes a row: fragment reads hit 32 banks
  constexpr int NS = kBlock / 8;     // S/dP n-tiles a warp owns (16 x 64)
  constexpr int NO = D / 8;          // dQ n-tiles (16 x D)
  constexpr int KD = D / 16;         // k-steps over the head dim
  constexpr int KK = kBlock / 16;    // k-steps over the keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* qs = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* dos = qs + kBlock * LD;
  uint16_t* ks = dos + kBlock * LD;
  uint16_t* vs = ks + kBlock * LD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;   // heaviest first
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const uint16_t* q = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const uint16_t* dout = static_cast<const uint16_t*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_rows<D, kBlock>(qs, q, a.q_ss, q0, a.seq_q);
  load_rows<D, kBlock>(dos, dout, a.o_ss, q0, a.seq_q);
  const int wr = warp * 16;
  const int row0 = q0 + wr + g, row1 = row0 + 8;   // the two rows a thread holds
  const long long at = static_cast<long long>(blockIdx.y) * a.seq_q;
  const float lse0 = row0 < a.seq_q ? a.lse[at + row0] : 0.f;
  const float lse1 = row1 < a.seq_q ? a.lse[at + row1] : 0.f;
  const float dl0 = row0 < a.seq_q ? a.delta[at + row0] : 0.f;
  const float dl1 = row1 < a.seq_q ? a.delta[at + row1] : 0.f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_kv = dq_key_tiles(a, q0);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlock;
    __syncthreads();   // Q/dO are loaded; the previous K/V are consumed
    load_rows<D, kBlock>(ks, k, a.k_ss, k0, a.seq_k);
    load_rows<D, kBlock>(vs, v, a.v_ss, k0, a.seq_k);
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[4], df[4];
      frag_a<LD>(qf, qs, wr, kk, g, t);
      frag_a<LD>(df, dos, wr, kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t kf[2], vf[2];
        frag_bt<LD>(kf, ks, n, kk, g, t);
        frag_bt<LD>(vf, vs, n, kk, g, t);
        Mma<T>::run(s[n], qf, kf);
        Mma<T>::run(dp[n], df, vf);
      }
    }

    // s becomes dS = P * (dP - Delta) * scale, P under the mask guard
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const bool top = e < 2;
        const float p = visible(a, top ? row0 : row1, col)
                            ? __expf(s[n][e] * a.scale - (top ? lse0 : lse1))
                            : 0.f;
        s[n][e] = p * (dp[n][e] - (top ? dl0 : dl1)) * a.scale;
      }

#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t sf[4];
      acc_as_a<T>(sf, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t kf[2];
        frag_b<LD>(kf, ks, n, kk, g, t);
        Mma<T>::run(acc[n], sf, kf);
      }
    }
  }
  store_rows<T, D>(a, a.dq, b, h, a.seq_q, q0 + wr, g, t, acc);
}

// K3, bf16/fp16: warp w owns keys 16w.. of the tile; the scores are
// computed transposed (keys as rows, queries as columns).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkv_mma(const Args a) {
  constexpr int BQ = D == 64 ? 64 : 32;   // query tile
  constexpr int LD = D + 8;
  constexpr int NS = BQ / 8;              // S^T/dP^T n-tiles a warp owns (16 x BQ)
  constexpr int NO = D / 8;               // dK/dV n-tiles (16 x D)
  constexpr int KD = D / 16;
  constexpr int KQ = BQ / 16;             // k-steps over the queries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vs = ks + kBlock * LD;
  uint16_t* qs = vs + kBlock * LD;
  uint16_t* dos = qs + BQ * LD;
  float* lse = reinterpret_cast<float*>(dos + BQ * LD);
  float* delta = lse + BQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBlock;      // the first key tiles see the most
  const int b = blockIdx.y / a.heads, h = blockIdx.y % a.heads;
  const uint16_t* q = static_cast<const uint16_t*>(a.q) + b * a.q_sb + h * a.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(a.k) + b * a.k_sb + h * a.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(a.v) + b * a.v_sb + h * a.v_sh;
  const uint16_t* dout = static_cast<const uint16_t*>(a.dout) + b * a.o_sb + h * a.o_sh;

  load_rows<D, kBlock>(ks, k, a.k_ss, k0, a.seq_k);
  load_rows<D, kBlock>(vs, v, a.v_ss, k0, a.seq_k);
  const int wk = warp * 16;
  const int key0 = k0 + wk + g, key1 = key0 + 8;   // the two keys a thread holds

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_q = (a.seq_q + BQ - 1) / BQ;
  for (int it = dkv_first_query_tile<BQ>(a, k0); it < n_q; ++it) {
    const int q0 = it * BQ;
    __syncthreads();   // K/V are loaded; the previous Q/dO/lse/Delta are consumed
    load_rows<D, BQ>(qs, q, a.q_ss, q0, a.seq_q);
    load_rows<D, BQ>(dos, dout, a.o_ss, q0, a.seq_q);
    load_row_stats<BQ>(a, lse, delta, q0);
    __syncthreads();

    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t kf[4], vf[4];
      frag_a<LD>(kf, ks, wk, kk, g, t);
      frag_a<LD>(vf, vs, wk, kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t qf[2], df[2];
        frag_bt<LD>(qf, qs, n, kk, g, t);
        frag_bt<LD>(df, dos, n, kk, g, t);
        Mma<T>::run(st[n], kf, qf);     // S^T = K Q^T
        Mma<T>::run(dpt[n], vf, df);    // dP^T = V dO^T
      }
    }

    // st becomes P^T and dpt becomes dS^T, lse and Delta by column
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const float p = visible(a, q0 + col, e < 2 ? key0 : key1)
                            ? __expf(st[n][e] * a.scale - lse[col]) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - delta[col]) * a.scale;
      }

#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t pf[4], sf[4];
      acc_as_a<T>(pf, st, kk);
      acc_as_a<T>(sf, dpt, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t of[2], qf[2];
        frag_b<LD>(of, dos, n, kk, g, t);
        frag_b<LD>(qf, qs, n, kk, g, t);
        Mma<T>::run(dv[n], pf, of);     // dV += P^T dO
        Mma<T>::run(dk[n], sf, qf);     // dK += dS^T Q
      }
    }
  }
  store_rows<T, D>(a, a.dk, b, h, a.seq_k, k0 + wk, g, t, dk);
  store_rows<T, D>(a, a.dv, b, h, a.seq_k, k0 + wk, g, t, dv);
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
size_t dq_f32_smem() {
  return sizeof(float) * (4 * kBlock * (D + 1) + kBlock * (kBlock + 1) + 2 * kBlock);
}

template <int D>
size_t dkv_f32_smem() {
  constexpr int BQ = D == 64 ? 64 : 32;
  return sizeof(float) * (2 * kBlock * (D + 1) + 2 * BQ * (D + 1) +
                          2 * kBlock * (BQ + 1) + 2 * BQ);
}

template <int D>
size_t dq_mma_smem() {
  return sizeof(uint16_t) * 4 * kBlock * (D + 8);
}

template <int D>
size_t dkv_mma_smem() {
  constexpr int BQ = D == 64 ? 64 : 32;
  return sizeof(uint16_t) * (2 * kBlock + 2 * BQ) * (D + 8) + sizeof(float) * 2 * BQ;
}

bool valid(int batch, int heads, int seq_q, int seq_k) {
  return batch > 0 && heads > 0 && seq_q > 0 && seq_k > 0 &&
         static_cast<long long>(batch) * heads <= 65535;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, const long long* st, int heads, int seq_q,
               int seq_k, float scale, int causal) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), dq, dk, dv,
              st[0], st[1], st[2], st[3], st[4], st[5],
              st[6], st[7], st[8], st[9], st[10], st[11],
              heads, seq_q, seq_k, scale, causal};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. head_dim: 64 or 128.
// Strides are the element strides (batch, seq, head) of q, k, v and dO.
// Each returns a cudaError_t: the launch's own, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype,
    float scale, int causal, void* stream) {
  if (!valid(batch, heads, seq_q, seq_k))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                           st, heads, seq_q, seq_k, scale, causal);
  const dim3 grid((seq_q + kBlock - 1) / kBlock, batch * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch(dq_f32<64>, dq_f32_smem<64>(), grid, s, a);
  if (dtype == 0 && head_dim == 128)
    return launch(dq_f32<128>, dq_f32_smem<128>(), grid, s, a);
  if (dtype == 1 && head_dim == 64)
    return launch(dq_mma<__nv_bfloat16, 64>, dq_mma_smem<64>(), grid, s, a);
  if (dtype == 1 && head_dim == 128)
    return launch(dq_mma<__nv_bfloat16, 128>, dq_mma_smem<128>(), grid, s, a);
  if (dtype == 2 && head_dim == 64)
    return launch(dq_mma<__half, 64>, dq_mma_smem<64>(), grid, s, a);
  if (dtype == 2 && head_dim == 128)
    return launch(dq_mma<__half, 128>, dq_mma_smem<128>(), grid, s, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int batch, int heads, int seq_q, int seq_k, int head_dim, int dtype,
    float scale, int causal, void* stream) {
  if (!valid(batch, heads, seq_q, seq_k))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv,
                           st, heads, seq_q, seq_k, scale, causal);
  const dim3 grid((seq_k + kBlock - 1) / kBlock, batch * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch(dkv_f32<64>, dkv_f32_smem<64>(), grid, s, a);
  if (dtype == 0 && head_dim == 128)
    return launch(dkv_f32<128>, dkv_f32_smem<128>(), grid, s, a);
  if (dtype == 1 && head_dim == 64)
    return launch(dkv_mma<__nv_bfloat16, 64>, dkv_mma_smem<64>(), grid, s, a);
  if (dtype == 1 && head_dim == 128)
    return launch(dkv_mma<__nv_bfloat16, 128>, dkv_mma_smem<128>(), grid, s, a);
  if (dtype == 2 && head_dim == 64)
    return launch(dkv_mma<__half, 64>, dkv_mma_smem<64>(), grid, s, a);
  if (dtype == 2 && head_dim == 128)
    return launch(dkv_mma<__half, 128>, dkv_mma_smem<128>(), grid, s, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
