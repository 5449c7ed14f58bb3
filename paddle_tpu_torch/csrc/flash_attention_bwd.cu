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
// a loop inside one thread block: K2 owns query rows and walks key tiles
// up to the diagonal, K3 owns keys and walks query tiles from the
// diagonal on. Inputs are read in their BSHD layout through the strides
// the wrapper passes (q, k and v are views into the fused qkv projection,
// dO may be a strided view); dq, dk and dv are written contiguous
// (B, S, H, D); lse and Delta are (B, H, seq_q) fp32.
//
// Two bodies, one function each kernel:
//   * bf16 / fp16, `dq_wgmma` and `dkv_wgmma`: warp-specialized, as K1's
//     `flash_fwd_wgmma` (csrc/flash_attention_fwd.cu). A block has two
//     consumer warpgroups of 64 rows each and a producer warpgroup that
//     keeps 24 registers a thread and hands the rest to the consumers
//     (`setmaxnreg`: 240 each). Every input is read through a 4-D BSHD
//     tensor map encoded per call (dims d, S, H, B; 128-byte swizzle, rows
//     of 64 values, a d = 128 row is two boxes), TMA's zero fill covers the
//     ragged tails, and each ring stage is guarded by a `full` mbarrier
//     (bytes landed) and an `empty` one (both consumer warpgroups done).
//     All products are `wgmma` with fp32 accumulators in registers.
//     - K2: 128 query rows a block; Q and dO are loaded once, then K/V
//       tiles (128 keys at d = 64, 64 at d = 128, where dQ's 64
//       accumulators a thread leave no room for 128-key S and dP) run
//       through a 3-stage ring. A tile: S = Q K^T and dP = dO V^T
//       (both operands K-major in shared memory, issued as two commit
//       groups so P's exponentials run while dP is in flight); P and dS in
//       registers in log2 units, the mask only on tiles that cross the
//       diagonal or the end of the keys; dS rounded to T is the register A
//       operand of dQ += dS K, with K read MN-major from the same stage.
//       Heaviest query tiles first; dQ staged through the warpgroup's own
//       Q rows and stored with 16-byte writes. lse and Delta: two rows a
//       thread, read once.
//     - K3: 128 keys a block; K and V are loaded once, then 64-row query
//       tiles (Q, dO, and their lse and Delta, which the producer warp
//       stores into the stage with plain loads before it arrives on the
//       stage's barrier) run through a ring (4 stages at d = 64, 3 at
//       d = 128). The scores are computed transposed, S^T = K Q^T and
//       dP^T = V dO^T, with lse and Delta indexed per column, so P^T and
//       dS^T come out of the accumulator in the layout of wgmma's register
//       A operand: dV += P^T dO and dK += dS^T Q read dO and Q MN-major
//       from the stage. At d = 64, dV's product runs while dS^T is
//       computed (at d = 128 the registers do not allow it). The ring
//       starts at the first query tile that sees the block's first key;
//       the second warpgroup, whose keys are seen later, waits on and
//       releases the stages before its own first tile without work. The
//       first key tiles (which see the most queries) are scheduled first;
//       dK and dV are staged through the warpgroup's K and V rows.
//   * fp32: plain FMA on the CUDA cores (tensor cores would round the
//     inputs to TF32), S/dS through shared memory; at D = 128, K3 walks
//     32-query tiles, so that the dK and dV accumulators fit in registers.
//
// Bounds, per call, bf16, causal. GPT-2 345M training (B=8, S=1024,
// H=16, d=64): q, k, v, o, dO are 16.78 MB each. K2 reads q, k, v, dO,
// lse and Delta and writes dQ: 84.9 MB, 25.3 us at 3.35 TB/s; it does 3
// products of 2d FLOPs for each of the 524,800 visible (q, k) pairs of
// each of the 128 heads, 25.8 GFLOP, 26.1 us at 989 TFLOP/s. K3 reads
// the same and writes dK and dV: 101.7 MB, 30.4 us; 4 products, 34.4
// GFLOP, 34.8 us. LLaMA-770M (B=4, S=2048, H=12, d=128; 2,098,176 pairs
// a head, 48 heads): K2 77.4 GFLOP, 78 us; K3 103.1 GFLOP, 104 us. All
// four are bound by operations. What the design does about it: no (S, S)
// matrix leaves the chip, every product runs on wgmma at m64, the loads
// run ahead of the math in the TMA ring, and each block reads its own
// rows once and the other operand's tiles once per block (from L2 when
// another block of the head has read them).

#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;       // fp32 bodies: query tile of K2, key tile of K3
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

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

// Key tiles of `bn` keys that rows up to `last_row` must visit: all of
// them, or, when causal, those that start at or before the last key that
// row sees.
__device__ __forceinline__ int key_tiles(const Args& a, int last_row, int bn) {
  int n = (a.seq_k + bn - 1) / bn;
  if (a.causal) {
    const int last = last_row + (a.seq_k - a.seq_q);
    n = last < 0 ? 0 : min(n, last / bn + 1);
  }
  return n;
}

// Leading key tiles that every row from `first_row` on sees whole: no
// causal cut and no end of the keys inside them.
__device__ __forceinline__ int full_key_tiles(const Args& a, int first_row, int bn) {
  int n = a.seq_k / bn;
  if (a.causal) {
    const int f = first_row + (a.seq_k - a.seq_q) + 1;
    n = f <= 0 ? 0 : min(n, f / bn);
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

  const int n_kv = key_tiles(a, q0 + kBlock - 1, kBlock);
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

constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kMmaThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kRows = 128;    // K2: query rows a block owns; K3: keys
constexpr int kDkvQ = 64;     // K3: query rows a tile

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// The accumulator blocks 2kk, 2kk+1 of a 64 x 8N fp32 tile, rounded to T,
// as the register A operand of k16 step kk of the next product.
template <typename T, int N>
__device__ __forceinline__ void acc_as_a(uint32_t (&f)[N / 16][4],
                                         const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    f[kk][0] = hopper::pack2<T>(c[8 * kk], c[8 * kk + 1]);
    f[kk][1] = hopper::pack2<T>(c[8 * kk + 2], c[8 * kk + 3]);
    f[kk][2] = hopper::pack2<T>(c[8 * kk + 4], c[8 * kk + 5]);
    f[kk][3] = hopper::pack2<T>(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// A warpgroup's 64 x D accumulator, rounded to T, into 64 rows of a tile
// in the 128-byte swizzle (64-column blocks `blk` bytes apart).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(unsigned char* tile, int blk,
                                           const float (&acc)[D / 2]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x % 128) / 32 * 16 + g;   // r0, r0 + 8: both r % 8 == g
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    unsigned char* p = tile + (n / 8) * blk + (((n % 8) ^ g) * 16) + 4 * t;
    *reinterpret_cast<uint32_t*>(p + r0 * 128) = hopper::pack2<T>(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(p + (r0 + 8) * 128) =
        hopper::pack2<T>(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// The 64 staged rows from `first` on, those below `seq`, into a contiguous
// (B, seq, H, D) output with 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const Args& a, const unsigned char* tile,
                                           int blk, void* out, int b, int h,
                                           int seq, int first) {
  constexpr int kChunks = D / 8;   // 16-byte pieces of a row
  for (int i = threadIdx.x % 128; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks;
    if (first + r >= seq) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + (ch / 8) * blk + r * 128 + (((ch % 8) ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) +
                              out_row(a, b, h, seq, first + r, D) + ch * 8) = v;
  }
}

template <int D>
struct DqLayout {
  static constexpr int kKeys = D == 64 ? 128 : 64;   // keys a K/V tile holds
  static constexpr int kStages = 3;
  static constexpr uint32_t kQBytes = kRows * D * 2;        // Q or dO
  static constexpr uint32_t kTileBytes = kKeys * D * 2;     // K or V
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + kStages * kStageBytes + (1 + 2 * kStages) * sizeof(uint64_t);
};

// Pin `x` here: the compiler may not compute from it any earlier. Per-element
// mask tests hoisted above a tile's products would hold 32 predicates in
// registers beside the live accumulators.
__device__ __forceinline__ int pinned(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// K2: the end of the keys that `row` sees (0 for a row past seq_q).
__device__ __forceinline__ int row_key_end(const Args& a, int row) {
  if (row >= a.seq_q) return 0;
  return a.causal ? min(a.seq_k, row + (a.seq_k - a.seq_q) + 1) : a.seq_k;
}

// K2, one key tile for one consumer warpgroup: S = Q K^T, dP = dO V^T,
// dS = P (dP - Delta) scale, dQ += dS K. `nl` is -lse * log2(e), `dl`
// Delta and `kend` the end of the keys seen, of the thread's two rows.
// MASK applies `kend` per element: the causal cut, the end of the keys and
// the end of the queries.
template <typename T, int D, bool MASK>
__device__ __forceinline__ void dq_tile(const unsigned char* q_wg,
                                        const unsigned char* do_wg,
                                        const unsigned char* ks,
                                        const unsigned char* vs, int k0, int kend0,
                                        int kend1, float nl0, float nl1, float dl0,
                                        float dl1, float sl2, float scale,
                                        float (&dq)[D / 2]) {
  using hopper::desc_sw128;
  constexpr int BN = DqLayout<D>::kKeys;
  constexpr int kBlkQ = kRows * 128;   // bytes of a 64-column block of Q or dO
  const int t = threadIdx.x & 3;

  float s[BN / 2], dp[BN / 2];
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // k16 step kk: column block kk / 4 of the rows, 32 bytes in per step
    const int blk = kk / 4, off = (kk % 4) * 32;
    hopper::Wgmma<T, BN>::ss(s, desc_sw128(q_wg + blk * kBlkQ + off, 16, 1024),
                             desc_sw128(ks + blk * BN * 128 + off, 16, 1024), kk);
  }
  hopper::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk / 4, off = (kk % 4) * 32;
    hopper::Wgmma<T, BN>::ss(dp, desc_sw128(do_wg + blk * kBlkQ + off, 16, 1024),
                             desc_sw128(vs + blk * BN * 128 + off, 16, 1024), kk);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();   // S has landed; dP is still in flight
  hopper::fence_regs(s);
  // column 8n + 2t + (e & 1) of the tile is seen when below lim
  const int lim0 = MASK ? pinned(kend0 - k0 - 2 * t) : 0;
  const int lim1 = MASK ? pinned(kend1 - k0 - 2 * t) : 0;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // select, never multiply: a blind row's exponent is about +1e30
      float p = exp2f(fmaf(s[4 * n + e], sl2, e < 2 ? nl0 : nl1));
      if (MASK && 8 * n + (e & 1) >= (e < 2 ? lim0 : lim1)) p = 0.f;
      s[4 * n + e] = p;
    }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dp);
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * n + e] = s[4 * n + e] * (dp[4 * n + e] - (e < 2 ? dl0 : dl1)) * scale;
  uint32_t ds[BN / 16][4];
  acc_as_a<T, BN>(ds, dp);
  hopper::fence_regs(dq);
  hopper::fence_regs(ds);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    // K (keys x d) read MN-major: 16 keys (2048 bytes) a k16 step, the
    // two 64-column blocks of d = 128 BN * 128 bytes apart
    hopper::Wgmma<T, D>::rs_t(dq, ds[kk], desc_sw128(ks + kk * 2048, BN * 128, 1024));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);
  hopper::fence_regs(ds);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = DqLayout<D>;
  constexpr int BN = L::kKeys;
  constexpr int kBlkQ = kRows * 128;   // bytes of a 64-column block of Q or dO
  constexpr int kBlkKV = BN * 128;     // ... of K or V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + L::kQBytes;
  unsigned char* kv = dos + L::kQBytes;   // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + L::kStages * L::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int n_kv = key_tiles(a, q0 + kRows - 1, BN);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers / 32);   // one arrival a warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one thread keeps the ring full
    hopper::reg_dealloc<24>();
    if (threadIdx.x == kConsumers && n_kv > 0) {
      hopper::mbar_expect_tx(q_full, 2 * L::kQBytes);
      for (int c = 0; c < D / 64; ++c) {
        hopper::tma_load_4d(qs + c * kBlkQ, &tq, q_full, c * 64, q0, h, b);
        hopper::tma_load_4d(dos + c * kBlkQ, &tdo, q_full, c * 64, q0, h, b);
      }
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % L::kStages;
        if (j >= L::kStages) hopper::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
        unsigned char* ks = kv + s * L::kStageBytes;
        hopper::mbar_expect_tx(&full[s], L::kStageBytes);
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(ks + c * kBlkKV, &tk, &full[s], c * 64, j * BN, h, b);
          hopper::tma_load_4d(ks + L::kTileBytes + c * kBlkKV, &tv, &full[s], c * 64,
                              j * BN, h, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: query rows first .. first + 63
  hopper::reg_alloc<240>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2;
  const int first = q0 + wg * 64;
  const int row0 = first + warp * 16 + g, row1 = row0 + 8;   // a thread's two rows
  const int n_mine = key_tiles(a, first + 63, BN);
  const int n_full = min(n_mine, full_key_tiles(a, first, BN));
  const float sl2 = a.scale * kLog2e;
  const long long at = static_cast<long long>(bh) * a.seq_q;
  const float nl0 = row0 < a.seq_q ? -a.lse[at + row0] * kLog2e : 0.f;
  const float nl1 = row1 < a.seq_q ? -a.lse[at + row1] * kLog2e : 0.f;
  const float dl0 = row0 < a.seq_q ? a.delta[at + row0] : 0.f;
  const float dl1 = row1 < a.seq_q ? a.delta[at + row1] : 0.f;
  const int kend0 = row_key_end(a, row0), kend1 = row_key_end(a, row1);
  unsigned char* q_wg = qs + wg * 64 * 128;
  const unsigned char* do_wg = dos + wg * 64 * 128;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  if (n_kv > 0) hopper::mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % L::kStages;
    hopper::mbar_wait(&full[s], (j / L::kStages) & 1);
    const unsigned char* ks = kv + s * L::kStageBytes;
    if (j < n_full)
      dq_tile<T, D, false>(q_wg, do_wg, ks, ks + L::kTileBytes, j * BN, kend0, kend1,
                           nl0, nl1, dl0, dl1, sl2, a.scale, dq);
    else if (j < n_mine)   // the diagonal and the end of the keys
      dq_tile<T, D, true>(q_wg, do_wg, ks, ks + L::kTileBytes, j * BN, kend0, kend1,
                          nl0, nl1, dl0, dl1, sl2, a.scale, dq);
    // a warpgroup whose rows see fewer tiles still releases every stage
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // dQ through the warpgroup's own Q rows (its last product has read them)
  hopper::bar_sync(1 + wg, 128);
  stage_rows<T, D>(q_wg, kBlkQ, dq);
  hopper::bar_sync(1 + wg, 128);
  store_rows<D>(a, q_wg, kBlkQ, a.dq, b, h, a.seq_q, first);
}

template <int D>
struct DkvLayout {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr uint32_t kKVBytes = kRows * D * 2;       // K or V
  static constexpr uint32_t kTileBytes = kDkvQ * D * 2;     // Q or dO
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr uint32_t kStatBytes = 2 * kDkvQ * 4;     // lse, Delta
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes + kStages * kStageBytes +
                                  kStages * kStatBytes +
                                  (1 + 2 * kStages) * sizeof(uint64_t);
};

// K3: issue dV += P^T dO (one commit group); dO (queries x d) is read
// MN-major, 16 queries (2048 bytes) a k16 step.
template <typename T, int D>
__device__ __forceinline__ void issue_dv(float (&dv)[D / 2], uint32_t (&pt)[kDkvQ / 16][4],
                                         const unsigned char* dos) {
  hopper::fence_regs(dv);
  hopper::fence_regs(pt);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDkvQ / 16; ++kk)
    hopper::Wgmma<T, D>::rs_t(dv, pt[kk],
                              hopper::desc_sw128(dos + kk * 2048, kDkvQ * 128, 1024));
  hopper::wgmma_commit();
}

// K3: the queries [qbeg, qend) that see `key` (none for a key past seq_k).
__device__ __forceinline__ int2 key_query_range(const Args& a, int key) {
  if (key >= a.seq_k) return make_int2(0, 0);
  return make_int2(a.causal ? key - (a.seq_k - a.seq_q) : 0, a.seq_q);
}

// K3, one query tile for one consumer warpgroup: S^T = K Q^T,
// dP^T = V dO^T, dV += P^T dO, dK += dS^T Q. `stat` holds the tile's
// lse * log2(e), then its Delta, by query; `qr` the queries that see each
// of the thread's two keys. MASK applies `qr` per element: the causal cut,
// the end of the keys and the end of the queries.
template <typename T, int D, bool MASK>
__device__ __forceinline__ void dkv_tile(const unsigned char* k_wg,
                                         const unsigned char* v_wg,
                                         const unsigned char* qs,
                                         const unsigned char* dos, const float* stat,
                                         int q0, int2 qr0, int2 qr1, float sl2,
                                         float scale, float (&dk)[D / 2],
                                         float (&dv)[D / 2]) {
  using hopper::desc_sw128;
  constexpr int BQ = kDkvQ;
  constexpr int kBlkKV = kRows * 128;   // bytes of a 64-column block of K or V
  const int t = threadIdx.x & 3;

  float st[BQ / 2], dpt[BQ / 2];
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk / 4, off = (kk % 4) * 32;
    hopper::Wgmma<T, BQ>::ss(st, desc_sw128(k_wg + blk * kBlkKV + off, 16, 1024),
                             desc_sw128(qs + blk * BQ * 128 + off, 16, 1024), kk);
  }
  hopper::wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int blk = kk / 4, off = (kk % 4) * 32;
    hopper::Wgmma<T, BQ>::ss(dpt, desc_sw128(v_wg + blk * kBlkKV + off, 16, 1024),
                             desc_sw128(dos + blk * BQ * 128 + off, 16, 1024), kk);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();   // S^T has landed; dP^T is still in flight
  hopper::fence_regs(st);
  // column 8n + 2t + (e & 1) of the tile is seen from lo on, below hi
  const int o = q0 + 2 * t;
  const int lo0 = MASK ? pinned(qr0.x - o) : 0, hi0 = MASK ? pinned(qr0.y - o) : 0;
  const int lo1 = MASK ? pinned(qr1.x - o) : 0, hi1 = MASK ? pinned(qr1.y - o) : 0;
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(stat + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // select, never multiply: a blind query's exponent is about +1e30
      float p = exp2f(fmaf(st[4 * n + e], sl2, -((e & 1) ? l.y : l.x)));
      const int c = 8 * n + (e & 1);
      if (MASK && (e < 2 ? (c < lo0 || c >= hi0) : (c < lo1 || c >= hi1))) p = 0.f;
      st[4 * n + e] = p;
    }
  }
  // At d = 64, dV's product runs while dS^T is computed. At d = 128 that
  // would keep P^T's fragments live beside fp32 P^T and dP^T and the 128
  // dK/dV accumulators, past the consumers' 240 registers: both products
  // are issued after dS^T there.
  constexpr bool kOverlap = D == 64;
  uint32_t pt[BQ / 16][4];
  if constexpr (kOverlap) {
    acc_as_a<T, BQ>(pt, st);
    issue_dv<T, D>(dv, pt, dos);
    hopper::wgmma_wait<1>();   // dP^T has landed; dV's product is in flight
  } else {
    hopper::wgmma_wait<0>();
  }
  hopper::fence_regs(dpt);
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const float2 dl = *reinterpret_cast<const float2*>(stat + BQ + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dpt[4 * n + e] = st[4 * n + e] * (dpt[4 * n + e] - ((e & 1) ? dl.y : dl.x)) * scale;
  }
  if constexpr (!kOverlap) {
    acc_as_a<T, BQ>(pt, st);
    issue_dv<T, D>(dv, pt, dos);
  }
  uint32_t dst[BQ / 16][4];
  acc_as_a<T, BQ>(dst, dpt);
  hopper::fence_regs(dk);
  hopper::fence_regs(dst);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk)
    hopper::Wgmma<T, D>::rs_t(dk, dst[kk], desc_sw128(qs + kk * 2048, BQ * 128, 1024));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dv);
  hopper::fence_regs(dk);
  hopper::fence_regs(pt);
  hopper::fence_regs(dst);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    dkv_wgmma(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tdo, const Args a) {
  using L = DkvLayout<D>;
  constexpr int BQ = kDkvQ;
  constexpr int kBlkKV = kRows * 128;   // bytes of a 64-column block of K or V
  constexpr int kBlkQ = BQ * 128;       // ... of a Q or dO tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + L::kKVBytes;
  unsigned char* ring = vs + L::kKVBytes;   // stage s: Q, then dO
  float* stats = reinterpret_cast<float*>(ring + L::kStages * L::kStageBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(stats) + L::kStages * L::kStatBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  const int k0 = blockIdx.y * kRows;   // the first key tiles see the most queries
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int n_q = (a.seq_q + BQ - 1) / BQ;
  const int it0 = dkv_first_query_tile<BQ>(a, k0);
  const int n_it = max(n_q - it0, 0);
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);   // the TMA thread's, and the warp's
      hopper::mbar_init(&empty[s], kConsumers / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one warp; its first thread issues the TMA loads, and
    // every lane stores two queries' lse and Delta into the stage
    hopper::reg_dealloc<24>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < kConsumers + 32 && n_it > 0) {
      if (lane == 0) {
        hopper::mbar_expect_tx(kv_full, 2 * L::kKVBytes);
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(ks + c * kBlkKV, &tk, kv_full, c * 64, k0, h, b);
          hopper::tma_load_4d(vs + c * kBlkKV, &tv, kv_full, c * 64, k0, h, b);
        }
      }
      const float* lse = a.lse + static_cast<long long>(bh) * a.seq_q;
      const float* delta = a.delta + static_cast<long long>(bh) * a.seq_q;
      for (int j = 0; j < n_it; ++j) {
        const int s = j % L::kStages, q0 = (it0 + j) * BQ;
        if (j >= L::kStages) hopper::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
        if (lane == 0) {
          unsigned char* qst = ring + s * L::kStageBytes;
          hopper::mbar_expect_tx(&full[s], L::kStageBytes);
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(qst + c * kBlkQ, &tq, &full[s], c * 64, q0, h, b);
            hopper::tma_load_4d(qst + L::kTileBytes + c * kBlkQ, &tdo, &full[s], c * 64,
                                q0, h, b);
          }
        }
        float* stat = stats + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = q0 + r < a.seq_q;
          stat[r] = ok ? lse[q0 + r] * kLog2e : 0.f;
          stat[BQ + r] = ok ? delta[q0 + r] : 0.f;
        }
        hopper::mbar_arrive(&full[s]);   // releases the stores above
      }
    }
    return;
  }

  // a consumer warpgroup: keys kfirst .. kfirst + 63
  hopper::reg_alloc<240>();
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32, g = lane >> 2;
  const int kfirst = k0 + wg * 64;
  const int key0 = kfirst + warp * 16 + g;   // a thread's two keys: key0, key0 + 8
  const int2 qr0 = key_query_range(a, key0), qr1 = key_query_range(a, key0 + 8);
  // the first tile this warpgroup's keys see (none if they are past the end)
  const int my0 = kfirst < a.seq_k ? dkv_first_query_tile<BQ>(a, kfirst) : n_q;
  const bool keys_whole = kfirst + 64 <= a.seq_k;
  const int off = a.seq_k - a.seq_q;
  const float sl2 = a.scale * kLog2e;
  unsigned char* k_wg = ks + wg * 64 * 128;
  unsigned char* v_wg = vs + wg * 64 * 128;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_it > 0) hopper::mbar_wait(kv_full, 0);
  for (int j = 0; j < n_it; ++j) {
    const int s = j % L::kStages, it = it0 + j, q0 = it * BQ;
    hopper::mbar_wait(&full[s], (j / L::kStages) & 1);
    const unsigned char* qst = ring + s * L::kStageBytes;
    const float* stat = stats + s * 2 * BQ;
    if (it >= my0) {
      const bool whole = keys_whole && q0 + BQ <= a.seq_q &&
                         (!a.causal || q0 + off >= kfirst + 63);
      if (whole)
        dkv_tile<T, D, false>(k_wg, v_wg, qst, qst + L::kTileBytes, stat, q0, qr0, qr1,
                              sl2, a.scale, dk, dv);
      else   // the diagonal and the ends of the keys and the queries
        dkv_tile<T, D, true>(k_wg, v_wg, qst, qst + L::kTileBytes, stat, q0, qr0, qr1,
                             sl2, a.scale, dk, dv);
    }
    // a warpgroup whose keys are seen later still releases every stage
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // dK and dV through the warpgroup's own K and V rows
  hopper::bar_sync(1 + wg, 128);
  stage_rows<T, D>(k_wg, kBlkKV, dk);
  stage_rows<T, D>(v_wg, kBlkKV, dv);
  hopper::bar_sync(1 + wg, 128);
  store_rows<D>(a, k_wg, kBlkKV, a.dk, b, h, a.seq_k, kfirst);
  store_rows<D>(a, v_wg, kBlkKV, a.dv, b, h, a.seq_k, kfirst);
}

// ---------------------------------------------------------------- launch

template <typename Kernel, typename... Params>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, int threads,
                   cudaStream_t stream, const Params&... params) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(params...);
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

// The tensor maps of q, k, v and dO: dims (d, S, H, B) innermost first, the
// BSHD strides in bytes, boxes of 64 values x `rows[i]` positions. False if
// cuTensorMapEncodeTiled refuses one (every stride and base must be a
// multiple of 16 bytes).
template <typename T, int D>
bool bshd_maps(CUtensorMap (&maps)[4], const Args& a, int batch, const int (&rows)[4]) {
  const void* base[4] = {a.q, a.k, a.v, a.dout};
  const long long strides[4][3] = {{a.q_ss, a.q_sh, a.q_sb},
                                   {a.k_ss, a.k_sh, a.k_sb},
                                   {a.v_ss, a.v_sh, a.v_sb},
                                   {a.o_ss, a.o_sh, a.o_sb}};
  const int seq[4] = {a.seq_q, a.seq_k, a.seq_k, a.seq_q};
  for (int i = 0; i < 4; ++i) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(seq[i]),
                                static_cast<cuuint64_t>(a.heads),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[i][0]) * 2,
                                 static_cast<cuuint64_t>(strides[i][1]) * 2,
                                 static_cast<cuuint64_t>(strides[i][2]) * 2};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows[i]), 1, 1};
    if (!hopper::make_map(&maps[i], base[i], hopper::kIsHalf<T>, 4, dims, bytes, box))
      return false;
  }
  return true;
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, int batch, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!bshd_maps<T, D>(maps, a, batch, {kRows, DqLayout<D>::kKeys, DqLayout<D>::kKeys, kRows}))
    return cudaErrorInvalidValue;
  const dim3 grid(batch * a.heads, (a.seq_q + kRows - 1) / kRows);
  return launch(dq_wgmma<T, D>, DqLayout<D>::kSmem, grid, kMmaThreads, stream, maps[0],
                maps[1], maps[2], maps[3], a);
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, int batch, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (!bshd_maps<T, D>(maps, a, batch, {kDkvQ, kRows, kRows, kDkvQ}))
    return cudaErrorInvalidValue;
  const dim3 grid(batch * a.heads, (a.seq_k + kRows - 1) / kRows);
  return launch(dkv_wgmma<T, D>, DkvLayout<D>::kSmem, grid, kMmaThreads, stream, maps[0],
                maps[1], maps[2], maps[3], a);
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
// for arguments the kernel does not take (or, in bf16/fp16, strides TMA
// cannot describe).
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
    return launch(dq_f32<64>, dq_f32_smem<64>(), grid, kThreads, s, a);
  if (dtype == 0 && head_dim == 128)
    return launch(dq_f32<128>, dq_f32_smem<128>(), grid, kThreads, s, a);
  if (dtype == 1 && head_dim == 64) return launch_dq<__nv_bfloat16, 64>(a, batch, s);
  if (dtype == 1 && head_dim == 128) return launch_dq<__nv_bfloat16, 128>(a, batch, s);
  if (dtype == 2 && head_dim == 64) return launch_dq<__half, 64>(a, batch, s);
  if (dtype == 2 && head_dim == 128) return launch_dq<__half, 128>(a, batch, s);
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
    return launch(dkv_f32<64>, dkv_f32_smem<64>(), grid, kThreads, s, a);
  if (dtype == 0 && head_dim == 128)
    return launch(dkv_f32<128>, dkv_f32_smem<128>(), grid, kThreads, s, a);
  if (dtype == 1 && head_dim == 64) return launch_dkv<__nv_bfloat16, 64>(a, batch, s);
  if (dtype == 1 && head_dim == 128) return launch_dkv<__nv_bfloat16, 128>(a, batch, s);
  if (dtype == 2 && head_dim == 64) return launch_dkv<__half, 64>(a, batch, s);
  if (dtype == 2 && head_dim == 128) return launch_dkv<__half, 128>(a, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
