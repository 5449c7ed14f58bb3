// Flash-attention forward (FlashAttention-2) for Hopper, written by hand.
//
// Replaces the TPU kernel `_fwd_kernel` in
// paddle_tpu/ops/pallas/flash_attention.py (launched by `pallas_call` in
// `_flash_fwd_bhsd`, public entry `flash_attention_fwd`). Same function:
// online softmax over key/value tiles with fp32 running max `m`, sum `l`
// and accumulator; the -1e30 mask value; the bottom-right causal offset
// `seq_k - seq_q` with key tiles wholly above the diagonal skipped; 0 for
// rows that see no key; LSE = m + log(max(l, 1e-30)) per query row, in
// natural-log units, as the backward kernels and the plain versions read it.
//
// Translation. On the TPU the key/value axis is the innermost, sequential
// grid axis and m/l/acc live in VMEM scratch across grid steps. Here the
// blocks of a grid run in parallel and share nothing, so one thread block
// owns one (batch*head, query tile) pair and walks the key/value tiles in a
// loop, keeping m/l/acc in registers. Q/K/V are read in their BSHD layout
// through the strides the wrapper passes, so the JAX wrapper's BSHD<->BHSD
// transposes and its pad of the head dim to 128 lanes do not exist here.
//
// Two bodies, one function:
//   * bf16 / fp16, `flash_fwd_wgmma`: warp-specialized. A block owns 128
//     query rows: two consumer warpgroups of 64 rows each and a producer
//     warpgroup, which keeps 24 registers a thread and hands the rest to
//     the consumers (`setmaxnreg`: 240 each). The producer's one thread
//     issues TMA loads: Q once, then K/V tiles of 128 keys into a ring of
//     shared-memory stages (3 for d = 64, 2 for d = 128; 115.8 and 164.9
//     KB a block), each stage guarded by a
//     `full` mbarrier (TMA bytes landed) and an `empty` one (both consumer
//     warpgroups done with it). Q, K and V each have one tensor map a call,
//     encoded on the host from the BSHD pointer and strides (dims d, S, H,
//     B; 128-byte swizzle, rows of 64 values; a d = 128 row is two boxes),
//     so a view of the qkv projection (sequence stride 3*H*d) is read in
//     place and TMA's zero fill covers the ragged tails of S.
//     S = Q K^T is `wgmma` m64n128k16 with both operands K-major in shared
//     memory. The softmax runs on the accumulator fragment in registers in
//     log2 units (scale * log2(e) folded into one multiply, exp2f), with
//     the causal/ragged mask only on the tiles that cross the diagonal or
//     the end of S; the fully visible tiles run a loop without it. P is
//     rounded to the input type in registers (as the TPU kernel rounds
//     `p.astype(v.dtype)`) and is the register A operand of O += P V, whose
//     B = V is read MN-major (d contiguous) with wgmma's transpose bit.
//     The two consumer warpgroups take turns issuing S (a pair of named
//     barriers), so that one's softmax overlaps the other's products.
//     Query tiles are scheduled heaviest first (the last rows of a causal
//     head, across all heads, form the first wave). O is normalized,
//     staged through the warpgroup's own Q rows and stored in BSHD with
//     16-byte writes. 128-key tiles for d = 128 too: S (64 fp32), O (64)
//     and P (32) fit a consumer's 240 registers, and halving the tile
//     would double the softmax's shuffles and barrier round trips a key.
//   * fp32: plain FMA on the CUDA cores (tensor cores would round the
//     inputs to TF32). 128 threads, each owning an 8x4 piece of S and an
//     8x(d/16) piece of O; S/P go through shared memory for the row
//     statistics.
//
// Bound at the GPT-2 small path shape (B=4, S=1024, H=12, d=64, bf16,
// causal), per call: q, k, v and out are 6.29 MB each, 25.2 MB together,
// 7.5 us at 3.35 TB/s; the FLOPs are 4*B*H*S^2*d/2 = 6.4 GFLOP, 6.5 us at
// 989 TFLOP/s. So the call is bound by bytes at about 7.6 us. What the
// design does about it: every input byte is read from device memory once
// per query tile (K/V tiles are re-read by the 8 query tiles of a head, from
// L2), the loads run ahead of the math in the TMA ring, the products run on
// wgmma, and no (S, S) matrix ever leaves the chip.

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;       // fp32 body
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Key/value tiles of `bn` keys that rows up to `last_row` must visit: all
// of them, or, when causal, those that start at or before the last key
// that row sees.
__device__ __forceinline__ int kv_end(const Args& a, int last_row, int bn) {
  int n = (a.seq_k + bn - 1) / bn;
  if (a.causal) {
    const int last = last_row + (a.seq_k - a.seq_q);
    n = last < 0 ? 0 : min(n, last / bn + 1);
  }
  return n;
}

// Leading tiles that every row from `first_row` on sees whole: no causal
// cut and no end of S inside them.
__device__ __forceinline__ int kv_full(const Args& a, int first_row, int bn) {
  int n = a.seq_k / bn;
  if (a.causal) {
    const int f = first_row + (a.seq_k - a.seq_q) + 1;
    n = f <= 0 ? 0 : min(n, f / bn);
  }
  return n;
}

__device__ __forceinline__ int kv_tiles(const Args& a, int q0) {
  return kv_end(a, q0 + kBlockQ - 1, kBlockK);
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

constexpr int kConsumers = 256;                // two consumer warpgroups
constexpr int kMmaThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kMmaRows = 128;                  // query rows a block owns
constexpr int kMmaKeys = 128;                  // keys a K/V tile holds

template <int D>
struct FwdLayout {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t kQBytes = kMmaRows * D * 2;
  static constexpr uint32_t kTileBytes = kMmaKeys * D * 2;   // K or V
  static constexpr uint32_t kStageBytes = 2 * kTileBytes;
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * kStageBytes + (1 + 2 * kStages) * sizeof(uint64_t);
};

// One K/V tile for one consumer warpgroup: S = Q K^T, the online softmax,
// O += P V. MASK applies the causal cut and the end of S per element.
template <typename T, int D, bool MASK>
__device__ __forceinline__ void attend_tile(
    const Args& a, const unsigned char* q_wg, const unsigned char* ks,
    const unsigned char* vs, int k0, int row0, int row1, float sl2,
    float (&o)[D / 2], float& m0, float& m1, float& l0, float& l1) {
  using hopper::desc_sw128;
  constexpr int BN = kMmaKeys;
  const int t = threadIdx.x & 3;

  float s[BN / 2];
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // k16 step kk: column block kk / 4 of the rows, 32 bytes in per step
    const int blk = kk / 4, off = (kk % 4) * 32;
    hopper::Wgmma<T, BN>::ss(s, desc_sw128(q_wg + blk * kMmaRows * 128 + off, 16, 1024),
                             desc_sw128(ks + blk * BN * 128 + off, 16, 1024), kk);
  }
  hopper::wgmma_commit();
  hopper::bar_arrive(4 - threadIdx.x / 128, kConsumers);   // the other's turn
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);

  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[4 * n + e] * sl2;
      if (MASK && !visible(a, e < 2 ? row0 : row1, k0 + n * 8 + 2 * t + (e & 1)))
        v = kNegInf;
      s[4 * n + e] = v;
      if (e < 2) mx0 = fmaxf(mx0, v);
      else mx1 = fmaxf(mx1, v);
    }
  // the four threads of a quad hold one row between them
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  // a row that has seen no key yet keeps p = 0 (exp2(-1e30 + 1e30) = 1)
  const bool live0 = mn0 > 0.5f * kNegInf, live1 = mn1 > 0.5f * kNegInf;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    s[4 * n] = live0 ? exp2f(s[4 * n] - mn0) : 0.f;
    s[4 * n + 1] = live0 ? exp2f(s[4 * n + 1] - mn0) : 0.f;
    s[4 * n + 2] = live1 ? exp2f(s[4 * n + 2] - mn1) : 0.f;
    s[4 * n + 3] = live1 ? exp2f(s[4 * n + 3] - mn1) : 0.f;
    sum0 += s[4 * n] + s[4 * n + 1];
    sum1 += s[4 * n + 2] + s[4 * n + 3];
  }
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
  sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
  sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
  const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
  l0 = al0 * l0 + sum0;
  l1 = al1 * l1 + sum1;
  m0 = mn0;
  m1 = mn1;

  // the accumulator blocks 2kk, 2kk+1 of S, rounded, are P's k16 step kk
  uint32_t p[BN / 16][4];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = hopper::pack2<T>(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = hopper::pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = hopper::pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = hopper::pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n] *= al0;
    o[4 * n + 1] *= al0;
    o[4 * n + 2] *= al1;
    o[4 * n + 3] *= al1;
  }
  hopper::fence_regs(o);
  hopper::fence_regs(p);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    // V (keys x d) is MN-major: 8-key groups 1024 bytes apart, the two
    // 64-column blocks of d = 128 BN * 128 bytes apart
    hopper::Wgmma<T, D>::rs_t(o, p[kk], desc_sw128(vs + kk * 2048, BN * 128, 1024));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  hopper::fence_regs(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  using L = FwdLayout<D>;
  constexpr int BN = kMmaKeys;
  constexpr int kBlkQ = kMmaRows * 128;   // bytes of a 64-column block of Q
  constexpr int kBlkKV = BN * 128;        // ... of K or V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* kv = qs + L::kQBytes;    // stage s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv + L::kStages * L::kStageBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaRows;   // heaviest first
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int n_kv = kv_end(a, q0 + kMmaRows - 1, BN);
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
      hopper::mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < D / 64; ++c)
        hopper::tma_load_4d(qs + c * kBlkQ, &tq, q_full, c * 64, q0, h, b);
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
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int first = q0 + wg * 64;
  const int row0 = first + warp * 16 + g, row1 = row0 + 8;   // a thread's two rows
  const int n_mine = kv_end(a, first + 63, BN);
  const int n_full = min(n_mine, kv_full(a, first, BN));
  const float sl2 = a.scale * kLog2e;
  unsigned char* q_wg = qs + wg * 64 * 128;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  if (n_kv > 0) hopper::mbar_wait(q_full, 0);
  // the warpgroups take turns issuing S = Q K^T (named barriers 3 and 4),
  // so that one's softmax runs while the other's products do
  if (wg == 1) hopper::bar_arrive(3, kConsumers);   // warpgroup 0 goes first
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % L::kStages;
    hopper::mbar_wait(&full[s], (j / L::kStages) & 1);
    hopper::bar_sync(3 + wg, kConsumers);   // this warpgroup's turn
    const unsigned char* ks = kv + s * L::kStageBytes;
    if (j < n_full)
      attend_tile<T, D, false>(a, q_wg, ks, ks + L::kTileBytes, j * BN, row0, row1,
                               sl2, o, m0, m1, l0, l1);
    else if (j < n_mine)   // the diagonal and the end of S
      attend_tile<T, D, true>(a, q_wg, ks, ks + L::kTileBytes, j * BN, row0, row1,
                              sl2, o, m0, m1, l0, l1);
    else   // no product to issue: pass the turn on
      hopper::bar_arrive(4 - wg, kConsumers);
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // O through the warpgroup's own Q rows (its last product has read them),
  // in the same 128-byte swizzle, then 16-byte stores of whole rows
  const float L0 = fmaxf(l0, 1e-30f), L1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / L0, inv1 = 1.f / L1;
  const int r0 = warp * 16 + g;   // local rows r0, r0 + 8; both r % 8 == g
  hopper::bar_sync(1 + wg, 128);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    unsigned char* blk = q_wg + (n / 8) * kBlkQ + (((n % 8) ^ g) * 16) + 4 * t;
    *reinterpret_cast<uint32_t*>(blk + r0 * 128) =
        hopper::pack2<T>(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(blk + (r0 + 8) * 128) =
        hopper::pack2<T>(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  hopper::bar_sync(1 + wg, 128);
  constexpr int kChunks = D / 8;   // 16-byte pieces of a row
  T* out = static_cast<T*>(a.o);
  for (int i = threadIdx.x % 128; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks, q = first + r;
    if (q >= a.seq_q) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        q_wg + (ch / 8) * kBlkQ + r * 128 + (((ch % 8) ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(
        out + ((static_cast<long long>(b) * a.seq_q + q) * a.heads + h) * D + ch * 8) = v;
  }
  if (t == 0) {
    float* lse = a.lse + static_cast<long long>(bh) * a.seq_q;
    // natural-log LSE; a row that saw no key keeps about -1e30
    if (row0 < a.seq_q) lse[row0] = (m0 > 0.5f * kNegInf ? m0 * kLn2 : m0) + logf(L0);
    if (row1 < a.seq_q) lse[row1] = (m1 > 0.5f * kNegInf ? m1 * kLn2 : m1) + logf(L1);
  }
}

// ---------------------------------------------------------------- launch

template <int D>
size_t f32_smem() {
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1) + kBlockQ);
}

template <int D>
cudaError_t launch_f32(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = f32_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq_q + kBlockQ - 1) / kBlockQ, batch * a.heads);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// One tensor map for each of q, k, v: dims (d, S, H, B) innermost first,
// the BSHD strides in bytes, boxes of 64 values x `rows` positions.
template <typename T, int D>
cudaError_t launch_wgmma(const Args& a, int batch, cudaStream_t stream) {
  const void* base[3] = {a.q, a.k, a.v};
  const long long strides[3][3] = {
      {a.q_ss, a.q_sh, a.q_sb}, {a.k_ss, a.k_sh, a.k_sb}, {a.v_ss, a.v_sh, a.v_sb}};
  const int seq[3] = {a.seq_q, a.seq_k, a.seq_k};
  const int rows[3] = {kMmaRows, kMmaKeys, kMmaKeys};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(seq[i]),
                                static_cast<cuuint64_t>(a.heads),
                                static_cast<cuuint64_t>(batch)};
    const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[i][0]) * 2,
                                 static_cast<cuuint64_t>(strides[i][1]) * 2,
                                 static_cast<cuuint64_t>(strides[i][2]) * 2};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows[i]), 1, 1};
    if (!hopper::make_map(&maps[i], base[i], hopper::kIsHalf<T>, 4, dims, bytes, box))
      return cudaErrorInvalidValue;
  }
  const size_t smem = FwdLayout<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.seq_q + kMmaRows - 1) / kMmaRows);
  flash_fwd_wgmma<T, D><<<grid, kMmaThreads, smem, stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. head_dim: 64 or 128.
// Returns a cudaError_t: the launch's own, or cudaErrorInvalidValue for
// arguments the kernel does not take (or strides TMA cannot describe:
// every stride and the base must be 16-byte aligned).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch_f32<64>(a, batch, st);
  if (dtype == 0 && head_dim == 128) return launch_f32<128>(a, batch, st);
  if (dtype == 1 && head_dim == 64) return launch_wgmma<__nv_bfloat16, 64>(a, batch, st);
  if (dtype == 1 && head_dim == 128) return launch_wgmma<__nv_bfloat16, 128>(a, batch, st);
  if (dtype == 2 && head_dim == 64) return launch_wgmma<__half, 64>(a, batch, st);
  if (dtype == 2 && head_dim == 128) return launch_wgmma<__half, 128>(a, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
