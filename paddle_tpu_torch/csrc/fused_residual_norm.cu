// Residual add + LayerNorm / RMSNorm in one pass (K4), written by hand for
// Hopper.
//
// Replaces the TPU kernel `_norm_kernel` in
// paddle_tpu/ops/pallas/fused_ops.py (launched by `pallas_call` in
// `fused_residual_norm`). Same function: s = x + res in fp32; the sum is
// stored rounded to the input type, and the fp32 sum (not the rounded one)
// is normalized with fp32 statistics, LayerNorm (centered variance, two
// passes) or RMSNorm (mean of squares); y = norm(s) * w + b, rounded once.
// A missing weight counts as 1, a missing bias as 0.
//
// Translation. On the TPU a grid step holds a (block_rows, D) panel in VMEM.
// Here one block of 256 threads owns one row: it reads x and res once with
// 16-byte loads where the row allows them (D a multiple of 16 bytes), keeps
// the fp32 sum of the row in shared memory for the statistics and the
// normalization, and writes s and y once. The block reductions are summed in
// a fixed order, so a row's statistics do not depend on scheduling.
//
// Bound at the LLaMA-770M path shape (8192 x 1536, bf16): x and res read,
// y and s written, 4 x 25.2 MB = 100.7 MB, 30.0 us at 3.35 TB/s; the
// arithmetic (about 10 operations an element) is far below the tensor
// rate. So the kernel is bound by bytes, and its design moves each byte
// once. What it does not do yet: several rows a block for short rows, or a
// persistent grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLayerNorm = 1;
constexpr int kRmsNorm = 2;

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

// VEC consecutive values; 16 bytes at once when VEC * sizeof(T) == 16
template <typename T, int VEC>
__device__ __forceinline__ void load(T (&v)[VEC], const T* p) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const T (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// The block's sum of v, the same value in every thread (fixed order).
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // red may still be read by the previous reduction
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;
}

struct Args {
  const void* x;
  const void* res;
  const void* w;    // (d,) or null
  const void* b;    // (d,) or null
  void* y;
  void* s;
  int d;
  int kind;
  float eps;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) residual_norm(const Args a) {
  extern __shared__ float srow[];   // the row's fp32 sum
  __shared__ float red[kThreads / 32];
  const long long off = static_cast<long long>(blockIdx.x) * a.d;
  const T* x = static_cast<const T*>(a.x) + off;
  const T* res = static_cast<const T*>(a.res) + off;
  const T* w = static_cast<const T*>(a.w);
  const T* b = static_cast<const T*>(a.b);
  T* y = static_cast<T*>(a.y) + off;
  T* s = static_cast<T*>(a.s) + off;
  // each thread walks the same columns in all three passes, so it reads
  // back only what it wrote itself
  const int step = kThreads * VEC;

  float sum = 0.f;
  for (int c = threadIdx.x * VEC; c < a.d; c += step) {
    alignas(16) T xv[VEC], rv[VEC], sv[VEC];
    load(xv, x + c);
    load(rv, res + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = Cvt<T>::in(xv[i]) + Cvt<T>::in(rv[i]);
      srow[c + i] = v;
      sv[i] = Cvt<T>::out(v);
      sum += v;
    }
    store(s + c, sv);
  }
  const float mean = a.kind == kLayerNorm ? block_sum(sum, red) / a.d : 0.f;
  float sq = 0.f;
  for (int c = threadIdx.x * VEC; c < a.d; c += step) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = srow[c + i] - mean;
      sq += v * v;
    }
  }
  // LayerNorm: the centered variance; RMSNorm: the mean of squares
  const float rstd = rsqrtf(block_sum(sq, red) / a.d + a.eps);
  for (int c = threadIdx.x * VEC; c < a.d; c += step) {
    alignas(16) T wv[VEC], bv[VEC], yv[VEC];
    if (w) load(wv, w + c);
    if (b) load(bv, b + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = (srow[c + i] - mean) * rstd;
      v = v * (w ? Cvt<T>::in(wv[i]) : 1.f) + (b ? Cvt<T>::in(bv[i]) : 0.f);
      yv[i] = Cvt<T>::out(v);
    }
    store(y + c, yv);
  }
}

template <typename T>
cudaError_t launch_typed(const Args& a, int rows, bool vec, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = sizeof(float) * static_cast<size_t>(a.d);
  auto kernel = vec ? residual_norm<T, VEC> : residual_norm<T, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<rows, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x, res, y, s: (rows, d) contiguous; w, b: (d,) or null, all one type.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. kind: 1 = LayerNorm,
// 2 = RMSNorm. Returns a cudaError_t: the launch's own, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int fused_residual_norm(const void* x, const void* res,
                                   const void* w, const void* b, void* y,
                                   void* s, int rows, int d, int dtype,
                                   int kind, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d > 32768 || (kind != kLayerNorm && kind != kRmsNorm))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, res, w, b, y, s, d, kind, eps};
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = (d * elem) % 16 == 0 && aligned16(x) && aligned16(res) &&
                   aligned16(w) && aligned16(b) && aligned16(y) && aligned16(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(a, rows, vec, st);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(a, rows, vec, st);
  if (dtype == 2) return launch_typed<__half>(a, rows, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
