// Bias add + activation in one pass (K5), written by hand for Hopper.
//
// Replaces the TPU kernel `_bias_act_kernel` in
// paddle_tpu/ops/pallas/fused_ops.py (launched by `pallas_call` in
// `fused_bias_act`). Same function: y = act(x + b) in fp32, rounded once to
// the input type, with act one of none, gelu (erf), gelu_tanh, silu, relu,
// the formulas of the TPU kernels' `_act_apply`.
//
// Translation. The TPU kernel walks (block_rows, D) panels. Here a grid of
// 256-thread blocks strides over the (rows, D) array in 16-byte vectors
// where the row allows them (D a multiple of 16 bytes), otherwise one value
// a thread; each vector reads its bias columns, which stay in L1/L2.
//
// Bound at the path shape (8192 x 4096, bf16): x read and y written, 2 x
// 67.1 MB = 134 MB, 40.1 us at 3.35 TB/s; a gelu is some 20 operations an
// element, far below the card's rate. So the kernel is bound by bytes and
// moves each byte once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum Act { kNone = 0, kGelu = 1, kGeluTanh = 2, kSilu = 3, kRelu = 4 };

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

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if constexpr (ACT == kGelu) return 0.5f * v * (1.f + erff(v * 0.7071067811865476f));
  if constexpr (ACT == kGeluTanh)
    return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
  if constexpr (ACT == kSilu) return v / (1.f + expf(-v));
  if constexpr (ACT == kRelu) return v > 0.f ? v : 0.f;
  return v;
}

template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kThreads)
    bias_act(const T* __restrict__ x, const T* __restrict__ b, T* __restrict__ y,
             long long n_vec, int d_vec) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
       i < n_vec; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int col = static_cast<int>(i % d_vec) * VEC;
    alignas(16) T xv[VEC], bv[VEC], yv[VEC];
    if constexpr (VEC * sizeof(T) == 16) {
      *reinterpret_cast<uint4*>(xv) = reinterpret_cast<const uint4*>(x)[i];
      *reinterpret_cast<uint4*>(bv) = *reinterpret_cast<const uint4*>(b + col);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        xv[e] = x[i * VEC + e];
        bv[e] = b[col + e];
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      yv[e] = Cvt<T>::out(act<ACT>(Cvt<T>::in(xv[e]) + Cvt<T>::in(bv[e])));
    if constexpr (VEC * sizeof(T) == 16) {
      reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(yv);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[i * VEC + e] = yv[e];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const void* x, const void* b, void* y, long long rows,
                       int d, int act_code, cudaStream_t st) {
  const long long n_vec = rows * d / VEC;
  // enough blocks to fill the card several times over; the loop strides
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  const T* xs = static_cast<const T*>(x);
  const T* bs = static_cast<const T*>(b);
  T* ys = static_cast<T*>(y);
  const int d_vec = d / VEC;
  switch (act_code) {
    case kNone: bias_act<T, VEC, kNone><<<grid, kThreads, 0, st>>>(xs, bs, ys, n_vec, d_vec); break;
    case kGelu: bias_act<T, VEC, kGelu><<<grid, kThreads, 0, st>>>(xs, bs, ys, n_vec, d_vec); break;
    case kGeluTanh: bias_act<T, VEC, kGeluTanh><<<grid, kThreads, 0, st>>>(xs, bs, ys, n_vec, d_vec); break;
    case kSilu: bias_act<T, VEC, kSilu><<<grid, kThreads, 0, st>>>(xs, bs, ys, n_vec, d_vec); break;
    case kRelu: bias_act<T, VEC, kRelu><<<grid, kThreads, 0, st>>>(xs, bs, ys, n_vec, d_vec); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* b, void* y, long long rows,
                         int d, int act_code, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = (d % VEC) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return vec ? launch_vec<T, VEC>(x, b, y, rows, d, act_code, st)
             : launch_vec<T, 1>(x, b, y, rows, d, act_code, st);
}

}  // namespace

// x, y: (rows, d) contiguous; b: (d,); one type. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16. act: 0 none, 1 gelu, 2 gelu_tanh, 3 silu,
// 4 relu. Returns a cudaError_t: the launch's own, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int fused_bias_act(const void* x, const void* b, void* y,
                              long long rows, int d, int dtype, int act_code,
                              void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(x, b, y, rows, d, act_code, st);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(x, b, y, rows, d, act_code, st);
  if (dtype == 2) return launch_typed<__half>(x, b, y, rows, d, act_code, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
