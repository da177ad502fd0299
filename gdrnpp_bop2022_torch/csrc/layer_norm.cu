// Channel-last LayerNorm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gdrnpp_bop2022_tpu/ops/pallas_ln.py::_ln_kernel
// (wrapper layer_norm_pallas). Same function: LayerNorm over the last axis of
// x viewed as (rows, C), fp32 mean, then fp32 variance as the mean of
// (x - mean)^2 (two passes, not E[x^2] - E[x]^2), rsqrt(var + eps), times
// scale plus bias, cast back to the input type.
//
// Bound: device memory bytes, not FLOPs. Each element is read once and
// written once (2 + 2 bytes in bf16) against ~8 flops, far below the card's
// ~295 flops/byte ridge. The design therefore moves each byte exactly once:
//   * one warp owns one row; the row's C values stay in registers (C/32 per
//     lane, C <= 1024), so the second pass over the row reads no memory;
//   * the statistics are reduced with warp shuffles, with no shared memory
//     and no block-wide barrier;
//   * lane l touches elements l, l+32, ..., so neighbouring lanes read
//     neighbouring addresses and every warp load is coalesced;
//   * scale and bias are read per element from a (C,) fp32 vector that stays
//     in L1/L2 across rows.
// A grid over rows with a bound check replaces the Pallas kernel's padding of
// rows to a 256-row tile. Vectorised 16-byte loads, TMA and persistent blocks
// are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a JAX/PyTorch cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// N = values held per lane, a power of two with 32 * N >= C.
template <typename T, int N>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_rows(const T* __restrict__ x, const float* __restrict__ weight,
                const float* __restrict__ bias, T* __restrict__ y,
                int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together: the shuffles stay full-warp
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float v[N];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < C ? to_float(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mean = warp_sum(sum) / C;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    if (c < C) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);

#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = lane + 32 * i;
    if (c < C) yr[c] = from_float<T>((v[i] - mean) * inv * weight[c] + bias[c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int rows, int C,
                   float eps, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  T* yp = static_cast<T*>(y);
  if (C <= 32)
    layer_norm_rows<T, 1><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  else if (C <= 64)
    layer_norm_rows<T, 2><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  else if (C <= 128)
    layer_norm_rows<T, 4><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  else if (C <= 256)
    layer_norm_rows<T, 8><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  else if (C <= 512)
    layer_norm_rows<T, 16><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  else
    layer_norm_rows<T, 32><<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 = cudaSuccess). The caller guarantees 0 < rows, 0 < C <= 1024, contiguous
// (rows, C) input and output, and (C,) float32 weight and bias.
extern "C" int gdrn_layer_norm_fwd(const void* x, const void* weight, const void* bias, void* y,
                                   int rows, int C, float eps, int dtype, void* stream) {
  if (rows <= 0 || C <= 0 || C > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, weight, bias, y, rows, C, eps, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, weight, bias, y, rows, C, eps, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
