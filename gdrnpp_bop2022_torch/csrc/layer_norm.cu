// Channel-last LayerNorm forward for Hopper (sm_90a): kernel B1.
//
// Replaces the Pallas TPU kernel gdrnpp_bop2022_tpu/ops/pallas_ln.py::_ln_kernel
// (wrapper layer_norm_pallas). Same function: LayerNorm over the last axis of
// x viewed as (rows, C), fp32 mean, then fp32 variance as the mean of
// (x - mean)^2 (two passes, not E[x^2] - E[x]^2), rsqrt(var + eps), times
// scale plus bias, cast back to the input type.
//
// Bound: device memory bytes, not FLOPs. Each element is read once and
// written once (2 + 2 bytes in bf16) against ~8 flops, far below the card's
// ~295 flops/byte ridge. The design moves each byte once, in as few and as
// wide accesses as the data allows, with enough of them in flight:
//   * vector path: each lane loads and stores 16 bytes per access (8 bf16 or
//     4 fp32); a row is owned by a group of L lanes (L = 8, 16 or 32, the
//     fewest that cover C / 8 bf16 or C / 4 fp32 vectors), so a warp holds
//     32 / L rows at once (2 at C = 128 in bf16) and its loads of one step are
//     contiguous;
//   * the row's values stay in registers, so the second pass reads no memory;
//     the statistics are reduced with shuffles inside the group;
//   * each warp takes two row steps at once where a lane holds at most 16
//     values (up to four 16-byte loads in flight per lane), in a grid-stride
//     loop over a grid of 4-warp blocks that covers every row once (a grid
//     of SM count x resident blocks, each warp walking several rows, was
//     slower on an H100);
//   * weight and bias for a lane's channels are loaded into registers once
//     per warp (as float4 on the vector path), not per element;
//   * scalar path, the same kernel with one element per access (VEC = 1,
//     L = 32): C not a multiple of 16 bytes, or a pointer not 16-byte
//     aligned. ops/layer_norm.py::_vector_path picks the path.
// A bound check on the last rows replaces the Pallas kernel's padding of rows
// to a 256-row tile.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;

// VEC values of T moved as one access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a JAX/PyTorch cast
}

// sum over the L lanes of a group (L a power of two, groups aligned in the warp)
template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = L / 2; offset > 0; offset >>= 1) v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// row steps unrolled per loop iteration: two where a lane holds <= 16 values
template <int NV, int VEC>
__host__ __device__ constexpr int row_steps() { return NV * VEC <= 16 ? 2 : 1; }

// VEC values per access, L lanes per row, NV accesses per lane and row:
// lane j of a group holds vectors j, j + L, ..., j + (NV - 1) L of its row.
template <typename T, int VEC, int L, int NV>
__global__ void __launch_bounds__(kThreads)
layer_norm_rows(const T* __restrict__ x, const float* __restrict__ weight,
                const float* __restrict__ bias, T* __restrict__ y, long long rows, int C,
                float eps) {
  constexpr int G = 32 / L;                // rows per warp per step
  constexpr int S = row_steps<NV, VEC>();  // steps per iteration
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int sub = lane / L, j = lane % L;
  const int nvec = C / VEC;

  float w[NV][VEC], bs[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int p = j + v * L;
    if (p < nvec) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(weight + p * VEC + e);
          const float4 bv = *reinterpret_cast<const float4*>(bias + p * VEC + e);
          w[v][e] = wv.x; w[v][e + 1] = wv.y; w[v][e + 2] = wv.z; w[v][e + 3] = wv.w;
          bs[v][e] = bv.x; bs[v][e + 1] = bv.y; bs[v][e + 2] = bv.z; bs[v][e + 3] = bv.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          w[v][e] = weight[p * VEC + e];
          bs[v][e] = bias[p * VEC + e];
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[v][e] = bs[v][e] = 0.f;
    }
  }

  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long n_warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  // r0 is the same for the whole warp, so every shuffle has all 32 lanes
  for (long long r0 = warp * G * S; r0 < rows; r0 += n_warps * G * S) {
    float val[S][NV][VEC];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long row = r0 + s * G + sub;
      const P* xr = reinterpret_cast<const P*>(x + row * C);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int p = j + v * L;
        if (row < rows && p < nvec) {
          const P q = xr[p];
#pragma unroll
          for (int e = 0; e < VEC; ++e) val[s][v][e] = to_float(q.v[e]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) val[s][v][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const long long row = r0 + s * G + sub;
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e) sum += val[s][v][e];
      const float mean = group_sum<L>(sum) / C;
      float sq = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (j + v * L < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float d = val[s][v][e] - mean;
            sq += d * d;
          }
        }
      }
      const float inv = rsqrtf(group_sum<L>(sq) / C + eps);
      if (row < rows) {
        P* yr = reinterpret_cast<P*>(y + row * C);
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int p = j + v * L;
          if (p < nvec) {
            P q;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              q.v[e] = from_float<T>((val[s][v][e] - mean) * inv * w[v][e] + bs[v][e]);
            yr[p] = q;
          }
        }
      }
    }
  }
}

template <typename T, int VEC, int L, int NV>
cudaError_t launch_rows(const void* x, const void* w, const void* b, void* y, int rows, int C,
                        float eps, cudaStream_t stream) {
  constexpr int per_warp = (32 / L) * row_steps<NV, VEC>();
  const long long warps = (static_cast<long long>(rows) + per_warp - 1) / per_warp;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  layer_norm_rows<T, VEC, L, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), rows, C, eps);
  return cudaGetLastError();
}

// vector path: VEC values of 16 bytes per access; C % VEC == 0
template <typename T>
cudaError_t launch_vector(const void* x, const void* w, const void* b, void* y, int rows, int C,
                          float eps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = C / VEC;
  if (nvec <= 8) return launch_rows<T, VEC, 8, 1>(x, w, b, y, rows, C, eps, s);
  if (nvec <= 16) return launch_rows<T, VEC, 16, 1>(x, w, b, y, rows, C, eps, s);
  if (nvec <= 32) return launch_rows<T, VEC, 32, 1>(x, w, b, y, rows, C, eps, s);
  if (nvec <= 64) return launch_rows<T, VEC, 32, 2>(x, w, b, y, rows, C, eps, s);
  if (nvec <= 128) return launch_rows<T, VEC, 32, 4>(x, w, b, y, rows, C, eps, s);
  return launch_rows<T, VEC, 32, 8>(x, w, b, y, rows, C, eps, s);
}

// scalar path: one element per access, a full warp per row, C <= 1024
template <typename T>
cudaError_t launch_scalar(const void* x, const void* w, const void* b, void* y, int rows, int C,
                          float eps, cudaStream_t s) {
  if (C <= 32) return launch_rows<T, 1, 32, 1>(x, w, b, y, rows, C, eps, s);
  if (C <= 64) return launch_rows<T, 1, 32, 2>(x, w, b, y, rows, C, eps, s);
  if (C <= 128) return launch_rows<T, 1, 32, 4>(x, w, b, y, rows, C, eps, s);
  if (C <= 256) return launch_rows<T, 1, 32, 8>(x, w, b, y, rows, C, eps, s);
  if (C <= 512) return launch_rows<T, 1, 32, 16>(x, w, b, y, rows, C, eps, s);
  return launch_rows<T, 1, 32, 32>(x, w, b, y, rows, C, eps, s);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int rows, int C,
                   float eps, int vector, cudaStream_t s) {
  if (!vector) return launch_scalar<T>(x, w, b, y, rows, C, eps, s);
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y);
  if (any % 16 != 0 || (C * sizeof(T)) % 16 != 0) return cudaErrorMisalignedAddress;
  return launch_vector<T>(x, w, b, y, rows, C, eps, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vector: 1 = 16-byte accesses (C * the
// element size a multiple of 16 and every pointer 16-byte aligned, else the
// launch is refused), 0 = one element per access. Returns the cudaError_t of
// the launch (0 = cudaSuccess). The caller guarantees 0 < rows, 0 < C <= 1024,
// contiguous (rows, C) input and output, and (C,) float32 weight and bias.
extern "C" int gdrn_layer_norm_fwd(const void* x, const void* weight, const void* bias, void* y,
                                   int rows, int C, float eps, int dtype, int vector,
                                   void* stream) {
  if (rows <= 0 || C <= 0 || C > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(x, weight, bias, y, rows, C, eps, vector, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(x, weight, bias, y, rows, C, eps, vector, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
