// Channel-last LayerNorm for Hopper (sm_90a): kernel B1, forward and backward.
//
// Forward: replaces the Pallas TPU kernel
// gdrnpp_bop2022_tpu/ops/pallas_ln.py::_ln_kernel (wrapper layer_norm_pallas).
// Same function: LayerNorm over the last axis of x viewed as (rows, C), fp32
// mean, then fp32 variance as the mean of (x - mean)^2 (two passes, not
// E[x^2] - E[x]^2), rsqrt(var + eps), times scale plus bias, cast back to the
// input type. When training needs a gradient it also writes each row's fp32
// mean and rsqrt(var + eps), the statistics the backward reuses.
//
// Backward: the VJP of that function, which the JAX package leaves to
// autodiff of its jnp LayerNorm (the Pallas kernel has no custom_vjp). With
// xhat = (x - mean) * rstd and g = dy * scale, per row
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), cast to x's type;
//   dscale = sum over rows of dy * xhat, dbias = sum over rows of dy (fp32).
//
// Bound: device memory bytes, not FLOPs. The forward reads and writes each
// element once (2 + 2 bytes in bf16) against ~8 flops; the backward reads x
// and dy and writes dx (3 x 2 bytes) against ~12 flops, both far below the
// card's ~295 flops/byte ridge. The design moves each byte once, in as few
// and as wide accesses as the data allows, with enough of them in flight:
//   * vector path: each lane loads and stores 16 bytes per access (8 bf16 or
//     4 fp32); a row is owned by a group of L lanes (L = 8, 16 or 32, the
//     fewest that cover C / 8 bf16 or C / 4 fp32 vectors), so a warp holds
//     32 / L rows at once (2 at C = 128 in bf16) and its loads of one step are
//     contiguous;
//   * the row's values stay in registers, so the second pass reads no memory;
//     row statistics (forward) and the two row means (backward) are reduced
//     with shuffles inside the group;
//   * forward: each warp takes two row steps at once where a lane holds at
//     most 16 values (up to four 16-byte loads in flight per lane), in a
//     grid-stride loop over a grid of 4-warp blocks that covers every row once
//     (a grid of SM count x resident blocks, each warp walking several rows,
//     was slower on an H100);
//   * backward: a grid of as many blocks as the card holds at once (the
//     occupancy API's blocks per SM x SMs, at most kMaxBwdBlocks) walks the
//     rows; each lane sums dy * xhat and dy for its channels in registers,
//     the block folds its warps' sums through 2 x 4 x C floats of dynamic
//     shared memory into one (C,) row of a (blocks, C) fp32 buffer per
//     output, and a second small launch sums that buffer over blocks in a
//     fixed order. No atomics: the grid depends only on (rows, C) and the
//     card, so two runs give the same bits;
//   * weight and bias for a lane's channels are loaded into registers once
//     per warp (as float4 on the vector path), not per element;
//   * scalar path, the same kernels with one element per access (VEC = 1,
//     L = 32): C not a multiple of 16 bytes, or a pointer not 16-byte
//     aligned. ops/layer_norm.py::_vector_path picks the path.
// A bound check on the last rows replaces the Pallas kernel's padding of rows
// to a 256-row tile.

#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxChannels = 1024;
// the backward's grid (and the rows of its partial-sum buffer) at most
constexpr int kMaxBwdBlocks = 1024;
constexpr int kReduceWarps = 8;

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

// lane j's channels of a (C,) fp32 vector into registers: vectors j, j + L, ...
template <int VEC, int L, int NV>
__device__ __forceinline__ void load_channels(const float* __restrict__ src, int j, int nvec,
                                              float (&out)[NV][VEC]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int p = j + v * L;
    if (p < nvec) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 q = *reinterpret_cast<const float4*>(src + p * VEC + e);
          out[v][e] = q.x; out[v][e + 1] = q.y; out[v][e + 2] = q.z; out[v][e + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[v][e] = src[p * VEC + e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[v][e] = 0.f;
    }
  }
}

// VEC values per access, L lanes per row, NV accesses per lane and row:
// lane j of a group holds vectors j, j + L, ..., j + (NV - 1) L of its row.
// mean_out / rstd_out (rows,) are written when not null.
template <typename T, int VEC, int L, int NV>
__global__ void __launch_bounds__(kThreads)
layer_norm_rows(const T* __restrict__ x, const float* __restrict__ weight,
                const float* __restrict__ bias, T* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out, long long rows,
                int C, float eps) {
  constexpr int G = 32 / L;                // rows per warp per step
  constexpr int S = row_steps<NV, VEC>();  // steps per iteration
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int sub = lane / L, j = lane % L;
  const int nvec = C / VEC;

  float w[NV][VEC], bs[NV][VEC];
  load_channels<VEC, L, NV>(weight, j, nvec, w);
  load_channels<VEC, L, NV>(bias, j, nvec, bs);

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
        if (mean_out != nullptr && j == 0) {
          mean_out[row] = mean;
          rstd_out[row] = inv;
        }
      }
    }
  }
}

// Backward over rows, one row step per iteration. Writes dx and, per block,
// one (C,) row of partial sums of dy * xhat at partial[blockIdx.x] and of dy
// at partial[gridDim.x + blockIdx.x]. Dynamic shared memory: 2 *
// kWarpsPerBlock * C floats.
template <typename T, int VEC, int L, int NV>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ weight, const float* __restrict__ mean,
                    const float* __restrict__ rstd, T* __restrict__ dx,
                    float* __restrict__ partial, long long rows, int C) {
  constexpr int G = 32 / L;
  using P = Pack<T, VEC>;
  extern __shared__ float s_sums[];
  float* s_dw = s_sums;                        // [kWarpsPerBlock][C]
  float* s_db = s_sums + kWarpsPerBlock * C;   // [kWarpsPerBlock][C]
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int sub = lane / L, j = lane % L;
  const int nvec = C / VEC;
  const float inv_c = 1.f / C;

  float w[NV][VEC], acc_w[NV][VEC], acc_b[NV][VEC];
  load_channels<VEC, L, NV>(weight, j, nvec, w);
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_w[v][e] = acc_b[v][e] = 0.f;

  const long long warp = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + wib;
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  for (long long r0 = warp * G; r0 < rows; r0 += n_warps * G) {
    const long long row = r0 + sub;
    const bool live = row < rows;
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    float xh[NV][VEC], d[NV][VEC];
    float s1 = 0.f, s2 = 0.f;
    const P* xr = reinterpret_cast<const P*>(x + row * C);
    const P* dyr = reinterpret_cast<const P*>(dy + row * C);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int p = j + v * L;
      if (live && p < nvec) {
        const P qx = xr[p];
        const P qd = dyr[p];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xh[v][e] = (to_float(qx.v[e]) - mu) * rs;
          d[v][e] = to_float(qd.v[e]);
          const float g = d[v][e] * w[v][e];
          s1 += g;
          s2 += g * xh[v][e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xh[v][e] = d[v][e] = 0.f;
      }
    }
    const float mean_g = group_sum<L>(s1) * inv_c;
    const float mean_gx = group_sum<L>(s2) * inv_c;
    if (live) {
      P* dxr = reinterpret_cast<P*>(dx + row * C);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int p = j + v * L;
        if (p < nvec) {
          P q;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            q.v[e] = from_float<T>(rs * (d[v][e] * w[v][e] - mean_g - xh[v][e] * mean_gx));
            acc_w[v][e] += d[v][e] * xh[v][e];
            acc_b[v][e] += d[v][e];
          }
          dxr[p] = q;
        }
      }
    }
  }
  // fold the warp's G row groups (lanes j, j + L, ...) onto lanes 0..L-1
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc_w[v][e] += __shfl_xor_sync(0xffffffffu, acc_w[v][e], off);
        acc_b[v][e] += __shfl_xor_sync(0xffffffffu, acc_b[v][e], off);
      }
  }
  if (sub == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int p = j + v * L;
      if (p < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          s_dw[wib * C + p * VEC + e] = acc_w[v][e];
          s_db[wib * C + p * VEC + e] = acc_b[v][e];
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kWarpsPerBlock; ++k) {
      a += s_dw[k * C + c];
      b += s_db[k * C + c];
    }
    partial[static_cast<long long>(blockIdx.x) * C + c] = a;
    partial[static_cast<long long>(gridDim.x + blockIdx.x) * C + c] = b;
  }
}

// dweight / dbias = the column sums of the (nblocks, C) partial buffers, in a
// fixed order: blockIdx.y picks the buffer, each block owns 32 columns, warp k
// sums rows k, k + 8, ... and warp 0 adds the eight warps' sums in order.
__global__ void __launch_bounds__(kReduceWarps * 32)
layer_norm_bwd_reduce(const float* __restrict__ partial, int nblocks, int C,
                      float* __restrict__ dweight, float* __restrict__ dbias) {
  __shared__ float s[kReduceWarps][32];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* src = partial + static_cast<long long>(blockIdx.y) * nblocks * C;
  float a = 0.f;
  if (c < C)
    for (int r = wib; r < nblocks; r += kReduceWarps) a += src[static_cast<long long>(r) * C + c];
  s[wib][lane] = a;
  __syncthreads();
  if (wib == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) t += s[k][lane];
    (blockIdx.y == 0 ? dweight : dbias)[c] = t;
  }
}

struct Forward {
  const void *x, *w, *b;
  void* y;
  float *mean, *rstd;
  int rows, C;
  float eps;
  cudaStream_t stream;

  template <typename T, int VEC, int L, int NV>
  cudaError_t run() const {
    constexpr int per_warp = (32 / L) * row_steps<NV, VEC>();
    const long long warps = (static_cast<long long>(rows) + per_warp - 1) / per_warp;
    const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
    layer_norm_rows<T, VEC, L, NV><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<T*>(y), mean, rstd, rows, C, eps);
    return cudaGetLastError();
  }
};

struct Backward {
  const void *x, *dy, *w, *mean, *rstd;
  void* dx;
  float *partial, *dw, *db;
  int rows, C;
  cudaStream_t stream;

  template <typename T, int VEC, int L, int NV>
  cudaError_t run() const {
    constexpr int per_warp = 32 / L;
    const long long warps = (static_cast<long long>(rows) + per_warp - 1) / per_warp;
    const long long need = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = 2 * kWarpsPerBlock * C * sizeof(float);
    auto kernel = layer_norm_bwd_rows<T, VEC, L, NV>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
    if (blocks > kMaxBwdBlocks) blocks = kMaxBwdBlocks;
    if (blocks > need) blocks = need;
    kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(w),
        static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
        partial, rows, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    layer_norm_bwd_reduce<<<dim3((C + 31) / 32, 2), kReduceWarps * 32, 0, stream>>>(
        partial, static_cast<int>(blocks), C, dw, db);
    return cudaGetLastError();
  }
};

// The instantiation for C: the vector path moves 16 bytes per access (C * the
// element size a multiple of 16 and every pointer 16-byte aligned, else the
// launch is refused), the scalar path one element, a full warp per row.
template <typename T, typename Op>
cudaError_t dispatch(const Op& op, int C, int vector, uintptr_t any_ptr) {
  if (!vector) {
    if (C <= 32) return op.template run<T, 1, 32, 1>();
    if (C <= 64) return op.template run<T, 1, 32, 2>();
    if (C <= 128) return op.template run<T, 1, 32, 4>();
    if (C <= 256) return op.template run<T, 1, 32, 8>();
    if (C <= 512) return op.template run<T, 1, 32, 16>();
    return op.template run<T, 1, 32, 32>();
  }
  if (any_ptr % 16 != 0 || (C * sizeof(T)) % 16 != 0) return cudaErrorMisalignedAddress;
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = C / VEC;
  if (nvec <= 8) return op.template run<T, VEC, 8, 1>();
  if (nvec <= 16) return op.template run<T, VEC, 16, 1>();
  if (nvec <= 32) return op.template run<T, VEC, 32, 1>();
  if (nvec <= 64) return op.template run<T, VEC, 32, 2>();
  if (nvec <= 128) return op.template run<T, VEC, 32, 4>();
  return op.template run<T, VEC, 32, 8>();
}

template <typename Op>
cudaError_t dispatch_dtype(const Op& op, int dtype, int C, int vector, uintptr_t any_ptr) {
  if (dtype == 0) return dispatch<float>(op, C, vector, any_ptr);
  if (dtype == 1) return dispatch<__nv_bfloat16>(op, C, vector, any_ptr);
  return cudaErrorInvalidValue;
}

uintptr_t any_bits(std::initializer_list<const void*> ptrs) {
  uintptr_t out = 0;
  for (const void* p : ptrs) out |= reinterpret_cast<uintptr_t>(p);
  return out;
}

}  // namespace

// Forward. dtype: 0 = float32, 1 = bfloat16; vector: 1 = 16-byte accesses,
// 0 = one element per access. mean and rstd (rows,) fp32 are written when not
// null (training). Returns the cudaError_t of the launch (0 = cudaSuccess).
// The caller guarantees 0 < rows, 0 < C <= 1024, contiguous (rows, C) input
// and output, and (C,) float32 weight and bias.
extern "C" int gdrn_layer_norm_fwd(const void* x, const void* weight, const void* bias, void* y,
                                   void* mean, void* rstd, int rows, int C, float eps, int dtype,
                                   int vector, void* stream) {
  if (rows <= 0 || C <= 0 || C > kMaxChannels || ((mean == nullptr) != (rstd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Forward op{x, weight, bias, y, static_cast<float*>(mean), static_cast<float*>(rstd),
                   rows, C, eps, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_dtype(op, dtype, C, vector, any_bits({x, weight, bias, y})));
}

// Backward: two launches, the rows then the fixed-order reduction of the
// per-block sums. x, dy, dx (rows, C) contiguous of one dtype; weight (C,),
// mean and rstd (rows,) fp32 from the forward; partial holds at least
// 2 * 1024 * C floats of scratch; dweight and dbias (C,) fp32 are written,
// not accumulated into.
extern "C" int gdrn_layer_norm_bwd(const void* x, const void* dy, const void* weight,
                                   const void* mean, const void* rstd, void* dx, void* partial,
                                   void* dweight, void* dbias, int rows, int C, int dtype,
                                   int vector, void* stream) {
  if (rows <= 0 || C <= 0 || C > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  const Backward op{x, dy, weight, mean, rstd, dx, static_cast<float*>(partial),
                    static_cast<float*>(dweight), static_cast<float*>(dbias), rows, C,
                    static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_dtype(op, dtype, C, vector, any_bits({x, dy, weight, dx})));
}
