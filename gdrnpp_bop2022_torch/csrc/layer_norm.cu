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
//     32 / L rows at once (2 at C = 128 in bf16) and its accesses of one step
//     are contiguous; row statistics (forward) and the two row means
//     (backward) are reduced with shuffles inside the group;
//   * forward: the row's values stay in registers, so the second pass reads
//     no memory; each warp takes two row steps at once where a lane holds at
//     most 16 values (up to four 16-byte loads in flight per lane), in a
//     grid-stride loop over a grid of 4-warp blocks that covers every row once
//     (a grid of SM count x resident blocks, each warp walking several rows,
//     was slower on an H100);
//   * backward, vector path (every main-path call). A training step at batch
//     48 makes 40 calls of 5.6-45 us each at the bytes bound, so what a call
//     costs besides its bytes counts as much as bandwidth. Three such costs,
//     and what the design does about each:
//       1. fixed costs per call: a scratch row of weight-gradient sums per
//          block of a large grid, and host queries of the device, cost a
//          short call as much as its rows. Here a persistent grid of two
//          blocks per SM (one where a row is over 1 KB), and never more
//          blocks than tiles, so each block writes one (C,) row per output:
//          the scratch has 132-264 rows. The caller sizes that scratch, and
//          so the grid, from the SM count it keeps per device, and the
//          library cuts the grid to the call's tiles; it sets the
//          shared-memory limit once per device and instantiation;
//       2. bytes in flight: a warp whose next row waits for this row's
//          shuffles leaves the memory system idle. Here one producer warp per
//          block keeps a ring of kBwdStages tiles of 8-32 rows filled with
//          1-D bulk copies (cp.async.bulk, completion on an mbarrier): a
//          tile's x rows, dy rows, mean and rstd, started as soon as a stage
//          is free, so the loads in flight use no registers; eight consumer
//          warps compute from shared memory, a row group two rows at once
//          where a lane holds at most 16 values;
//       3. register pressure: x, dy, weight and two sums per channel in
//          registers leave room for few rows in flight. Here a lane keeps
//          weight and its dweight / dbias sums in registers across all of
//          the block's tiles, and reads x and dy from the ring twice (the two
//          row means, then dx) instead of holding them; no instantiation
//          spills (-Xptxas -v).
//     The block's warps fold their sums through shared memory into one (C,)
//     row per output, and layer_norm_bwd_reduce, a programmatic dependent
//     launch that starts while the tiles finish, sums those rows over blocks
//     in a fixed order. No atomics on floats and nothing that outlives a
//     call: the grid depends only on (rows, C, dtype) and the SM count, so
//     two runs give the same bits. The caller owns the scratch (a fresh
//     tensor a call, from PyTorch's allocator);
//   * backward, scalar path (C * the element size not a multiple of 16 bytes,
//     or a pointer not 16-byte aligned: no main-path call): the first design,
//     kept for those shapes. A grid of as many 4-warp blocks as the card holds
//     at once (at most kMaxBwdBlocks, the rows of its scratch), one row step
//     per iteration with the row in registers; each block writes one (C,) row
//     of partial sums and layer_norm_bwd_reduce sums them;
//   * forward and scalar backward: weight and bias for a lane's channels are
//     loaded into registers once per warp (as float4 on the vector path);
//   * scalar path, the same kernels with one element per access (VEC = 1,
//     L = 32): C not a multiple of 16 bytes, or a pointer not 16-byte
//     aligned (for the backward also mean and rstd).
//     ops/layer_norm.py::_vector_path picks the path.
// A bound check on the last rows replaces the Pallas kernel's padding of rows
// to a 256-row tile.

#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxChannels = 1024;
// the scalar backward's grid (and the rows of its partial-sum buffer) at most
constexpr int kMaxBwdBlocks = 1024;
constexpr int kReduceWarps = 32;
// the vector backward: consumer warps per block (plus one producer warp);
// stages of its ring (two measured faster than three or four on an H100)
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = (kBwdWarps + 1) * 32;
constexpr int kBwdStages = 2;
// the most dynamic shared memory a block gets without raising its limit
constexpr size_t kDefaultSmem = 48 << 10;
constexpr int kMaxDevices = 64;

// rows a consumer row group computes at once (interleaved, so that more
// loads and shuffles are in flight): two where a lane holds at most 16
// values of a row, else one (also more, smaller tiles for the grid's few
// rows at C = 1024)
template <int NV>
__host__ __device__ constexpr int bwd_row_steps() { return NV <= 2 ? 2 : 1; }

// the register budget: two blocks an SM leave 96 registers a thread, too
// few where a lane sums 32 channels or more (C > 512 in bf16)
template <int VEC, int NV>
__host__ __device__ constexpr int bwd_min_blocks() { return NV * VEC >= 32 ? 1 : 2; }

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

// fold a warp's G row groups of per-lane channel sums (lanes j, j + L, ...)
// onto lanes 0..L-1
template <int VEC, int L, int NV>
__device__ __forceinline__ void fold_row_groups(float (&acc_w)[NV][VEC], float (&acc_b)[NV][VEC]) {
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

// Backward of the scalar path, one row step per iteration. Writes dx and, per
// block, one (C,) row of partial sums of dy * xhat at partial[blockIdx.x] and
// of dy at partial[gridDim.x + blockIdx.x]. Dynamic shared memory: 2 *
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
  fold_row_groups<VEC, L, NV>(acc_w, acc_b);
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
// sums rows k, k + 32, ... and warp 0 adds the 32 warps' sums in order (a
// warp has 4-9 rows of a vector-path grid in flight at once). Launched as the
// rows kernel's programmatic dependent: it waits here for that grid's writes.
__global__ void __launch_bounds__(kReduceWarps * 32)
layer_norm_bwd_reduce(const float* __restrict__ partial, int nblocks, int C,
                      float* __restrict__ dweight, float* __restrict__ dbias) {
  __shared__ float s[kReduceWarps][32];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* src = partial + static_cast<long long>(blockIdx.y) * nblocks * C;
  float a = 0.f;
  if (c < C) {
#pragma unroll 8
    for (int r = wib; r < nblocks; r += kReduceWarps) a += src[static_cast<long long>(r) * C + c];
  }
  s[wib][lane] = a;
  __syncthreads();
  if (wib == 0 && c < C) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kReduceWarps; ++k) t += s[k][lane];
    (blockIdx.y == 0 ? dweight : dbias)[c] = t;
  }
}

// --- the vector backward: bulk copies into a ring of row tiles -------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// block until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory, completing `bytes` transactions on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Rows of a tile of the vector backward: each consumer warp takes RS steps of
// its G row groups.
template <int L, int NV>
__host__ __device__ constexpr int bwd_tile_rows() { return kBwdWarps * (32 / L) * bwd_row_steps<NV>(); }

// Shared memory of layer_norm_bwd_tiles: the 2 x kBwdStages mbarriers (full,
// empty) in the first 128 bytes, then the ring; each stage holds x
// (tile_rows, C), dy (tile_rows, C), mean and rstd (tile_rows,). After the
// rows, the ring holds the block's 2 x kBwdWarps x C fp32 sums.
template <typename T>
__host__ __device__ constexpr size_t bwd_stage_bytes(int tile_rows, int C) {
  return 2 * static_cast<size_t>(tile_rows) * C * sizeof(T) + 2 * tile_rows * sizeof(float);
}

template <typename T>
__host__ __device__ constexpr size_t bwd_smem(int tile_rows, int C) {
  const size_t ring = kBwdStages * bwd_stage_bytes<T>(tile_rows, C);
  const size_t sums = 2 * kBwdWarps * static_cast<size_t>(C) * sizeof(float);
  return 128 + (ring > sums ? ring : sums);
}

// Backward of the vector path (VEC values per 16-byte access, L lanes per row,
// NV accesses per lane and row). Block b takes tiles b, b + grid, ... of
// bwd_tile_rows<L, NV>() rows; warp kBwdWarps is the producer, warps
// 0..kBwdWarps-1 consume, each row group RS rows of a tile at once. Writes
// dx, and the block's sums of dy * xhat at partial[blockIdx.x] and of dy at
// partial[gridDim.x + blockIdx.x] ((C,) rows) for layer_norm_bwd_reduce.
template <typename T, int VEC, int L, int NV>
__global__ void __launch_bounds__(kBwdThreads, (bwd_min_blocks<VEC, NV>()))
layer_norm_bwd_tiles(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ weight, const float* __restrict__ mean,
                     const float* __restrict__ rstd, T* __restrict__ dx,
                     float* __restrict__ partial, long long rows, int C) {
  constexpr int G = 32 / L;
  constexpr int RS = bwd_row_steps<NV>();
  constexpr int tile_rows = bwd_tile_rows<L, NV>();
  using P = Pack<T, VEC>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kBwdStages;
  unsigned char* ring = smem + 128;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / L, j = lane % L;
  const int nvec = C / VEC;
  const float inv_c = 1.f / C;
  const size_t tile_elems = static_cast<size_t>(tile_rows) * C;
  const size_t stage_bytes = bwd_stage_bytes<T>(tile_rows, C);

  // tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the rows
  const long long all_tiles = (rows + tile_rows - 1) / tile_rows;
  const int n_tiles = blockIdx.x < all_tiles
      ? static_cast<int>((all_tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBwdWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  float acc_w[NV][VEC], acc_b[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_w[v][e] = acc_b[v][e] = 0.f;

  if (warp == kBwdWarps) {
    // producer: one lane keeps up to kBwdStages tiles in flight, from the
    // start; stage s's k-th fill waits for the consumers' (k - 1)-th release
    if (lane == 0) {
      for (int k = 0; k < n_tiles; ++k) {
        const int s = k % kBwdStages, round = k / kBwdStages;
        if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
        const long long row0 = (blockIdx.x + static_cast<long long>(k) * gridDim.x) * tile_rows;
        const int n = static_cast<int>(rows - row0 < tile_rows ? rows - row0 : tile_rows);
        // mean and rstd in whole 16-byte groups (row0 is a multiple of 8 and
        // the caller aligns both to 16 bytes); the consumers load the last
        // n % 4 values of a ragged last tile themselves
        const int n_stats = n & ~3;
        const uint32_t bytes = static_cast<uint32_t>(n) * C * sizeof(T);
        unsigned char* st = ring + s * stage_bytes;
        T* xs = reinterpret_cast<T*>(st);
        T* dys = xs + tile_elems;
        float* mus = reinterpret_cast<float*>(dys + tile_elems);
        float* rss = mus + tile_rows;
        mbar_arrive_expect_tx(&full[s], 2 * bytes + 8u * n_stats);
        bulk_load(xs, x + row0 * C, bytes, &full[s]);
        bulk_load(dys, dy + row0 * C, bytes, &full[s]);
        if (n_stats > 0) {
          bulk_load(mus, mean + row0, 4u * n_stats, &full[s]);
          bulk_load(rss, rstd + row0, 4u * n_stats, &full[s]);
        }
      }
    }
    __syncwarp();
  } else {
    // weight for the lane's channels, in registers (read from shared memory
    // for every element, it made the consumers bound by shared-memory
    // bandwidth), loaded while the first tiles are in flight
    float w[NV][VEC];
    load_channels<VEC, L, NV>(weight, j, nvec, w);
    for (int k = 0; k < n_tiles; ++k) {
      const int s = k % kBwdStages;
      mbar_wait(&full[s], (k / kBwdStages) & 1);
      const long long row0 = (blockIdx.x + static_cast<long long>(k) * gridDim.x) * tile_rows;
      const int n = static_cast<int>(rows - row0 < tile_rows ? rows - row0 : tile_rows);
      const int n_stats = n & ~3;
      const unsigned char* st = ring + s * stage_bytes;
      const T* xs = reinterpret_cast<const T*>(st);
      const T* dys = xs + tile_elems;
      const float* mus = reinterpret_cast<const float*>(dys + tile_elems);
      const float* rss = mus + tile_rows;
      float mu[RS], rs[RS], s1[RS], s2[RS];
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int r = (warp * RS + i) * G + sub;  // the row in the tile
        mu[i] = rs[i] = s1[i] = s2[i] = 0.f;
        if (r < n) {
          mu[i] = r < n_stats ? mus[r] : mean[row0 + r];
          rs[i] = r < n_stats ? rss[r] : rstd[row0 + r];
          const P* xr = reinterpret_cast<const P*>(xs + static_cast<size_t>(r) * C);
          const P* dyr = reinterpret_cast<const P*>(dys + static_cast<size_t>(r) * C);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int p = j + v * L;
            if (p < nvec) {
              const P qx = xr[p], qd = dyr[p];
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                const float g = to_float(qd.v[e]) * w[v][e];
                s1[i] += g;
                s2[i] = fmaf(g, fmaf(to_float(qx.v[e]), rs[i], -mu[i] * rs[i]), s2[i]);
              }
            }
          }
        }
      }
      float mean_g[RS], mean_gx[RS];
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        mean_g[i] = group_sum<L>(s1[i]) * inv_c;
        mean_gx[i] = group_sum<L>(s2[i]) * inv_c;
      }
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int r = (warp * RS + i) * G + sub;
        if (r < n) {
          const P* xr = reinterpret_cast<const P*>(xs + static_cast<size_t>(r) * C);
          const P* dyr = reinterpret_cast<const P*>(dys + static_cast<size_t>(r) * C);
          P* dxr = reinterpret_cast<P*>(dx + (row0 + r) * C);
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            const int p = j + v * L;
            if (p < nvec) {
              const P qx = xr[p], qd = dyr[p];
              P q;
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                const float d = to_float(qd.v[e]);
                const float xh = fmaf(to_float(qx.v[e]), rs[i], -mu[i] * rs[i]);
                q.v[e] = from_float<T>(rs[i] * fmaf(-xh, mean_gx[i], fmaf(d, w[v][e], -mean_g[i])));
                acc_w[v][e] = fmaf(d, xh, acc_w[v][e]);
                acc_b[v][e] += d;
              }
              dxr[p] = q;
            }
          }
        }
      }
      // the warp has read stage s: one arrival of the kBwdWarps that free it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    fold_row_groups<VEC, L, NV>(acc_w, acc_b);
  }
  __syncthreads();  // every tile consumed: the ring now holds the warps' sums
  float* s_dw = reinterpret_cast<float*>(ring);  // [kBwdWarps][C]
  float* s_db = s_dw + kBwdWarps * C;            // [kBwdWarps][C]
  if (warp < kBwdWarps && sub == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int p = j + v * L;
      if (p < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {  // 16-byte stores: no 8-way bank conflicts
          *reinterpret_cast<float4*>(s_dw + warp * C + p * VEC + e) =
              make_float4(acc_w[v][e], acc_w[v][e + 1], acc_w[v][e + 2], acc_w[v][e + 3]);
          *reinterpret_cast<float4*>(s_db + warp * C + p * VEC + e) =
              make_float4(acc_b[v][e], acc_b[v][e + 1], acc_b[v][e + 2], acc_b[v][e + 3]);
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kBwdThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdWarps; ++k) {
      a += s_dw[k * C + c];
      b += s_db[k * C + c];
    }
    partial[static_cast<long long>(blockIdx.x) * C + c] = a;
    partial[static_cast<long long>(gridDim.x + blockIdx.x) * C + c] = b;
  }
  // the reduction, launched as this kernel's programmatic dependent, may start
  // its launch now; it still waits for this grid to finish (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// A value that costs a CUDA runtime query, computed at the first call on the
// current device and kept: `cache` is one instantiation's table, 0 = not
// yet; `query` writes a value >= 1.
template <typename Query>
cudaError_t once_per_device(std::atomic<int> (&cache)[kMaxDevices], Query query, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return query(value);
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    err = query(&v);
    if (err != cudaSuccess) return err;
    cache[dev].store(v, std::memory_order_relaxed);
  }
  *value = v;
  return cudaSuccess;
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
  int partial_rows, rows, C;
  cudaStream_t stream;

  template <typename T, int VEC, int L, int NV>
  cudaError_t run() const {
    static std::atomic<int> cache[kMaxDevices];  // this instantiation's, per device
    int blocks = 0;
    cudaError_t err;
    if constexpr (VEC == 1) {
      // the scalar path: as many blocks as the card holds at once, at most
      // kMaxBwdBlocks and no more than the rows need
      constexpr int per_warp = 32 / L;
      const long long warps = (static_cast<long long>(rows) + per_warp - 1) / per_warp;
      const long long need = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
      const size_t smem = 2 * kWarpsPerBlock * C * sizeof(float);
      auto kernel = layer_norm_bwd_rows<T, VEC, L, NV>;
      err = once_per_device(cache, [&](int* out) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        // with the shared memory of this instantiation's largest C
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, kThreads, 2 * kWarpsPerBlock * L * NV * sizeof(float));
        *out = (per_sm > 0 ? per_sm : 1) * sms;
        return e;
      }, &blocks);
      if (err != cudaSuccess) return err;
      if (blocks > kMaxBwdBlocks) blocks = kMaxBwdBlocks;
      if (blocks > need) blocks = static_cast<int>(need);
      if (blocks > partial_rows) return cudaErrorInvalidValue;
      kernel<<<blocks, kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(w),
          static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
          partial, rows, C);
    } else {
      // the vector path: a persistent grid of the caller's partial_rows
      // blocks (ops/layer_norm.py::bwd_scratch_rows), or of one block a tile
      // where the call has fewer tiles
      constexpr int tile_rows = bwd_tile_rows<L, NV>();
      const long long tiles = (static_cast<long long>(rows) + tile_rows - 1) / tile_rows;
      blocks = tiles < partial_rows ? static_cast<int>(tiles) : partial_rows;
      const size_t smem = bwd_smem<T>(tile_rows, C);
      auto kernel = layer_norm_bwd_tiles<T, VEC, L, NV>;
      // a ring over 48 KB needs the kernel's limit raised: once per device,
      // to the most any C of this instantiation asks for
      if (smem > kDefaultSmem) {
        int done = 0;
        err = once_per_device(cache, [&](int* out) {
          *out = 1;
          return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(bwd_smem<T>(tile_rows, VEC * L * NV)));
        }, &done);
        if (err != cudaSuccess) return err;
      }
      kernel<<<blocks, kBwdThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(w),
          static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(dx),
          partial, rows, C);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // a programmatic dependent launch: set up while the rows kernel runs
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((C + 31) / 32, 2);
    cfg.blockDim = dim3(kReduceWarps * 32);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const float* pc = partial;
    float *dwt = dw, *dbt = db;
    return cudaLaunchKernelEx(&cfg, layer_norm_bwd_reduce, pc, blocks, C, dwt, dbt);
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
  // C <= kMaxChannels: nvec <= 128 in bf16, so only fp32 instantiates NV = 8
  if constexpr (VEC * 128 >= kMaxChannels) {
    return op.template run<T, VEC, 32, 4>();
  } else {
    if (nvec <= 128) return op.template run<T, VEC, 32, 4>();
    return op.template run<T, VEC, 32, 8>();
  }
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

// Backward: two launches, the rows, then the fixed-order sum of their blocks'
// rows of partial sums (a programmatic dependent launch). x, dy, dx (rows, C)
// contiguous of one dtype; weight (C,), mean and rstd (rows,) contiguous fp32
// from the forward; partial holds 2 x partial_rows x C floats of scratch;
// dweight and dbias (C,) fp32 are written, not accumulated into. The rows
// kernel launches at most partial_rows blocks: on the vector path that many
// persistent blocks (the caller's ops/layer_norm.py::bwd_scratch_rows) or one
// a tile where there are fewer tiles; on the scalar path as many as the card
// holds at once (the caller gives kMaxBwdBlocks).
extern "C" int gdrn_layer_norm_bwd(const void* x, const void* dy, const void* weight,
                                   const void* mean, const void* rstd, void* dx, void* partial,
                                   int partial_rows, void* dweight, void* dbias,
                                   int rows, int C, int dtype, int vector, void* stream) {
  if (rows <= 0 || C <= 0 || C > kMaxChannels || partial_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Backward op{x, dy, weight, mean, rstd, dx, static_cast<float*>(partial),
                    static_cast<float*>(dweight), static_cast<float*>(dbias), partial_rows,
                    rows, C, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch_dtype(
      op, dtype, C, vector, any_bits({x, dy, weight, mean, rstd, dx})));
}
