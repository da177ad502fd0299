// Batched z-buffer triangle rasterizer for Hopper (sm_90a): kernel B2.
//
// Replaces the Pallas TPU kernel gdrnpp_bop2022_tpu/ops/pallas_raster.py::_raster_kernel
// (wrapper render_depth_xyz_pallas). Same function: for each ROI b and pixel
// centre (x, y) at integer coordinates, loop over the ROI's faces packed by
// ops/raster.py::_pack_face_data (rows x0 y0 x1 y1 x2 y2 iz0 iz1 iz2 valid
// inv_area [a0xyz a1xyz a2xyz], each of length F); edge-function barycentrics
// with a -1e-5 seam tolerance; perspective-correct depth 1 / sum(w_i * iz_i);
// z-test. Depth-only mode (kAttrs = false) keeps a running min; attribute mode
// keeps the winner (strict <, so the first face wins an exact tie, as in the
// plain version) and interpolates its object XYZ perspective-correct once, at
// the end. Depth and xyz are 0 where nothing is hit.
//
// Bound: fp32 operations, not bytes. A flagship depth-refine launch is
// 64 ROIs x 64^2 pixels x ~4096 faces = 1.07e9 pixel-face tests of 18 fp32
// operations each (the two edge functions and w2; 7 more where the pixel is
// inside); it reads 44 B per face per block from L2 and writes 4 B (16 B
// with xyz) per pixel. The design keeps the inner loop on registers and
// shared memory:
//   * grid (pixel tile, ROI), 256 threads, one pixel per thread (integer
//     div/mod of the flat index; the ragged tail is masked);
//   * the ROI's faces are staged into shared memory 512 at a time, 12 floats
//     per face (11 packed + 1 pad) so each face is three float4 broadcast
//     loads; a ragged last tile is handled by its count;
//   * the attribute rows are read from device memory only for the winning
//     face of each pixel, after the loop, so both modes stage 11 rows.
// Rounding: this file is built with -fmad=false (utils/cuda_build.py) and
// keeps the JAX operation order (pallas_raster.py:87-96), so each product
// rounds as in the plain PyTorch version and seam pixels agree.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFaceTile = 512;
constexpr int kStride = 12;    // floats per staged face: 11 rows + 1 pad
constexpr int kRowsStaged = 11;
constexpr float kBig = 1e9f;
constexpr float kEdgeEps = -1e-5f;

template <bool kAttrs>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ face_data, int n_rows, int F, int H, int W,
              float* __restrict__ depth, float* __restrict__ xyz) {
  __shared__ float4 tile[kFaceTile * kStride / 4];
  float* tile_f = reinterpret_cast<float*>(tile);

  const int b = blockIdx.y;
  const long long P = static_cast<long long>(H) * W;
  const long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = p < P;
  const float py = active ? static_cast<float>(p / W) : 0.f;
  const float px = active ? static_cast<float>(p % W) : 0.f;
  const float* fd = face_data + static_cast<long long>(b) * n_rows * F;

  float best_z = kBig;
  int best_f = -1;
  float best_w0 = 0.f, best_w1 = 0.f;

  for (int f0 = 0; f0 < F; f0 += kFaceTile) {
    const int nf = min(kFaceTile, F - f0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < nf * kRowsStaged; i += kThreads) {
      const int r = i / nf, j = i - r * nf;  // consecutive threads, consecutive faces
      tile_f[j * kStride + r] = fd[static_cast<long long>(r) * F + f0 + j];
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 4
    for (int j = 0; j < nf; ++j) {
      const float4 a = tile[3 * j];      // x0 y0 x1 y1
      const float4 c = tile[3 * j + 1];  // x2 y2 iz0 iz1
      const float4 d = tile[3 * j + 2];  // iz2 valid inv_area pad
      if (!(d.y > 0.5f)) continue;
      const float w0 = ((a.z - px) * (c.y - py) - (c.x - px) * (a.w - py)) * d.z;
      const float w1 = ((c.x - px) * (a.y - py) - (a.x - px) * (c.y - py)) * d.z;
      const float w2 = 1.f - w0 - w1;
      if (!(w0 >= kEdgeEps && w1 >= kEdgeEps && w2 >= kEdgeEps)) continue;
      const float izp = w0 * c.z + w1 * c.w + w2 * d.x;
      const float zp = 1.f / fmaxf(izp, 1e-12f);
      if (!(zp > 1e-6f)) continue;
      if (kAttrs) {
        if (zp < best_z) {
          best_z = zp;
          best_f = f0 + j;
          best_w0 = w0;
          best_w1 = w1;
        }
      } else {
        best_z = fminf(best_z, zp);
      }
    }
  }
  if (!active) return;

  const long long o = static_cast<long long>(b) * P + p;
  const bool hit = best_z < kBig * 0.5f;
  depth[o] = hit ? best_z : 0.f;
  if (kAttrs) {
    float out[3] = {0.f, 0.f, 0.f};
    if (hit) {
      const float w2 = 1.f - best_w0 - best_w1;
      const float iz0 = fd[6LL * F + best_f];
      const float iz1 = fd[7LL * F + best_f];
      const float iz2 = fd[8LL * F + best_f];
      const float iz = fmaxf(best_w0 * iz0 + best_w1 * iz1 + w2 * iz2, 1e-12f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float num = best_w0 * fd[(11LL + k) * F + best_f] * iz0
                        + best_w1 * fd[(14LL + k) * F + best_f] * iz1
                        + w2 * fd[(17LL + k) * F + best_f] * iz2;
        out[k] = num / iz;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) xyz[3 * o + k] = out[k];
  }
}

}  // namespace

// face_data: (B, n_rows, F) float32, n_rows = 11 (depth only) or 20 (with
// attributes). depth: (B, H, W) float32; xyz: (B, H, W, 3) float32 or null
// when with_attrs is 0. Returns the cudaError_t of the launch (0 = success).
extern "C" int gdrn_raster_fwd(const void* face_data, int B, int n_rows, int F, int H, int W,
                               void* depth, void* xyz, int with_attrs, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || F < 0 || n_rows < kRowsStaged ||
      (with_attrs && (n_rows < 20 || xyz == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (static_cast<long long>(H) * W + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fd = static_cast<const float*>(face_data);
  float* dp = static_cast<float*>(depth);
  if (with_attrs)
    raster_kernel<true><<<grid, kThreads, 0, s>>>(fd, n_rows, F, H, W, dp, static_cast<float*>(xyz));
  else
    raster_kernel<false><<<grid, kThreads, 0, s>>>(fd, n_rows, F, H, W, dp, nullptr);
  return static_cast<int>(cudaGetLastError());
}
