// Batched z-buffer triangle rasterizer for Hopper (sm_90a): kernel B2.
//
// Replaces the Pallas TPU kernel gdrnpp_bop2022_tpu/ops/pallas_raster.py::_raster_kernel
// together with the XLA face packing in front of it (_pack_face_data; wrapper
// render_depth_xyz_pallas). Same function: for each ROI b and pixel centre
// (x, y) at integer coordinates, over the ROI's faces: edge-function
// barycentrics with a -1e-5 seam tolerance, perspective-correct depth
// 1 / sum(w_i * iz_i), z-test. Depth-only mode (kAttrs = false) keeps a running
// min; attribute mode keeps the winner (strict <, so the first face wins an
// exact tie, as in the plain version) and interpolates its object XYZ
// perspective-correct once, at the end. Depth and xyz are 0 where nothing is hit.
//
// Two launches per call:
//   * pack_faces_kernel, one thread per (ROI, face): R v + t, the projection
//     with the ROI's K (skew included), 1/z, the validity flag and 1/area (and
//     the 9 object-space attribute values), written face-major as 12 (24)
//     floats = 3 (6) float4 per face, plus the face's conservative screen box
//     (ops/raster.py::face_screen_boxes states the rule);
//   * raster_kernel, grid (32x8 pixel tile, ROI), one pixel per thread, each
//     warp an 8x4 block of pixels. For each chunk of 256 faces, every thread
//     tests one face's box against the tile, the survivors are compacted into
//     shared memory in face order (__ballot_sync/__popc within a warp, a
//     prefix over the 8 warps' counts), and each pixel loops over the
//     survivors only: a warp first keeps, by one ballot per 32 survivors,
//     those whose box meets its 8x4 pixels. The next chunk's boxes are loaded
//     while this chunk is rasterized.
//
// Bound: fp32 operations. The work these inputs need is one test of 18 fp32
// operations (two edge functions and w2) per pixel whose centre lies inside a
// valid face's screen box; chip_smoke.py::raster_bound counts those pairs (at
// the flagship, 64 ROIs x 64^2 px x 4096-face ellipsoids: 8.2e6, 1/130 of the
// 1.07e9 all-pairs tests of the TPU kernel and of the first CUDA version) and
// prints the all-pairs figure beside it. This kernel tests a face that meets
// a warp's 8x4 pixels at all 32 of them, so it does several times the counted
// work. Bytes are small: the inputs are read once, and 4 B (16 B with xyz)
// are written per pixel. The inner loop runs on registers and broadcast
// shared-memory loads; a 16-byte box load and four integer compares per face
// and tile skip the faces that cannot cover any of the tile's pixels. Tensor
// cores do not apply: the edge functions must be fp32 and round as the plain
// version does.
//
// The box is conservative (ops/raster.py::face_screen_boxes gives the
// argument): with S = box width + height, a pixel centre that passes
// w_i >= -1e-5 in exact arithmetic lies at most 3e-5 S outside the face's
// box, and the margin is m = 1 + 1e-4 S px. Where rounding could move a
// barycentric by more than the margin allows (a sliver, whose computed
// barycentrics far from it are noise), where a coordinate is non-finite, or
// where the extent exceeds 2^20 px (a vertex near the z = 1e-6 plane), the
// face gets the whole image; an invalid face gets an empty box, so the inner
// loop needs no valid flag.
// Rounding: this file is built with -fmad=false and IEEE division
// (utils/cuda_build.py) and keeps the operation order of
// ops/raster.py::transform_verts, ::_pack_face_data and
// pallas_raster.py:87-96, so the packed values equal the torch packing and
// seam pixels agree with the plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // on an H100, 16x16 tiles measured slower, 8x32 the same (PERF.md)
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;  // one pixel per thread
constexpr int kWarps = kThreads / 32;
constexpr int kWarpW = 8;                  // a warp's pixels: an 8 x 4 block of the tile
constexpr int kWarpH = 32 / kWarpW;
constexpr int kWarpCols = kTileW / kWarpW;
constexpr int kChunk = kThreads;           // faces box-tested per round: one per thread
constexpr int kPackThreads = 256;
constexpr int kCols = 12;       // floats per packed face: 11 rows + 1 pad
constexpr int kColsAttr = 24;   // + 9 attribute values + 3 pad
constexpr float kBig = 1e9f;
constexpr float kEdgeEps = -1e-5f;
constexpr float kMaxExtent = 1048576.f;  // 2^20 px
constexpr float kRounding = 3.814697265625e-6f;  // 2^-18: 64 x fp32's unit roundoff
constexpr float kEps = 3.0517578125e-5f;         // 2^-15 > 2e-5

// Face f of a ROI, vertex indices of type Idx (int32 or int64).
template <typename Idx>
__global__ void __launch_bounds__(kPackThreads)
pack_faces_kernel(const float* __restrict__ verts, const Idx* __restrict__ faces,
                  const float* __restrict__ rots, const float* __restrict__ transes,
                  const float* __restrict__ Ks, int V, int F, int H, int W, long long n,
                  int cols, float4* __restrict__ packed, int4* __restrict__ boxes) {
  const long long i = static_cast<long long>(blockIdx.x) * kPackThreads + threadIdx.x;
  if (i >= n) return;
  const long long b = i / F;
  const float* R = rots + 9 * b;
  const float* t = transes + 3 * b;
  const float* K = Ks + 9 * b;
  const float* vb = verts + b * V * 3;

  float x[3], y[3], z[3], iz[3], a[9];
  bool in_range = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const long long idx = static_cast<long long>(faces[3 * i + k]);
    const bool ok = idx >= 0 && idx < V;  // an out-of-range index makes the face invalid
    in_range = in_range && ok;
    const float v0 = ok ? vb[3 * idx] : 0.f;
    const float v1 = ok ? vb[3 * idx + 1] : 0.f;
    const float v2 = ok ? vb[3 * idx + 2] : 0.f;
    // R v + t, summed left to right as transform_verts does
    const float cx = ((R[0] * v0 + R[1] * v1) + R[2] * v2) + t[0];
    const float cy = ((R[3] * v0 + R[4] * v1) + R[5] * v2) + t[1];
    const float cz = ((R[6] * v0 + R[7] * v1) + R[8] * v2) + t[2];
    const float sz = fabsf(cz) < 1e-9f ? 1e-9f : cz;
    x[k] = ((K[0] * cx) / sz + K[2]) + (K[1] * cy) / sz;
    y[k] = (K[4] * cy) / sz + K[5];
    z[k] = cz;
    iz[k] = 1.f / sz;
    a[3 * k] = v0;
    a[3 * k + 1] = v1;
    a[3 * k + 2] = v2;
  }
  const float area = (x[1] - x[0]) * (y[2] - y[0]) - (x[2] - x[0]) * (y[1] - y[0]);
  const bool valid = in_range && fabsf(area) > 1e-12f && z[0] > 1e-6f && z[1] > 1e-6f &&
                     z[2] > 1e-6f;
  const float inv_area = valid ? 1.f / (fabsf(area) < 1e-12f ? 1.f : area) : 0.f;

  float4* out = packed + i * (cols / 4);
  out[0] = make_float4(x[0], y[0], x[1], y[1]);
  out[1] = make_float4(x[2], y[2], iz[0], iz[1]);
  out[2] = make_float4(iz[2], valid ? 1.f : 0.f, inv_area, 0.f);
  if (cols == kColsAttr) {
    out[3] = make_float4(a[0], a[1], a[2], a[3]);
    out[4] = make_float4(a[4], a[5], a[6], a[7]);
    out[5] = make_float4(a[8], 0.f, 0.f, 0.f);
  }

  // the screen box [x_lo, y_lo, x_hi, y_hi] of pixel centres, inclusive
  int4 box = make_int4(0, 0, -1, -1);  // empty: meets no tile
  if (valid) {
    const float xmin = fminf(fminf(x[0], x[1]), x[2]), xmax = fmaxf(fmaxf(x[0], x[1]), x[2]);
    const float ymin = fminf(fminf(y[0], y[1]), y[2]), ymax = fmaxf(fmaxf(y[0], y[1]), y[2]);
    const float bw = xmax - xmin, bh = ymax - ymin;
    bool finite = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) finite = finite && isfinite(x[k]) && isfinite(y[k]);
    // S, m, lam, Q and the three conditions as in face_screen_boxes, op for op
    const float S = bw + bh;
    const float m = 1.f + 1e-4f * S;
    const float lam = kRounding * fabsf(inv_area);
    const float Q = fmaxf(fmaxf(fmaxf(xmax, static_cast<float>(W - 1) - xmin), ymax),
                          static_cast<float>(H - 1) - ymin);
    const float sm = S + m, sq = S + Q;
    const bool conditioned = lam * (S * S) < 0.125f &&
                             m > 3.f * S * (lam * (sm * sm) + kEps) &&
                             Q > 3.f * S * (lam * (sq * sq) + kEps);
    if (!finite || !(bw <= kMaxExtent) || !(bh <= kMaxExtent) || !conditioned) {
      box = make_int4(0, 0, W - 1, H - 1);
    } else {
      const float lx = fminf(fmaxf(floorf(xmin - m), 0.f), static_cast<float>(W));
      const float hx = fminf(fmaxf(ceilf(xmax + m), -1.f), static_cast<float>(W - 1));
      const float ly = fminf(fmaxf(floorf(ymin - m), 0.f), static_cast<float>(H));
      const float hy = fminf(fmaxf(ceilf(ymax + m), -1.f), static_cast<float>(H - 1));
      if (lx <= hx && ly <= hy)
        box = make_int4(static_cast<int>(lx), static_cast<int>(ly), static_cast<int>(hx),
                        static_cast<int>(hy));
    }
  }
  boxes[i] = box;
}

template <bool kAttrs>
__global__ void __launch_bounds__(kThreads)
raster_kernel(const float4* __restrict__ packed, const int4* __restrict__ boxes, int F, int H,
              int W, int tiles_x, float* __restrict__ depth, float* __restrict__ xyz) {
  constexpr int kVec = (kAttrs ? kColsAttr : kCols) / 4;  // float4 per packed face
  // x0 y0 x1 y1 | x2 y2 iz0 iz1 | iz2 cols inv_area rows: cols and rows the
  // box's first and last column and row as two 16-bit halves
  __shared__ float4 faces_s[3 * kChunk];
  __shared__ int face_id[kAttrs ? kChunk : 1];
  __shared__ int warp_n[kWarps];

  const int b = blockIdx.y;
  const int tx0 = (blockIdx.x % tiles_x) * kTileW, ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int tx1 = min(tx0 + kTileW, W) - 1, ty1 = min(ty0 + kTileH, H) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wx0 = tx0 + (warp % kWarpCols) * kWarpW, wy0 = ty0 + (warp / kWarpCols) * kWarpH;
  const int wx1 = wx0 + kWarpW - 1, wy1 = wy0 + kWarpH - 1;  // the warp's pixels
  const int ix = wx0 + lane % kWarpW, iy = wy0 + lane / kWarpW;
  const bool active = ix < W && iy < H;  // the ragged edge is masked
  const float px = static_cast<float>(ix), py = static_cast<float>(iy);
  const float4* fb = packed + static_cast<long long>(b) * F * kVec;
  const int4* bb = boxes + static_cast<long long>(b) * F;

  float best_z = kBig;
  int best_f = 0;
  float best_w0 = 0.f, best_w1 = 0.f;

  // the next chunk's box is loaded while this chunk is rasterized
  const int4 empty = make_int4(0, 0, -1, -1);  // past the last face: meets no tile
  int4 bx_next = static_cast<int>(threadIdx.x) < F ? bb[threadIdx.x] : empty;
  for (int f0 = 0; f0 < F; f0 += kChunk) {
    const int f = f0 + threadIdx.x;
    const int4 bx = bx_next;
    bx_next = f + kChunk < F ? bb[f + kChunk] : empty;
    const bool keep = bx.x <= tx1 && bx.z >= tx0 && bx.y <= ty1 && bx.w >= ty0;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();  // counts visible; every thread is done with the last chunk's faces
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_n[w];
      base += w < warp ? c : 0;
      n += c;
    }
    if (keep) {  // survivors in face order: warp order, then lane order
      const int s = base + __popc(ballot & ((1u << lane) - 1u));
      const float4* src = fb + static_cast<long long>(f) * kVec;
      float4 d = src[2];
      d.y = __uint_as_float(static_cast<unsigned>(bx.x) << 16 | static_cast<unsigned>(bx.z));
      d.w = __uint_as_float(static_cast<unsigned>(bx.y) << 16 | static_cast<unsigned>(bx.w));
      if (kAttrs) face_id[s] = f;
      faces_s[3 * s] = src[0];
      faces_s[3 * s + 1] = src[1];
      faces_s[3 * s + 2] = d;
    }
    __syncthreads();  // survivors staged
    // each warp keeps the survivors whose box meets its 8 x 4 pixels, 32 at
    // a time (one ballot), and walks them in face order; every lane of the
    // warp takes part, those of the ragged edge compute and discard
    for (int j0 = 0; j0 < n; j0 += 32) {
      bool mine = false;
      if (j0 + lane < n) {
        const float4 d = faces_s[3 * (j0 + lane) + 2];
        const unsigned cols = __float_as_uint(d.y), rows = __float_as_uint(d.w);
        mine = static_cast<int>(cols >> 16) <= wx1 && static_cast<int>(cols & 0xffffu) >= wx0 &&
               static_cast<int>(rows >> 16) <= wy1 && static_cast<int>(rows & 0xffffu) >= wy0;
      }
      for (unsigned m = __ballot_sync(0xffffffffu, mine); m != 0; m &= m - 1) {
        const int j = j0 + __ffs(m) - 1;
        const float4 a = faces_s[3 * j];      // x0 y0 x1 y1
        const float4 c = faces_s[3 * j + 1];  // x2 y2 iz0 iz1
        const float4 d = faces_s[3 * j + 2];  // iz2 cols inv_area rows
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
            best_f = face_id[j];
            best_w0 = w0;
            best_w1 = w1;
          }
        } else {
          best_z = fminf(best_z, zp);
        }
      }
    }
  }
  if (!active) return;

  const long long o = (static_cast<long long>(b) * H + iy) * W + ix;
  const bool hit = best_z < kBig * 0.5f;
  depth[o] = hit ? best_z : 0.f;
  if (kAttrs) {
    float out[3] = {0.f, 0.f, 0.f};
    if (hit) {
      const float* fw = reinterpret_cast<const float*>(fb + static_cast<long long>(best_f) * kVec);
      const float w2 = 1.f - best_w0 - best_w1;
      const float iz0 = fw[6], iz1 = fw[7], iz2 = fw[8];
      const float iz = fmaxf(best_w0 * iz0 + best_w1 * iz1 + w2 * iz2, 1e-12f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float num = best_w0 * fw[12 + k] * iz0 + best_w1 * fw[15 + k] * iz1
                        + w2 * fw[18 + k] * iz2;
        out[k] = num / iz;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) xyz[3 * o + k] = out[k];
  }
}

}  // namespace

extern "C" {

// verts (B, V, 3), rots (B, 3, 3), transes (B, 3), Ks (B, 3, 3) float32; faces
// (B, F, 3) int32 (faces_int64 = 0) or int64; all contiguous. Writes packed
// (B, F, 12) float32, or (B, F, 24) with the attribute values when with_attrs
// is 1, and boxes (B, F, 4) int32 for an H x W image. Returns the cudaError_t
// of the launch (0 = success).
int gdrn_raster_pack(const void* verts, const void* faces, int faces_int64, const void* rots,
                     const void* transes, const void* Ks, int B, int V, int F, int H, int W,
                     int with_attrs, void* packed, void* boxes, void* stream) {
  if (B < 0 || V < 0 || F < 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(B) * F;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kPackThreads - 1) / kPackThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cols = with_attrs ? kColsAttr : kCols;
  const float* vp = static_cast<const float*>(verts);
  const float* rp = static_cast<const float*>(rots);
  const float* tp = static_cast<const float*>(transes);
  const float* kp = static_cast<const float*>(Ks);
  float4* pp = static_cast<float4*>(packed);
  int4* bp = static_cast<int4*>(boxes);
  if (faces_int64)
    pack_faces_kernel<long long><<<static_cast<unsigned>(blocks), kPackThreads, 0, s>>>(
        vp, static_cast<const long long*>(faces), rp, tp, kp, V, F, H, W, n, cols, pp, bp);
  else
    pack_faces_kernel<int><<<static_cast<unsigned>(blocks), kPackThreads, 0, s>>>(
        vp, static_cast<const int*>(faces), rp, tp, kp, V, F, H, W, n, cols, pp, bp);
  return static_cast<int>(cudaGetLastError());
}

// packed, boxes: gdrn_raster_pack's output for the same with_attrs, H and W.
// depth: (B, H, W) float32; xyz: (B, H, W, 3) float32, or null when with_attrs
// is 0. Returns the cudaError_t of the launch (0 = success).
int gdrn_raster_fwd(const void* packed, const void* boxes, int B, int F, int H, int W,
                    void* depth, void* xyz, int with_attrs, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65536 || W <= 0 || W > 65536 || F < 0 ||
      (with_attrs && xyz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);  // H, W: box bounds are kept in 16 bits
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const long long tiles = static_cast<long long>(tiles_x) * ((H + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* pp = static_cast<const float4*>(packed);
  const int4* bp = static_cast<const int4*>(boxes);
  float* dp = static_cast<float*>(depth);
  if (with_attrs)
    raster_kernel<true><<<grid, kThreads, 0, s>>>(pp, bp, F, H, W, tiles_x, dp,
                                                  static_cast<float*>(xyz));
  else
    raster_kernel<false><<<grid, kThreads, 0, s>>>(pp, bp, F, H, W, tiles_x, dp, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // the C interface
