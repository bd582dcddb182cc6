// Pinhole z-buffer depth raster for Hopper (sm_90a), C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package renders the offline preparation's
// depth views on the host (`render_depth`, rfdnet_tpu/meshing/src/prep.cpp
// :310-353, one view a call, OpenMP-free), where the upstream rendered them
// with an offscreen GL context on the GPU. This kernel renders every view
// of a mesh in one launch and makes the host's choices:
//   - vertices go to camera space in double, each row of the row-major 4x4
//     world->camera pose as ((m0 x + m1 y) + m2 z) + m3;
//   - a triangle with any camera z <= 1e-6 is skipped, as is one whose
//     screen determinant has |det| < 1e-12; there is no back-face culling;
//   - its pixel box is floor(min) .. ceil(max) of the projected corners,
//     clipped to the image; pixel centres sit at +0.5;
//   - a pixel is covered when no barycentric weight is < 0, so a pixel on
//     a shared edge is covered by both triangles;
//   - depth is 1 / (w0 / za + w1 / zb + w2 / zc) in double, rounded once
//     to f32; the nearest depth wins, and 0 marks a pixel nothing covers.
// Every product, sum and quotient is one IEEE double operation rounded to
// nearest (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn): no FMA
// contraction, the same operations as `render_depth_plain` in
// ops/fusion.py, so the two agree bit for bit. The host library is built
// by g++, which contracts `a * b - c * d` into an FMA where the CPU has
// one: a weight there may differ in its last bit, which flips a pixel only
// where a weight is 0 to rounding (the tests bound the share).
//
// Design: one thread per (view, triangle) walks its clipped pixel box.
// A positive f32 keeps its order as an unsigned int, so the z-buffer is an
// `atomicMin` on the depth's bits into a buffer started at +inf; a last
// pass writes 0 where +inf is left.
//
// What bounds it on this card: the bytes of the depth maps it writes
// (views x H x W x 4; 164 MB at 100 x 640 x 640) over 3.35 TB/s, while
// the FP64 work per covered box pixel (~20 operations) is small beside
// the card's FP64 rate. A thread per triangle serialises a large
// triangle's box and leaves the card's atomics uncoalesced; binning
// triangles into screen tiles is later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kInfBits = 0x7f800000u;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

__global__ void fill_kernel(unsigned* buf, int64_t n, unsigned bits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    buf[i] = bits;
}

__device__ __forceinline__ void to_camera(const double* __restrict__ m,
                                          const double* __restrict__ p,
                                          double c[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
    c[r] = add(add(add(mul(__ldg(m + 4 * r), __ldg(p)),
                       mul(__ldg(m + 4 * r + 1), __ldg(p + 1))),
                   mul(__ldg(m + 4 * r + 2), __ldg(p + 2))),
               __ldg(m + 4 * r + 3));
}

__global__ void __launch_bounds__(kThreads)
raster_kernel(const double* __restrict__ verts, const int* __restrict__ tris,
              int nt, const double* __restrict__ poses, int n_views,
              double f, double cx, double cy, int W, int H,
              unsigned* __restrict__ depth) {
  const int64_t item = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (item >= (int64_t)n_views * nt) return;
  const int view = static_cast<int>(item / nt);
  const int t = static_cast<int>(item % nt);
  const double* m = poses + 16 * view;
  double a[3], b[3], c[3];
  to_camera(m, verts + 3 * __ldg(tris + 3 * t), a);
  to_camera(m, verts + 3 * __ldg(tris + 3 * t + 1), b);
  to_camera(m, verts + 3 * __ldg(tris + 3 * t + 2), c);
  if (a[2] <= 1e-6 || b[2] <= 1e-6 || c[2] <= 1e-6) return;
  const double ax = add(dvd(mul(f, a[0]), a[2]), cx);
  const double ay = add(dvd(mul(f, a[1]), a[2]), cy);
  const double bx = add(dvd(mul(f, b[0]), b[2]), cx);
  const double by = add(dvd(mul(f, b[1]), b[2]), cy);
  const double gx = add(dvd(mul(f, c[0]), c[2]), cx);
  const double gy = add(dvd(mul(f, c[1]), c[2]), cy);
  const int x0 = max(0, static_cast<int>(floor(fmin(ax, fmin(bx, gx)))));
  const int x1 = min(W - 1, static_cast<int>(ceil(fmax(ax, fmax(bx, gx)))));
  const int y0 = max(0, static_cast<int>(floor(fmin(ay, fmin(by, gy)))));
  const int y1 = min(H - 1, static_cast<int>(ceil(fmax(ay, fmax(by, gy)))));
  const double det = sub(mul(sub(bx, ax), sub(gy, ay)),
                         mul(sub(gx, ax), sub(by, ay)));
  if (fabs(det) < 1e-12) return;
  const double iza = dvd(1.0, a[2]), izb = dvd(1.0, b[2]),
               izc = dvd(1.0, c[2]);
  unsigned* img = depth + (int64_t)view * H * W;
  for (int y = y0; y <= y1; ++y) {
    const double py = add(static_cast<double>(y), 0.5);
    for (int x = x0; x <= x1; ++x) {
      const double px = add(static_cast<double>(x), 0.5);
      const double w1 = dvd(sub(mul(sub(px, ax), sub(gy, ay)),
                                mul(sub(gx, ax), sub(py, ay))), det);
      const double w2 = dvd(sub(mul(sub(bx, ax), sub(py, ay)),
                                mul(sub(px, ax), sub(by, ay))), det);
      const double w0 = sub(sub(1.0, w1), w2);
      if (w0 < 0 || w1 < 0 || w2 < 0) continue;
      const double iz = add(add(mul(w0, iza), mul(w1, izb)), mul(w2, izc));
      const float z = __double2float_rn(dvd(1.0, iz));
      atomicMin(img + (int64_t)y * W + x, __float_as_uint(z));
    }
  }
}

__global__ void finish_kernel(unsigned* buf, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    if (buf[i] == kInfBits) buf[i] = 0u;  // the bits of 0.0f
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 65536 ? b : 65536);
}

}  // namespace

// verts (nv, 3) f64; tris (nt, 3) int32, each index in [0, nv); poses
// (n_views, 4, 4) f64 row-major world->camera; depth (n_views, H, W) f32
// out; all contiguous on the device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rfd_render_depth_launch(const double* verts, const int* tris,
                                       int nt, const double* poses,
                                       int n_views, double f, double cx,
                                       double cy, int W, int H, float* depth,
                                       cudaStream_t stream) {
  if (nt < 0 || n_views <= 0 || W <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t pixels = (int64_t)n_views * H * W;
  unsigned* bits = reinterpret_cast<unsigned*>(depth);
  fill_kernel<<<blocks_for(pixels), kThreads, 0, stream>>>(bits, pixels,
                                                           kInfBits);
  const int64_t items = (int64_t)n_views * nt;
  if (items > 0) {
    const int64_t blocks = (items + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    raster_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        verts, tris, nt, poses, n_views, f, cx, cy, W, H, bits);
  }
  finish_kernel<<<blocks_for(pixels), kThreads, 0, stream>>>(bits, pixels);
  return static_cast<int>(cudaGetLastError());
}
