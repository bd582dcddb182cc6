// Projective TSDF fusion for Hopper (sm_90a), C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package fuses the offline preparation's
// depth views on the host (`tsdf_fuse`, rfdnet_tpu/meshing/src/prep.cpp
// :355-396, OpenMP), where the upstream fused them in CUDA
// (`external/pyfusion`). Curless-Levoy averaging, the host's semantics
// exactly:
//   - voxel (i, j, k) of a res^3 grid over bbox [min, max] has its centre
//     at min + (i + 0.5) * (max - min) / res on each axis;
//   - views are visited in order; a view whose camera z is <= 1e-6 at the
//     centre is skipped;
//   - the pixel is (int)(f * x / z + cx), (int)(f * y / z + cy): both
//     divisions are done as written (a reciprocal would move pixels), and
//     the cast truncates toward zero, so u in (-1, 0) lands in column 0;
//   - a pixel outside the image or of depth <= 0 is skipped; sdf = (d -
//     z) / trunc is skipped below -1, clamped at 1 and averaged;
//   - a voxel that no view sees is +1; the output is f32 at
//     ((i * res + j) * res + k).
// Every product, sum and quotient is one IEEE double operation rounded to
// nearest (__dmul_rn, __dadd_rn, __dsub_rn, __ddiv_rn): no FMA
// contraction, the same operations as `tsdf_fuse_plain` in ops/fusion.py,
// so the two agree bit for bit.
//
// Design: one thread per voxel, k fastest, so that a warp's 32 voxels
// write one coalesced row and project to neighbouring pixels of each view
// (the depth gathers of a warp fall on a few cache lines). Each thread
// loops over the views in order, keeping the sum and count in registers.
//
// What bounds it on this card: the FP64 operations (~24 per voxel-view:
// the transform, the projection and its two divisions) over the card's
// FP64 rate; the bytes (the depth maps read once, the grid written once)
// are a small share. A division in FP64 is an iteration of several
// instructions, so the kernel runs well above the bound that counts it as
// one operation.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }

struct Box {
  double lo[3], hi[3];
};

__global__ void __launch_bounds__(kThreads)
tsdf_kernel(const float* __restrict__ depths, int n_views, int H, int W,
            const double* __restrict__ poses, double f, double cx, double cy,
            int res, Box box, double trunc, float* __restrict__ tsdf) {
  const int64_t voxel = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)res * res * res;
  if (voxel >= total) return;
  const int k = static_cast<int>(voxel % res);
  const int j = static_cast<int>((voxel / res) % res);
  const int i = static_cast<int>(voxel / ((int64_t)res * res));
  const double r = static_cast<double>(res);
  const double p0 = add(box.lo[0], mul(add(static_cast<double>(i), 0.5),
                                       dvd(sub(box.hi[0], box.lo[0]), r)));
  const double p1 = add(box.lo[1], mul(add(static_cast<double>(j), 0.5),
                                       dvd(sub(box.hi[1], box.lo[1]), r)));
  const double p2 = add(box.lo[2], mul(add(static_cast<double>(k), 0.5),
                                       dvd(sub(box.hi[2], box.lo[2]), r)));
  double acc = 0.0, wsum = 0.0;
  for (int v = 0; v < n_views; ++v) {
    const double* m = poses + 16 * v;
    const double czp = add(add(add(mul(__ldg(m + 8), p0), mul(__ldg(m + 9), p1)),
                               mul(__ldg(m + 10), p2)), __ldg(m + 11));
    if (czp <= 1e-6) continue;
    const double cxp = add(add(add(mul(__ldg(m + 0), p0), mul(__ldg(m + 1), p1)),
                               mul(__ldg(m + 2), p2)), __ldg(m + 3));
    const double cyp = add(add(add(mul(__ldg(m + 4), p0), mul(__ldg(m + 5), p1)),
                               mul(__ldg(m + 6), p2)), __ldg(m + 7));
    const int u = __double2int_rz(add(dvd(mul(f, cxp), czp), cx));
    const int w = __double2int_rz(add(dvd(mul(f, cyp), czp), cy));
    if (u < 0 || u >= W || w < 0 || w >= H) continue;
    const float d = __ldg(depths + ((int64_t)v * H + w) * W + u);
    if (d <= 0.0f) continue;
    const double sdf = dvd(sub(static_cast<double>(d), czp), trunc);
    if (sdf < -1.0) continue;
    acc = add(acc, fmin(sdf, 1.0));
    wsum = add(wsum, 1.0);
  }
  tsdf[voxel] = __double2float_rn(wsum > 0 ? dvd(acc, wsum) : 1.0);
}

}  // namespace

// depths (n_views, H, W) f32; poses (n_views, 4, 4) f64 row-major
// world->camera; tsdf (res, res, res) f32 out; all contiguous on the
// device. bbox is (min x, min y, min z, max x, max y, max z). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int rfd_tsdf_fuse_launch(const float* depths, int n_views, int H,
                                    int W, const double* poses, double f,
                                    double cx, double cy, int res, double x0,
                                    double y0, double z0, double x1,
                                    double y1, double z1, double trunc,
                                    float* tsdf, cudaStream_t stream) {
  if (n_views < 0 || H <= 0 || W <= 0 || res <= 0 || res > 2048)
    return static_cast<int>(cudaErrorInvalidValue);
  const Box box{{x0, y0, z0}, {x1, y1, z1}};
  const int64_t total = (int64_t)res * res * res;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  tsdf_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      depths, n_views, H, W, poses, f, cx, cy, res, box, trunc, tsdf);
  return static_cast<int>(cudaGetLastError());
}
