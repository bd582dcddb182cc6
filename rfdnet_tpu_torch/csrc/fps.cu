// Furthest point sampling for Hopper (sm_90a), C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fps_kernel` / `_fps_pallas` of
// rfdnet_tpu/ops/fps.py (:61-133), with its exact semantics: index 0
// first; points with |p|^2 <= 1e-3 never selected; running min-distance
// starts at 1e10; each step takes the argmax, ties to the LOWEST index.
//
// What bounds it on this card: the loop. Each of the npoint-1 steps
// depends on the previous step's choice, so a scene is a chain of
// npoint-1 block-wide argmax reductions; the arithmetic (9 flops per
// point per step) and the bytes (the cloud is read once) are far below
// the card's rates. At 80000 points the cloud (0.96 MB) and the min
// distances (0.32 MB) exceed one SM's shared memory, so they stay in
// device memory, where they sit in the 50 MB L2 (the read-only cloud
// also caches in L1 through __ldg).
//
// Design (the simple, right first version): one CTA of 1024 threads per
// scene. Each step, every thread updates its strided points' min
// distances and keeps its best (value, index); a warp-shuffle reduction
// and then one warp over the 32 warp winners pick the block's argmax,
// breaking ties by the lower index; thread 0 writes the index and
// publishes the chosen point through shared memory. B = 1 uses one SM of
// 132: a thread-block-cluster version with the cloud in registers and a
// distributed-shared-memory argmax is the later, faster design.
//
// Rounding: the distance is (dx*dx + dy*dy) + dz*dz with every product
// and sum rounded (__fmul_rn / __fadd_rn: no FMA contraction), the same
// operations as the plain torch version, so near-ties resolve alike.
// Non-candidates get min distance -1, which no distance (>= 0) lowers, so
// the stored min distance is the reference's `where(cand, mind, -1)`.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, float* __restrict__ mind_g,
           int* __restrict__ out_g, int n, int npoint) {
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* mind = mind_g + static_cast<size_t>(blockIdx.x) * n;
  int* out = out_g + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_last[3];

  for (int i = tid; i < n; i += kThreads) {
    const float x = __ldg(pts + 3 * i), y = __ldg(pts + 3 * i + 1),
                z = __ldg(pts + 3 * i + 2);
    const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                               __fmul_rn(z, z));
    mind[i] = n2 > 1e-3f ? 1e10f : -1.0f;
  }
  if (tid == 0) {
    out[0] = 0;
    s_last[0] = pts[0];
    s_last[1] = pts[1];
    s_last[2] = pts[2];
  }
  __syncthreads();

  for (int step = 1; step < npoint; ++step) {
    const float lx = s_last[0], ly = s_last[1], lz = s_last[2];
    float best = -2.0f;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float dx = __fsub_rn(__ldg(pts + 3 * i), lx);
      const float dy = __fsub_rn(__ldg(pts + 3 * i + 1), ly);
      const float dz = __fsub_rn(__ldg(pts + 3 * i + 2), lz);
      const float d = __fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > best) {  // strict: the first (lowest) index keeps a tie
        best = m;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      better(best, bi, __shfl_xor_sync(0xffffffffu, best, off),
             __shfl_xor_sync(0xffffffffu, bi, off));
    }
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      float v = s_val[lane];
      int vi = s_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        better(v, vi, __shfl_xor_sync(0xffffffffu, v, off),
               __shfl_xor_sync(0xffffffffu, vi, off));
      }
      if (lane == 0) {
        out[step] = vi;
        s_last[0] = pts[3 * vi];
        s_last[1] = pts[3 * vi + 1];
        s_last[2] = pts[3 * vi + 2];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// xyz (B, N, 3) f32 contiguous; mind (B, N) f32 scratch; out (B, npoint)
// int32. Launches on `stream` and returns cudaGetLastError().
extern "C" int rfd_fps_launch(const float* xyz, float* mind, int* out, int b,
                              int n, int npoint, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fps_kernel<<<b, kThreads, 0, stream>>>(xyz, mind, out, n, npoint);
  return static_cast<int>(cudaGetLastError());
}
