// Furthest point sampling for Hopper (sm_90a), C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_fps_kernel` / `_fps_pallas` of
// rfdnet_tpu/ops/fps.py (:61-133), with its exact semantics: index 0
// first; with `skip` (the JAX package's `skip_near_origin`, on by
// default) points with |p|^2 <= 1e-3 are never selected, without it
// every point is a candidate; running min-distance starts at 1e10; each
// step takes the argmax, ties to the LOWEST index.
//
// What bounds it on this card: the loop. Each of the npoint-1 steps
// depends on the previous step's choice, so a scene is a chain of
// npoint-1 argmax reductions over the whole cloud; the arithmetic (10
// operations per point per step) and the bytes (the cloud is read once)
// are far below the card's rates. What a step costs is latency: the
// per-thread scan, the reductions, and the barriers between them.
//
// Two kernels, chosen per call by `fps_route` in ops/fps.py.
//
// `fps_resident` (the main path). As the TPU kernel keeps the cloud and
// the min distances in VMEM for the whole loop, this one keeps them on
// chip: every thread holds PPT points (x, y, z, min distance) in
// registers, dealt so that point i sits in CTA (i / T) % C, thread i % T,
// slot i / (C * T); C CTAs of T threads form one thread-block cluster per
// scene (C = 1: a plain CTA, no cluster instruction on its path). Global
// memory is read once at the start and written only with the output
// indices. A step is:
//   1. each thread updates its PPT min distances and keeps its best
//      (strict >, slots ascend in index, so the lowest index keeps a tie);
//   2. a warp argmax in two `redux.sync` instructions: the value goes
//      through an order-preserving float -> int map, `__reduce_max_sync`
//      finds the best key, `__reduce_min_sync` the lowest index holding it;
//   3. lane 0 of each warp writes (key, index) to a shared slot; one
//      `__syncthreads`;
//   4. C = 1: every warp reduces the warp slots redundantly and reads the
//      winner's coordinates from a copy of the CTA's points in shared
//      memory (slots double-buffered by step parity, so one barrier a step
//      is enough). C > 1: warp 0 reduces the warp slots, reads its CTA
//      winner's coordinates from that copy, and lanes 0..C-1 send (key,
//      index, x, y, z) into slot [parity][own rank] of every CTA of the
//      cluster (distributed shared memory). The send is `st.async`, which
//      counts its bytes on an mbarrier of the receiving CTA: every thread
//      waits on its own CTA's mbarrier until the C slots have landed, then
//      every warp reduces them redundantly and has the next centre
//      without a global load. This is the step's one cluster-wide
//      exchange: no `barrier.cluster` is on the step's path, only one
//      before the loop. Slots and mbarriers are double-buffered by step
//      parity: a CTA that runs ahead writes the other buffer, and cannot lap,
//      because its next wait needs every CTA's next message, which a CTA
//      sends only after all its warps have read the current slots.
// Padding slots (C * T * PPT > N) carry min distance -2 and index INT_MAX
// and lose to every real point, candidates or not (-1). With `kStub` the
// same kernel does steps 2-4 and no point work: its time per step is the
// latency floor of one dependent step on a given (C, T).
//
// `fps_streaming` (clouds above the resident capacity of 16 CTAs x 512
// threads x 24 points): one CTA of 1024 threads per scene, the cloud and
// the min distances in device memory (L2), re-read every step.
//
// Rounding: the distance is (dx*dx + dy*dy) + dz*dz with every product
// and sum rounded (__fmul_rn / __fadd_rn: no FMA contraction), the same
// operations as the plain torch version, so near-ties resolve alike.
// Non-candidates get min distance -1, which no distance (>= 0) lowers, so
// the stored min distance is the reference's `where(cand, mind, -1)`.
// `skip` is a kernel argument read once, where each point's min distance
// starts (1e10, or -1 for a non-candidate), before the step loop: the
// steps are the same instructions either way, and one instantiation
// serves both settings.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float dist2(float x, float y, float z, float cx,
                                       float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy),
              dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------- resident

// Order-preserving map of a non-NaN float onto a signed int, so that the
// integer `redux.sync` instructions can take a float argmax.
__device__ __forceinline__ int order_key(float v) {
  const int b = __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// Warp argmax of (key, idx), ties to the lowest idx; every lane gets it.
__device__ __forceinline__ void warp_argmax(int& key, int& idx) {
  const int m = __reduce_max_sync(kFullMask, key);
  idx = __reduce_min_sync(kFullMask, key == m ? idx : INT_MAX);
  key = m;
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Address of `local` (a shared-memory address of this CTA) in the shared
// memory of CTA `rank` of the cluster.
__device__ __forceinline__ unsigned map_to_rank(const void* local,
                                                unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_addr(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// 20 bytes (a, z) to `addr` in a peer's shared memory. The stores count
// their bytes on `bar`, an mbarrier of that peer, so the peer's wait on
// the mbarrier also makes the data visible.
__device__ __forceinline__ void store_remote_tx(unsigned addr, unsigned bar,
                                                int4 a, float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(bar)
      : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];"
      :: "r"(addr + 16), "r"(__float_as_int(z)), "r"(bar) : "memory");
}

constexpr unsigned kSlotBytes = 20;  // what one CTA sends to one peer a step

// One CTA's winner as its peers see it: 32 bytes, written as 16 + 4.
struct __align__(16) Slot {
  int key, idx;
  float x, y, z;
  int pad[3];
};

__host__ __device__ constexpr int log2_of(int v) {
  return v <= 1 ? 0 : 1 + log2_of(v / 2);
}

template <int T, int PPT, bool kCluster, bool kStub>
__global__ void __launch_bounds__(T, 1)
fps_resident(const float* __restrict__ xyz, int* __restrict__ out_g, int n,
             int npoint, int cshift, int skip) {
  constexpr int W = T / 32;
  constexpr int kTShift = log2_of(T);
  static_assert((1 << kTShift) == T, "T must be a power of two");
  extern __shared__ float s_pts[];  // x[T*PPT], y[T*PPT], z[T*PPT]
  float* const s_x = s_pts;
  float* const s_y = s_pts + T * PPT;
  float* const s_z = s_pts + 2 * T * PPT;
  __shared__ int s_wkey[2][W], s_widx[2][W];
  __shared__ Slot s_slot[2][kCluster ? kMaxCluster : 1];
  __shared__ unsigned long long s_bar[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int csize = 1 << cshift;
  const int rank = kCluster ? static_cast<int>(cluster_ctarank()) : 0;
  const int scene = blockIdx.x >> cshift;  // one cluster per scene
  const float* pts = xyz + static_cast<size_t>(scene) * n * 3;
  int* out = out_g + static_cast<size_t>(scene) * npoint;
  const int base = rank * T + tid;   // index of this thread's slot 0
  const int stride = T << cshift;    // index step from slot k to k + 1

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = base + k * stride;
    float x = 0.f, y = 0.f, z = 0.f, m = -2.0f;
    if (i < n) {
      x = __ldg(pts + 3 * i);
      y = __ldg(pts + 3 * i + 1);
      z = __ldg(pts + 3 * i + 2);
      m = !skip || dist2(x, y, z, 0.f, 0.f, 0.f) > 1e-3f ? 1e10f : -1.0f;
    }
    px[k] = x, py[k] = y, pz[k] = z, md[k] = m;
    s_x[k * T + tid] = x, s_y[k * T + tid] = y, s_z[k * T + tid] = z;
  }
  float cx = __ldg(pts), cy = __ldg(pts + 1), cz = __ldg(pts + 2);
  if (rank == 0 && tid == 0) out[0] = 0;
  if (kCluster && tid == 0) {
    // one arrival a phase: warp 0's, which also says how many bytes come
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster is running, its mbarriers initialised, before
  // any remote store
  if (kCluster) cluster_barrier();

  for (int step = 1; step < npoint; ++step) {
    const int p = step & 1;
    float best = -2.0f;
    int bk = -1;
    if (kStub) {  // depends on the centre, does no distance work
      best = __fadd_rn(md[0], __fmul_rn(cx, 0.f));
      bk = best > -2.0f ? 0 : -1;
    } else {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float m = fminf(md[k], dist2(px[k], py[k], pz[k], cx, cy, cz));
        md[k] = m;
        if (m > best) {  // strict: the first (lowest) index keeps a tie
          best = m;
          bk = k;
        }
      }
    }
    int key = order_key(best);
    int idx = bk >= 0 ? base + bk * stride : INT_MAX;
    warp_argmax(key, idx);
    if (lane == 0) {
      s_wkey[p][warp] = key;
      s_widx[p][warp] = idx;
    }
    __syncthreads();
    if (!kCluster) {
      key = lane < W ? s_wkey[p][lane] : INT_MIN;
      idx = lane < W ? s_widx[p][lane] : INT_MAX;
      warp_argmax(key, idx);
      // one CTA: point idx sits at idx of the shared copy
      cx = s_x[idx], cy = s_y[idx], cz = s_z[idx];
    } else {
      if (warp == 0) {
        key = lane < W ? s_wkey[p][lane] : INT_MIN;
        idx = lane < W ? s_widx[p][lane] : INT_MAX;
        warp_argmax(key, idx);
        float wx = 0.f, wy = 0.f, wz = 0.f;
        if (idx != INT_MAX) {  // a CTA of padding only has no winner
          const int at = ((idx >> (kTShift + cshift)) << kTShift)
                         | (idx & (T - 1));
          wx = s_x[at], wy = s_y[at], wz = s_z[at];
        }
        const int4 head = make_int4(key, idx, __float_as_int(wx),
                                    __float_as_int(wy));
        if (lane == 0)
          mbar_arrive_expect_tx(&s_bar[p], kSlotBytes << cshift);
        if (lane < csize)
          store_remote_tx(map_to_rank(&s_slot[p][rank], lane),
                          map_to_rank(&s_bar[p], lane), head, wz);
      }
      // mbarrier p is used every other step: its phases alternate
      mbar_wait(&s_bar[p], ((step - 1) >> 1) & 1);
      key = lane < csize ? s_slot[p][lane].key : INT_MIN;
      idx = lane < csize ? s_slot[p][lane].idx : INT_MAX;
      warp_argmax(key, idx);
      const Slot& win = s_slot[p][(idx >> kTShift) & (csize - 1)];
      cx = win.x, cy = win.y, cz = win.z;
    }
    if (rank == 0 && tid == 0) out[step] = idx;
  }
}

// The kernel's dynamic shared memory and, in a cluster, the non-portable
// cluster size, set at its first use on each device.
template <int T, int PPT, bool kCluster, bool kStub>
cudaError_t prepare_resident() {
  auto kernel = fps_resident<T, PPT, kCluster, kStub>;
  constexpr size_t smem = 3 * sizeof(float) * T * PPT;
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (kCluster) {  // a cluster of 16 is above the portable size of 8
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    ready[dev] = true;
  }
  return cudaSuccess;
}

// The launch configuration of b scenes, one cluster of 2^cshift CTAs each.
template <int T, int PPT, bool kCluster>
cudaLaunchConfig_t resident_config(int b, int cshift, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b) << cshift);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = 3 * sizeof(float) * T * PPT;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << cshift;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  return cfg;
}

template <int T, int PPT, bool kCluster, bool kStub>
cudaError_t launch_resident(const float* xyz, int* out, int b, int n,
                            int npoint, int cshift, int skip,
                            cudaStream_t stream) {
  cudaError_t err = prepare_resident<T, PPT, kCluster, kStub>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      resident_config<T, PPT, kCluster>(b, cshift, stream, attr);
  return cudaLaunchKernelEx(&cfg, fps_resident<T, PPT, kCluster, kStub>,
                            xyz, out, n, npoint, cshift, skip);
}

// How many clusters (CTAs without one) of the launch of b scenes the
// device runs at once: cudaOccupancyMaxActiveClusters, or the resident
// CTAs a multiprocessor holds times the multiprocessors.
template <int T, int PPT, bool kCluster, bool kStub>
cudaError_t active_clusters(int b, int cshift, int* count) {
  cudaError_t err = prepare_resident<T, PPT, kCluster, kStub>();
  if (err != cudaSuccess) return err;
  auto kernel = fps_resident<T, PPT, kCluster, kStub>;
  if (kCluster) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg =
        resident_config<T, PPT, kCluster>(b, cshift, nullptr, attr);
    return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, T, 3 * sizeof(float) * T * PPT);
  *count = per_sm * sms;
  return err;
}

// The instantiations that exist, each X(in a cluster, threads, points per
// thread, stub): one per launch shape that `fps_route` of ops/fps.py can
// choose (a cluster of 8 and one of 16 share theirs), and the stub of each
// (in a cluster, threads) among them. 512 threads leave each thread 128
// registers, of which 24 points take 96.
#define FPS_RESIDENT_SHAPES(X)                                          \
  X(false, 256, 2, false) X(false, 256, 4, false)                       \
  X(false, 256, 8, false) X(false, 256, 16, false)                      \
  X(true, 256, 4, false) X(true, 256, 8, false) X(true, 256, 16, false) \
  X(true, 512, 10, false) X(true, 512, 16, false)                       \
  X(true, 512, 20, false) X(true, 512, 24, false)                       \
  X(false, 256, 1, true) X(true, 256, 1, true) X(true, 512, 1, true)

// Further instantiations, in the same form, for a build that times launch
// shapes beside the chosen ones (tools/sweep_fps_routes.py defines it).
#ifndef FPS_EXTRA_SHAPES
#define FPS_EXTRA_SHAPES(X)
#endif

// --------------------------------------------------------------- streaming

constexpr int kStreamThreads = 1024;
constexpr int kStreamWarps = kStreamThreads / 32;

__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kStreamThreads)
fps_streaming(const float* __restrict__ xyz, float* __restrict__ mind_g,
              int* __restrict__ out_g, int n, int npoint, int skip) {
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  float* mind = mind_g + static_cast<size_t>(blockIdx.x) * n;
  int* out = out_g + static_cast<size_t>(blockIdx.x) * npoint;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float s_val[kStreamWarps];
  __shared__ int s_idx[kStreamWarps];
  __shared__ float s_last[3];

  for (int i = tid; i < n; i += kStreamThreads) {
    const float x = __ldg(pts + 3 * i), y = __ldg(pts + 3 * i + 1),
                z = __ldg(pts + 3 * i + 2);
    mind[i] = !skip || dist2(x, y, z, 0.f, 0.f, 0.f) > 1e-3f ? 1e10f
                                                             : -1.0f;
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
    for (int i = tid; i < n; i += kStreamThreads) {
      const float d = dist2(__ldg(pts + 3 * i), __ldg(pts + 3 * i + 1),
                            __ldg(pts + 3 * i + 2), lx, ly, lz);
      const float m = fminf(mind[i], d);
      mind[i] = m;
      if (m > best) {  // strict: the first (lowest) index keeps a tie
        best = m;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      better(best, bi, __shfl_xor_sync(kFullMask, best, off),
             __shfl_xor_sync(kFullMask, bi, off));
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
        better(v, vi, __shfl_xor_sync(kFullMask, v, off),
               __shfl_xor_sync(kFullMask, vi, off));
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

// The resident kernel. xyz (B, N, 3) f32 contiguous; out (B, npoint) int32.
// One cluster of `cluster` CTAs (1, 2, 4, 8 or 16) of `threads` threads
// per scene, `ppt` points a thread: cluster * threads * ppt >= n, and
// (cluster > 1, threads, ppt, stub) one of FPS_RESIDENT_SHAPES. With `stub`
// != 0 (ppt 1, any n) each step does its reductions, barriers and exchange
// and no point work: for timing the latency of a step, the indices mean
// nothing. `skip` != 0 leaves points with |p|^2 <= 1e-3 out of the
// candidates. Launches on `stream` and returns the first CUDA error.
extern "C" int rfd_fps_resident_launch(const float* xyz, int* out, int b,
                                       int n, int npoint, int cluster,
                                       int threads, int ppt, int stub,
                                       int skip, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int cshift = 0;
  while ((1 << cshift) < cluster) ++cshift;
  if ((1 << cshift) != cluster || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!stub && static_cast<long long>(cluster) * threads * ppt < n)
    return static_cast<int>(cudaErrorInvalidValue);
#define FPS_DISPATCH(C, T, P, S)                                            \
  if ((cluster > 1) == C && threads == T && ppt == P && (stub != 0) == S)   \
    return static_cast<int>(launch_resident<T, P, C, S>(                    \
        xyz, out, b, n, npoint, cshift, skip, stream));
  FPS_RESIDENT_SHAPES(FPS_DISPATCH)
  FPS_EXTRA_SHAPES(FPS_DISPATCH)
#undef FPS_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The clusters (CTAs, for cluster 1) of the resident launch of
// (cluster, threads, ppt, stub) for b scenes that the current device runs
// at once, in *count; returns the first CUDA error.
extern "C" int rfd_fps_active_clusters(int b, int cluster, int threads,
                                       int ppt, int stub, int* count) {
  int cshift = 0;
  while ((1 << cshift) < cluster) ++cshift;
  if (b <= 0 || (1 << cshift) != cluster || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
#define FPS_ACTIVE(C, T, P, S)                                              \
  if ((cluster > 1) == C && threads == T && ppt == P && (stub != 0) == S)   \
    return static_cast<int>(active_clusters<T, P, C, S>(b, cshift, count));
  FPS_RESIDENT_SHAPES(FPS_ACTIVE)
  FPS_EXTRA_SHAPES(FPS_ACTIVE)
#undef FPS_ACTIVE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The streaming kernel. xyz (B, N, 3) f32 contiguous; mind (B, N) f32
// scratch; out (B, npoint) int32; `skip` as for the resident kernel.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int rfd_fps_streaming_launch(const float* xyz, float* mind,
                                        int* out, int b, int n, int npoint,
                                        int skip, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || npoint <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fps_streaming<<<b, kStreamThreads, 0, stream>>>(xyz, mind, out, n, npoint,
                                                  skip);
  return static_cast<int>(cudaGetLastError());
}
