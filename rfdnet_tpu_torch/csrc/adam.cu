// Multi-tensor Adam for Hopper (sm_90a), C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package's optimizer is optax's
// `add_decayed_weights` + `scale_by_adam` inside the jitted train step
// (rfdnet_tpu/train/trainer.py, `make_optimizer`), which XLA fuses into
// a few loops over the parameter tree. In eager PyTorch the same update,
// written a leaf at a time, is ~22 tensor ops a leaf (~6200 launches a
// stage-3 step of 284 leaves): the card then waits on the host's launches.
// This kernel is one launch a step for every leaf.
//
// Per element, for a leaf of spec s (f32 throughout, optax's order, as
// `adam_update_plain` in train/trainer.py writes it):
//   g += wd * p                      (only where wd != 0)
//   m  = (1 - b1) * g + b1 * m
//   v  = (1 - b2) * (g * g) + b2 * v
//   u  = (m / c1) / (sqrt(v / c2) + eps),  c1 = 1 - b1^t, c2 = 1 - b2^t
//   p += coef * u,                   coef = -lr * lr_scale
// The step's scalars (wd, 1 - b1, b1, 1 - b2, b2, c1, c2, eps, coef) come
// per spec from the host, computed once a step in f32. Every product, sum,
// quotient and root is one IEEE f32 operation rounded to nearest
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc may not contract a
// product and a sum into an FMA, so the kernel rounds where PyTorch's
// eager ops round, and the two agree bit for bit.
//
// The table (int64 words, built by the host every step and copied to the
// card in one copy):
//   leaves  n_leaves x 8: p, g, m, v (addresses), n, first chunk, spec, 0
//   specs   n_specs x 6:  12 f32, the scalars above and 3 pads
//   chunks  n_chunks int32: the leaf of each chunk
// A chunk is kChunk elements of one leaf, and one block updates one
// chunk, so a block finds its leaf with one load and no search.
//
// What bounds it on this card: bytes. Each element reads p, g, m, v and
// writes p, m, v: 28 bytes, ~426 MB a stage-3 step (15.2 M values), 0.127
// ms at 3.35 TB/s. Each thread moves 16-byte vectors where a leaf's four
// addresses allow it (PyTorch's allocations do), and the leaf's tail of
// fewer than 4 elements, or a leaf that is not aligned, one element at a
// time.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;  // elements a block: 8 vectors a thread

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  int64_t first_chunk;
  int64_t spec;
  int64_t pad;
};

struct Spec {
  float wd, one_minus_b1, b1, one_minus_b2, b2, c1, c2, eps, coef, pad[3];
};

static_assert(sizeof(Leaf) == 64, "a leaf is 8 words of the table");
static_assert(sizeof(Spec) == 48, "a spec is 6 words of the table");

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Spec& s) {
  if (s.wd != 0.0f) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  m = __fadd_rn(__fmul_rn(s.one_minus_b1, g), __fmul_rn(s.b1, m));
  v = __fadd_rn(__fmul_rn(s.one_minus_b2, __fmul_rn(g, g)),
                __fmul_rn(s.b2, v));
  const float u = __fdiv_rn(__fdiv_rn(m, s.c1),
                            __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.eps));
  p = __fadd_rn(p, __fmul_rn(s.coef, u));
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const Leaf* __restrict__ leaves, const Spec* __restrict__ specs,
            const int* __restrict__ chunk_leaf) {
  const Leaf leaf = leaves[chunk_leaf[blockIdx.x]];
  const Spec s = specs[leaf.spec];
  const int64_t begin = (blockIdx.x - leaf.first_chunk) * kChunk;
  const int64_t end = leaf.n < begin + kChunk ? leaf.n : begin + kChunk;
  float* __restrict__ P = leaf.p;
  const float* __restrict__ G = leaf.g;
  float* __restrict__ M = leaf.m;
  float* __restrict__ V = leaf.v;
  int64_t tail = begin;
  const uintptr_t any = reinterpret_cast<uintptr_t>(P)
      | reinterpret_cast<uintptr_t>(G) | reinterpret_cast<uintptr_t>(M)
      | reinterpret_cast<uintptr_t>(V);
  if ((any & 15) == 0) {  // begin is a multiple of 4 elements
    tail = begin + ((end - begin) & ~int64_t(3));
    for (int64_t i = begin + 4 * threadIdx.x; i < tail; i += 4 * kThreads) {
      float4 p = *reinterpret_cast<const float4*>(P + i);
      const float4 g = __ldg(reinterpret_cast<const float4*>(G + i));
      float4 m = *reinterpret_cast<const float4*>(M + i);
      float4 v = *reinterpret_cast<const float4*>(V + i);
      update(p.x, g.x, m.x, v.x, s);
      update(p.y, g.y, m.y, v.y, s);
      update(p.z, g.z, m.z, v.z, s);
      update(p.w, g.w, m.w, v.w, s);
      *reinterpret_cast<float4*>(P + i) = p;
      *reinterpret_cast<float4*>(M + i) = m;
      *reinterpret_cast<float4*>(V + i) = v;
    }
  }
  for (int64_t i = tail + threadIdx.x; i < end; i += kThreads) {
    float p = P[i], m = M[i], v = V[i];
    update(p, __ldg(G + i), m, v, s);
    P[i] = p;
    M[i] = m;
    V[i] = v;
  }
}

}  // namespace

// The number of elements a chunk holds: the host cuts each leaf into
// ceil(n / chunk) chunks.
extern "C" int rfd_adam_chunk() { return static_cast<int>(kChunk); }

// `table` is the device copy of the table above (its leaves, then specs,
// then chunks); every p, g, m, v is a distinct f32 buffer on the device.
// Launches one block a chunk on `stream` and returns cudaGetLastError().
extern "C" int rfd_adam_launch(const int64_t* table, int n_leaves,
                               int n_specs, int n_chunks,
                               cudaStream_t stream) {
  if (n_leaves < 0 || n_specs < 0 || n_chunks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_chunks == 0) return 0;
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  const Spec* specs = reinterpret_cast<const Spec*>(table + 8 * (int64_t)n_leaves);
  const int* chunk_leaf = reinterpret_cast<const int*>(
      table + 8 * (int64_t)n_leaves + 6 * (int64_t)n_specs);
  adam_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0, stream>>>(
      leaves, specs, chunk_leaf);
  return static_cast<int>(cudaGetLastError());
}
