// Fused conditional-batch-norm occupancy decoder for Hopper (sm_90a), C
// interface for ctypes.
//
// Replaces the Pallas TPU kernel `_make_kernel` / `fused_cbn_decode` of
// rfdnet_tpu/ops/cbn_decoder.py (:86-197). Per grid point (a row of h0,
// width 256), with per-proposal scale/shift tables sc/sh (11 rows used):
//   for i in 0..4:  t = relu(h*sc[2i] + sh[2i]);   t = t @ W0[i] + b0[i]
//                   t = relu(t*sc[2i+1] + sh[2i+1]); t = t @ W1[i] + b1[i]
//                   h = h + t
//   out = relu(h*sc[10] + sh[10]) . w_out + b_out
// In the bf16 mode, h0, the carry h, the tables, the weights, each
// affine's product and its sum, and each matmul+bias result are rounded to
// bf16 (where the TPU kernel holds bf16 values); products accumulate in
// f32, the output dot is f32. The wrapper hands the weights over as their exact f32 widening.
//
// What bounds it on this card: operations. A scene (64 proposals x 32^3
// points) is 2*64*32768*10*256^2 = 2.75 TFLOP against 2.1 GB of h0 read
// once: ~41 ms at the 67 TFLOP/s of f32 outside the tensor cores, 2.8 ms
// at the 989 TFLOP/s of bf16 tensor cores, and 0.64 ms of memory traffic.
//
// Design (the simple, right first version, SIMT f32 FMAs): one CTA of
// 256 threads per (proposal, tile of 64 grid points), so a tile never
// straddles proposals. The tile's activations never leave the SM: the
// residual carry h lives in registers (each thread owns 8 rows x 8
// columns), the matmul operand t in shared memory (64 KB). The ten
// 256x256 weight matrices stream through shared memory as one sequence
// of 80 K-slabs of 32 rows, double-buffered with cp.async, so the next
// slab (also across matrix boundaries) loads while this one computes.
// The per-column tables, biases and w_out come from L2 through __ldg. The
// tensor-core (wgmma + TMA) version is the later, faster design.
//
// Rounding: each affine is a rounded multiply and a rounded add (no FMA
// contraction), each rounded on to bf16 in the bf16 mode, as in the plain
// torch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kH = 256;           // hidden width
constexpr int kBlocks = 5;
constexpr int kCbnPad = 16;       // rows of the scale/shift tables
constexpr int kTm = 64;           // grid points per CTA
constexpr int kKs = 32;           // K rows per weight slab
constexpr int kThreads = 256;     // 8 row groups x 32 column groups
constexpr int kSlabsPerMat = kH / kKs;
constexpr int kSlabs = 2 * kBlocks * kSlabsPerMat;
constexpr size_t kSmemBytes = sizeof(float) * (kTm * kH + 2 * kKs * kH);

template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <bool kBf16>
__device__ __forceinline__ float affine_relu(float x, float s, float b) {
  return fmaxf(rnd<kBf16>(__fadd_rn(rnd<kBf16>(__fmul_rn(x, s)), b)), 0.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The 8 values of a per-column vector this thread owns: columns
// tx*4 .. tx*4+3 and 128 + tx*4 .. 128 + tx*4+3.
__device__ __forceinline__ void load_cols(const float* v, int tx, float c[8]) {
  const float4 a = ld4(v + tx * 4), b = ld4(v + 128 + tx * 4);
  c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
  c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
}

// Copy weight slab g (matrix g / kSlabsPerMat, rows (g % kSlabsPerMat)*kKs
// onward) into shared buffer `dst`: 8192 floats, 8 x 16 B per thread.
__device__ __forceinline__ void issue_slab(int g, const float* w0s,
                                           const float* w1s, float* dst,
                                           int tid) {
  const int m = g / kSlabsPerMat, s = g % kSlabsPerMat;
  const float* src = ((m & 1) ? w1s : w0s) + static_cast<size_t>(m >> 1) * kH * kH +
                     static_cast<size_t>(s) * kKs * kH;
#pragma unroll
  for (int k = 0; k < kKs * kH / 4 / kThreads; ++k) {
    const int chunk = tid + k * kThreads;
    cp_async16(dst + chunk * 4, src + chunk * 4);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
cbn_decode_kernel(const float* __restrict__ h0, const float* __restrict__ scales,
                  const float* __restrict__ shifts, const float* __restrict__ w0s,
                  const float* __restrict__ b0s, const float* __restrict__ w1s,
                  const float* __restrict__ b1s, const float* __restrict__ w_out,
                  const float* __restrict__ b_out, float* __restrict__ out,
                  int t_pad) {
  extern __shared__ __align__(16) float smem[];
  float* s_t = smem;               // (kTm, kH) matmul operand
  float* s_w = smem + kTm * kH;    // 2 x (kKs, kH) weight slabs

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int p = blockIdx.y;
  const size_t row0 = static_cast<size_t>(p) * t_pad +
                      static_cast<size_t>(blockIdx.x) * kTm + ty * 8;
  const float* sc = scales + static_cast<size_t>(p) * kCbnPad * kH;
  const float* sh = shifts + static_cast<size_t>(p) * kCbnPad * kH;

  issue_slab(0, w0s, w1s, s_w, tid);
  cp_async_commit();

  // the residual carry: rows ty*8+i, this thread's 8 columns
  float h[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v[8];
    load_cols(h0 + (row0 + i) * kH, tx, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[i][j] = rnd<kBf16>(v[j]);
  }

  // s_t = relu(h * sc[row] + sh[row]) on this thread's elements
  auto write_affine = [&](const float (&x)[8][8], int row) {
    float s[8], b[8];
    load_cols(sc + row * kH, tx, s);
    load_cols(sh + row * kH, tx, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = rnd<kBf16>(s[j]);
      b[j] = rnd<kBf16>(b[j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = affine_relu<kBf16>(x[i][j], s[j], b[j]);
      float* dst = s_t + (ty * 8 + i) * kH + tx * 4;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 128) = make_float4(v[4], v[5], v[6], v[7]);
    }
  };

  write_affine(h, 0);

  float acc[8][8];
  for (int m = 0; m < 2 * kBlocks; ++m) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int s = 0; s < kSlabsPerMat; ++s) {
      const int g = m * kSlabsPerMat + s;
      cp_async_wait_all();
      __syncthreads();  // slab g landed everywhere; s_t written; buffer g+1 free
      if (g + 1 < kSlabs) issue_slab(g + 1, w0s, w1s, s_w + ((g + 1) & 1) * kKs * kH, tid);
      cp_async_commit();
      const float* wb = s_w + (g & 1) * kKs * kH;
      const float* at = s_t + (ty * 8) * kH + s * kKs;
#pragma unroll
      for (int kk = 0; kk < kKs; kk += 4) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(at + i * kH + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b0 = *reinterpret_cast<const float4*>(wb + (kk + q) * kH + tx * 4);
          const float4 b1 = *reinterpret_cast<const float4*>(wb + (kk + q) * kH + 128 + tx * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = reinterpret_cast<const float*>(&a[i])[q];
            acc[i][0] = fmaf(av, b0.x, acc[i][0]);
            acc[i][1] = fmaf(av, b0.y, acc[i][1]);
            acc[i][2] = fmaf(av, b0.z, acc[i][2]);
            acc[i][3] = fmaf(av, b0.w, acc[i][3]);
            acc[i][4] = fmaf(av, b1.x, acc[i][4]);
            acc[i][5] = fmaf(av, b1.y, acc[i][5]);
            acc[i][6] = fmaf(av, b1.z, acc[i][6]);
            acc[i][7] = fmaf(av, b1.w, acc[i][7]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done reading s_t

    const int blk = m >> 1;
    float bias[8];
    load_cols(((m & 1) ? b1s : b0s) + blk * kH, tx, bias);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = rnd<kBf16>(__fadd_rn(acc[i][j], bias[j]));

    if ((m & 1) == 0) {
      write_affine(acc, 2 * blk + 1);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) h[i][j] = rnd<kBf16>(__fadd_rn(h[i][j], acc[i][j]));
      if (blk + 1 < kBlocks) {
        write_affine(h, 2 * blk + 2);
      } else {
        float s[8], b[8], w[8];
        load_cols(sc + 2 * kBlocks * kH, tx, s);
        load_cols(sh + 2 * kBlocks * kH, tx, b);
        load_cols(w_out, tx, w);
        const float bo = __ldg(b_out);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float part = 0.0f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part = fmaf(affine_relu<kBf16>(h[i][j], rnd<kBf16>(s[j]), rnd<kBf16>(b[j])),
                        w[j], part);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (tx == 0) out[row0 + i] = part + bo;
        }
      }
    }
  }
}

}  // namespace

// h0 (nb, t_pad, 256); scales/shifts (nb, 16, 256); w0s/w1s (5, 256, 256)
// (in, out); b0s/b1s (5, 256); w_out (256,); b_out (1,); out (nb, t_pad);
// all f32 contiguous, t_pad a multiple of 64. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int rfd_cbn_decode_launch(const float* h0, const float* scales,
                                     const float* shifts, const float* w0s,
                                     const float* b0s, const float* w1s,
                                     const float* b1s, const float* w_out,
                                     const float* b_out, float* out, int nb,
                                     int t_pad, int bf16, cudaStream_t stream) {
  if (nb <= 0 || t_pad <= 0 || t_pad % kTm != 0 || nb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(t_pad / kTm, nb);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(cbn_decode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cbn_decode_kernel<true><<<grid, kThreads, kSmemBytes, stream>>>(
        h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out, out, t_pad);
  } else {
    err = cudaFuncSetAttribute(cbn_decode_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cbn_decode_kernel<false><<<grid, kThreads, kSmemBytes, stream>>>(
        h0, scales, shifts, w0s, b0s, w1s, b1s, w_out, b_out, out, t_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
