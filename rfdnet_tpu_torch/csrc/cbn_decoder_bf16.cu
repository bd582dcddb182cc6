// Fused conditional-batch-norm occupancy decoder, bf16 operands, on
// Hopper's tensor cores (sm_90a: wgmma, bulk copies through the TMA
// engine, mbarriers, setmaxnreg). C interface for ctypes.
//
// Replaces the Pallas TPU kernel `_make_kernel` / `fused_cbn_decode` of
// rfdnet_tpu/ops/cbn_decoder.py (:86-197) in its default mode,
// `mxu_dtype=bfloat16` (the f32 mode is csrc/cbn_decoder.cu). Per grid
// point (a row of h0, width 256), with per-proposal scale/shift tables
// sc/sh (11 rows used):
//   for i in 0..4:  t = relu(h*sc[2i] + sh[2i]);   t = t @ W0[i] + b0[i]
//                   t = relu(t*sc[2i+1] + sh[2i+1]); t = t @ W1[i] + b1[i]
//                   h = h + t
//   out = relu(h*sc[10] + sh[10]) . w_out + b_out
// It rounds to bf16 where `cbn_decode_plain(..., mxu_dtype=bfloat16)`
// does: h0, the carry h, the tables, the weights, each affine's product
// and then its sum, each matmul+bias result. Products accumulate in f32
// (in the tensor cores' order), the bias adds in f32, the output dot is
// f32. The affines run in bf16x2 arithmetic (`mul.rn` / `add.rn` /
// `max`), which rounds once where the plain version rounds an f32 result:
// a bf16 x bf16 product is exact in f32, and f32 carries more than the
// 2p + 2 bits that make a double rounding of a bf16 sum innocuous.
//
// What bounds it on this card: operations. A scene (64 proposals x 32^3
// points) is 2*64*32768*10*256^2 = 2.75 TFLOP: 2.78 ms at 989 TFLOP/s
// of bf16 tensor cores; its bf16 h0 is 1.07 GB, 0.32 ms at 3.35 TB/s.
//
// Design. A CTA takes 128 grid points of one proposal and has three
// warpgroups: a producer (one thread issues the copies; `setmaxnreg`
// gives its registers to the others) and two consumers of 64 rows each.
// - The ten 256x256 weight matrices reach the kernel as 40 K-slabs of
//   64 x 256 bf16, each already the shared-memory image that `wgmma`
//   reads B from (K-major, 128-byte swizzle; `ops.cbn_decoder.
//   bf16_weight_image` lays it out). So one `cp.async.bulk` a slab
//   moves it, completing on the stage's mbarrier; a ring of 4 slabs
//   (128 KB) behind full/empty mbarriers. The 1.25 MB image stays in L2.
// - A consumer issues `wgmma.mma_async` m64n256k16: its accumulator is
//   128 f32 registers a thread. The residual carry h stays in registers,
//   64 bf16x2 a thread in the accumulator's layout; the matmul operand t
//   lives in shared memory (32 KB a warpgroup) in the swizzled layout
//   that `wgmma` reads A from, written by the epilogue.
// - The epilogue works on the accumulator registers: + bias (f32), one
//   cvt to bf16x2, then the next affine + ReLU stored into t, or the
//   residual add into h. The output layer is an f32 dot of the final
//   affine + ReLU with w_out, reduced over the quad that holds a row.
// - The ragged last tile of a proposal reads rows past T as 0 and stores
//   none of them, so the wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 256;                   // hidden width
constexpr int kBlocks = 5;
constexpr int kMats = 2 * kBlocks;        // matrices, in order W0[0], W1[0], W0[1], ...
constexpr int kCbnPad = 16;               // rows of the scale/shift tables
constexpr int kCbnRows = 2 * kBlocks + 1;  // rows used
constexpr int kTm = 128;                  // grid points per CTA
constexpr int kWgRows = 64;               // rows per consumer warpgroup
constexpr int kSlabK = 64;                // K rows of a slab: one 128-byte swizzle atom
constexpr int kSlabsPerMat = kH / kSlabK;
constexpr int kSlabs = kMats * kSlabsPerMat;
constexpr int kStages = 4;
constexpr int kThreads = 384;
constexpr uint32_t kSlabBytes = kH * kSlabK * 2;       // 32 KB
constexpr uint32_t kAtomBytes = kWgRows * 128;         // 64 rows x 64 bf16 of t
constexpr uint32_t kTBytes = kWgRows * kH * 2;         // t of a warpgroup, 32 KB
constexpr uint32_t kTabWords = kCbnRows * kH / 2;      // one table in bf16x2
constexpr uint32_t kTabBytes = 2 * kTabWords * 4;      // sc and sh of a warpgroup
// shared memory, from a 1024-aligned base (the swizzle atoms need it)
constexpr uint32_t kOffT = 0;
constexpr uint32_t kOffW = kOffT + 2 * kTBytes;
constexpr uint32_t kOffTab = kOffW + kStages * kSlabBytes;
constexpr uint32_t kOffBar = kOffTab + 2 * kTabBytes;
constexpr uint32_t kSmemBytes = kOffBar + 2 * kStages * 8 + 1024;
static_assert(kStages == kSlabsPerMat, "slab s of every matrix uses stage s");
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a warpgroup's own barrier (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulator's registers are not read or written across this point
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A (64 x 16, descriptor a) @ B (16 x 256, descriptor b), f32 sums
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b, uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate)
      : "memory");
}

// two f32 -> bf16x2 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// relu(rnd(rnd(x * s) + b)) on two bf16 lanes; `.rn` keeps the multiply
// and the add apart (no contraction into one rounding)
__device__ __forceinline__ uint32_t affine_relu2(uint32_t x, uint32_t s, uint32_t b) {
  uint32_t y;
  asm("{\n.reg .b32 t;\n"
      "mul.rn.bf16x2 t, %1, %2;\n"
      "add.rn.bf16x2 t, t, %3;\n"
      "max.bf16x2 %0, t, %4;\n}\n"
      : "=r"(y)
      : "r"(x), "r"(s), "r"(b), "r"(0u));
  return y;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t y;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(y) : "r"(a), "r"(b));
  return y;
}

// the bf16x2 at row `row`, columns 8j + 2q, +1 of t (64 x 256): in
// 64-column atoms of 64 rows x 128 bytes, the 16-byte chunk (j & 7) of a
// row stored at chunk (j & 7) ^ (row & 7)
__device__ __forceinline__ void store_t(uint8_t* t, int row, int j, int q, uint32_t v) {
  const int off = (j >> 3) * kAtomBytes + row * 128 + (((j & 7) ^ (row & 7)) << 4) + q * 4;
  *reinterpret_cast<uint32_t*>(t + off) = v;
}

// t = relu(x * sc[row] + sh[row]) for this thread's values of x
__device__ __forceinline__ void affine_to_t(const uint32_t (&x)[64], const uint32_t* tab,
                                            int row, uint8_t* t, int r0, int q) {
  const uint32_t* sc = tab + row * (kH / 2) + q;
  const uint32_t* sh = tab + kTabWords + row * (kH / 2) + q;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t s = sc[4 * j], b = sh[4 * j];
    store_t(t, r0, j, q, affine_relu2(x[2 * j], s, b));
    store_t(t, r0 + 8, j, q, affine_relu2(x[2 * j + 1], s, b));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
cbn_decode_bf16_kernel(const __nv_bfloat16* __restrict__ h0,
                       const float* __restrict__ scales,
                       const float* __restrict__ shifts,
                       const uint8_t* __restrict__ w_image,
                       const float* __restrict__ b0s, const float* __restrict__ b1s,
                       const float* __restrict__ w_out, const float* __restrict__ b_out,
                       float* __restrict__ out, int T) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_full = base + kOffBar;
  const uint32_t bar_empty = bar_full + kStages * 8;
  const int tid = threadIdx.x, wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(bar_empty + 8 * s, 8);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int g = 0; g < kSlabs; ++g) {
        const int st = g % kStages;
        if (g >= kStages) mbar_wait(bar_empty + 8 * st, ((g / kStages) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * st, kSlabBytes);
        bulk_load(base + kOffW + st * kSlabBytes, w_image + static_cast<size_t>(g) * kSlabBytes,
                  kSlabBytes, bar_full + 8 * st);
      }
    }
    return;
  }

  // consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int c = wg - 1, ctid = tid & 127;
  const int warp = ctid >> 5, lane = tid & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
  const int p = blockIdx.y;
  const int row_a = blockIdx.x * kTm + c * kWgRows + r0, row_b = row_a + 8;
  uint8_t* t = smem + kOffT + c * kTBytes;
  const uint32_t t_addr = base + kOffT + c * kTBytes;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + kOffTab + c * kTabBytes);

  {  // this proposal's table rows 0-10, rounded to bf16
    const float2* sc = reinterpret_cast<const float2*>(scales + static_cast<size_t>(p) * kCbnPad * kH);
    const float2* sh = reinterpret_cast<const float2*>(shifts + static_cast<size_t>(p) * kCbnPad * kH);
    for (int i = ctid; i < static_cast<int>(kTabWords); i += 128) {
      const float2 a = __ldg(sc + i), b = __ldg(sh + i);
      tab[i] = pack_rn(a.x, a.y);
      tab[kTabWords + i] = pack_rn(b.x, b.y);
    }
  }

  // the carry h in the accumulator's layout: h[2j] holds row r0, h[2j+1]
  // row r0 + 8, columns 8j + 2q, +1
  uint32_t h[64];
  {
    const uint32_t* ha = reinterpret_cast<const uint32_t*>(
        h0 + (static_cast<size_t>(p) * T + row_a) * kH) + q;
    const uint32_t* hb = ha + 8 * (kH / 2);
    const bool va = row_a < T, vb = row_b < T;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      h[2 * j] = va ? __ldg(ha + 4 * j) : 0u;
      h[2 * j + 1] = vb ? __ldg(hb + 4 * j) : 0u;
    }
  }
  wg_sync(1 + c);  // the tables are in place
  affine_to_t(h, tab, 0, t, r0, q);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

  for (int m = 0; m < kMats; ++m) {
    // t written by the whole warpgroup, visible to the tensor cores
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + c);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSlabsPerMat; ++s) {
      mbar_wait(bar_full + 8 * s, m & 1);
      const uint32_t a_addr = t_addr + s * kAtomBytes;
      const uint32_t b_addr = base + kOffW + s * kSlabBytes;
#pragma unroll
      for (int k = 0; k < kSlabK / 16; ++k)
        wgmma_m64n256k16(acc, sw128_desc(a_addr + 32 * k), sw128_desc(b_addr + 32 * k),
                         (s | k) != 0);
      wgmma_commit();
      if (s > 0) {  // the previous slab's products are done: release it
        wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * (s - 1));
      }
    }
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (kSlabsPerMat - 1));
    fence_acc(acc);
    wg_sync(1 + c);  // every warp's products done before t is rewritten

    const int blk = m >> 1;
    const float2* bias =
        reinterpret_cast<const float2*>(((m & 1) ? b1s : b0s) + blk * kH) + q;
    if ((m & 1) == 0) {  // t = relu(rnd(acc + b0) * sc + sh), the block's second affine
      const uint32_t* sc = tab + (2 * blk + 1) * (kH / 2) + q;
      const uint32_t* sh = tab + kTabWords + (2 * blk + 1) * (kH / 2) + q;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 bb = __ldg(bias + 4 * j);
        const uint32_t s = sc[4 * j], b = sh[4 * j];
        store_t(t, r0, j, q,
                affine_relu2(pack_rn(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y), s, b));
        store_t(t, r0 + 8, j, q,
                affine_relu2(pack_rn(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y), s, b));
      }
    } else {  // h = rnd(h + rnd(acc + b1))
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float2 bb = __ldg(bias + 4 * j);
        h[2 * j] = add2(h[2 * j], pack_rn(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y));
        h[2 * j + 1] = add2(h[2 * j + 1], pack_rn(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y));
      }
      if (blk + 1 < kBlocks) affine_to_t(h, tab, 2 * blk + 2, t, r0, q);
    }
  }

  // out = relu(h * sc[10] + sh[10]) . w_out + b_out, in f32
  const uint32_t* sc = tab + 2 * kBlocks * (kH / 2) + q;
  const uint32_t* sh = tab + kTabWords + 2 * kBlocks * (kH / 2) + q;
  const float2* wo = reinterpret_cast<const float2*>(w_out) + q;
  float pa = 0.0f, pb = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const uint32_t s = sc[4 * j], b = sh[4 * j];
    const float2 w = __ldg(wo + 4 * j);
    const uint32_t fa = affine_relu2(h[2 * j], s, b), fb = affine_relu2(h[2 * j + 1], s, b);
    pa = fmaf(hi_f32(fa), w.y, fmaf(lo_f32(fa), w.x, pa));
    pb = fmaf(hi_f32(fb), w.y, fmaf(lo_f32(fb), w.x, pb));
  }
  pa += __shfl_xor_sync(0xffffffffu, pa, 1);
  pa += __shfl_xor_sync(0xffffffffu, pa, 2);
  pb += __shfl_xor_sync(0xffffffffu, pb, 1);
  pb += __shfl_xor_sync(0xffffffffu, pb, 2);
  if (q == 0) {
    const float bo = __ldg(b_out);
    float* o = out + static_cast<size_t>(p) * T;
    if (row_a < T) o[row_a] = pa + bo;
    if (row_b < T) o[row_b] = pb + bo;
  }
}

}  // namespace

// h0 (nb, t, 256) bf16; scales/shifts (nb, 16, 256) f32; w_image the 40
// slabs of `bf16_weight_image` (bf16, 1.25 MB, 16-byte aligned); b0s/b1s
// (5, 256), w_out (256,), b_out (1,) f32; out (nb, t) f32; all
// contiguous, any t >= 1. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int rfd_cbn_decode_bf16_launch(const void* h0, const float* scales,
                                          const float* shifts, const void* w_image,
                                          const float* b0s, const float* b1s,
                                          const float* w_out, const float* b_out,
                                          float* out, int nb, int t,
                                          cudaStream_t stream) {
  if (nb <= 0 || t <= 0 || nb > 65535 || (reinterpret_cast<uintptr_t>(w_image) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      cbn_decode_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kTm - 1) / kTm, nb);
  cbn_decode_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(h0), scales, shifts,
      static_cast<const uint8_t*>(w_image), b0s, b1s, w_out, b_out, out, t);
  return static_cast<int>(cudaGetLastError());
}
