// Modulated deformable convolution (DCNv2) forward in 16-bit types: the
// sampling fused with its kernel product on the tensor cores (wgmma).
//
// Replaces salience_detr_tpu/models/bricks/deform_conv.py::_bilinear_sample_map
// times the mask (:92-95) and the einsum with the (9 * Cin, F) kernel
// (:102-105), in bf16 or f16.
//
// Semantics (deform_conv2d_plain in ops/deform_conv.py is the spec):
// out[b, ho, wo, f] = sum over k (9 taps) and c (Cin) of cols[b, ho, wo, k, c]
// * W[k * Cin + c, f], where cols are the values deform_conv_forward
// (deform_conv.cu) writes: the f32 corner sum in the plain order without
// fused multiply-adds, times the mask, rounded once to T.  The products and
// their sums run on the tensor cores (wgmma m64nNk16, T x T -> f32); the f32
// sum is rounded once to T.  Only the order of that sum differs from the
// plain version's matmul.
//
// What bounds it on an H100: its operations, 2 * M * K * N = 19.8 GFLOP at
// every R50-DCN layer (M = B * Ho * Wo, K = 9 * Cin, N = F), 0.020 ms at
// 989 TFLOP/s of bf16 tensor-core rate, against 17-69 MB of x, offsets,
// mask, W and out (0.005-0.021 ms at 3.35 TB/s).  The columns (155 MB at
// stage 2) are never written.  What it cannot avoid is the gather: every
// pixel's 9 taps read 4 corner rows of Cin channels, 36 * Cin * 2 bytes a
// pixel (619 MB at stage 2), and every tile reads W's rows again, from L2;
// that traffic, not the tensor cores, sets its time.  The design keeps
// the gather streaming and lets the products wait on nothing else:
//
//   * warp specialisation: a block of four warpgroups; two producers load
//     and sum, two consumers only issue wgmma.  A ring of kStages stages in
//     shared memory passes the A and B tiles between them, each stage with
//     two mbarriers (full: one producer warpgroup's 128 arrivals; empty:
//     the consumers' 256), so no block-wide barrier stands in any step;
//   * a step is one tap's kBK = 32 channels, the taps inner: consecutive
//     steps read the corner rows that neighbouring taps share, from L1
//     while they are still there.  The producer warpgroups take
//     alternate steps: each loads its step's corner chunks (16 bytes each;
//     a warp's load of one corner reads 8 pixels' 64 contiguous bytes) and
//     its share of W's 32 rows into registers, then waits for its stage,
//     sums each pixel's corners in the plain order times the mask into the
//     A tile, stores W's chunks beside it, fences both for the tensor cores
//     (fence.proxy.async) and arrives on the stage's full barrier.  The
//     loads go through registers: a 16-byte cp.async a thread issues at
//     about one copy a cycle an SM, a third of the L2 rate here, and a
//     bulk copy writes rows unswizzled, which no descriptor of this tile
//     reads;
//   * the taps' corner rows, weights and masks of the tile's pixels are
//     computed once into shared memory, before the ring starts;
//   * A (kBM pixels x 32 channels) is K-major with the 64-byte swizzle,
//     W's tile (32 rows x kBN columns of the row-major (9 Cin, F) matrix)
//     N-major with the 128-byte swizzle, each 16-byte chunk stored where
//     wgmma's descriptors read it;
//   * each consumer warpgroup waits on a stage's full barrier, issues two
//     wgmma m64n128k16 from the descriptors, keeps one group in flight and
//     frees the stage before it on that stage's empty barrier;
//   * two stages: the shared memory the ring does not take stays L1, which
//     serves the corner rows that neighbouring pixels and taps share;
//   * the tile: 128 pixels x 128 columns up to F = 128 (each consumer 64
//     rows), else 64 pixels x 256 columns (each consumer 128 columns of the
//     same A tile), F / 256 column tiles each sampling the pixels again:
//     one 512-column tile of 64 pixels would leave half the SMs idle at
//     stage 4 (66 tiles);
//   * the epilogue rounds the f32 sums to T once and stores (B, Ho, Wo, F)
//     channels-last through shared memory, 16 bytes a thread; rows past M
//     and columns past F are sampled as zero and not stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "msda_common.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kBK = 32;              // channels a step (one tap's)
constexpr int kChunks = kBK / 8;     // 16-byte chunks of a pixel's step
constexpr int kWgN = 128;            // a consumer warpgroup's columns (its wgmma's N)
constexpr int kGroupThreads = 128;   // a warpgroup
constexpr int kThreads = 4 * kGroupThreads;  // two producer, two consumer warpgroups
constexpr int kStages = 2;
constexpr int kTapWords = 9;         // a pixel's tap: 4 corner rows, 4 weights, the mask

// One tile configuration: kBM pixels (128: each consumer 64 rows, F <=
// 128; 64: both consumers the same rows, 128 columns each, F > 128) and
// kBN columns, the stages' A and B tiles, the taps' table.
template <int BM>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kMGroups = BM / 64;          // consumers along the rows
  static constexpr int kBN = kWgN * (2 / kMGroups);  // the tile's columns
  static constexpr int kABytes = BM * kBK * 2;       // BM rows of 64 bytes
  static constexpr int kBBytes = kBK * kBN * 2;      // kBN / 64 blocks of 32 rows x 128 bytes
  static constexpr int kStageBytes = kABytes + kBBytes;  // a multiple of 1024
  static constexpr int kTapBytes = kTaps * BM * kTapWords * 4;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + kTapBytes + 2 * 8 * kStages;
  static_assert(BM * (kBN + 8) * 2 <= kStages * kStageBytes + kTapBytes,
                "the epilogue's tile fits the ring and the taps' table");
  static constexpr int kPixels = BM * kChunks / kGroupThreads;      // pixels a producer thread sums
  static constexpr int kWChunks = kBK * kBN / 8 / kGroupThreads;    // W chunks a producer thread copies
  static_assert(kStageBytes % 1024 == 0, "1024-byte aligned stages");
};

template <typename T, int N>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};


template <>
struct Wgmma<__half, 128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};


__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes of global memory (zeros when !valid: nothing is read then)
__device__ __forceinline__ uint4 load16(const void* src, bool valid) {
  return valid ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// a wait that never ends (a lost arrival) traps after 10 s rather than
// hanging the card
__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned phase) {
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  uint64_t start = 0;
  for (int tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(phase)
        : "memory");
    if (done) return;
    if (tries == 64) start = global_ns();
    if (tries > 64 && (tries & 1023) == 0 && global_ns() - start > 10000000000ull) __trap();
  }
}

// wgmma's shared-memory matrix descriptor: the start address, the leading
// and stride byte offsets (16-byte units) and the swizzle
constexpr int kSwizzle128 = 1, kSwizzle64 = 2;

__device__ __forceinline__ uint64_t smem_desc(const void* p, int lbo, int sbo, int swizzle) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(swizzle) << 62);
}

// the accumulators stay in their registers across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A: pixel row r (64 bytes: the step's 32 channels) of a corner plane,
// chunk q (8 channels) at chunk q ^ ((r >> 1) & 3): the 64-byte swizzle of
// a K-major wgmma operand (8 rows of 64 bytes an atom)
__device__ __forceinline__ int a_offset(int r, int q) { return r * 64 + ((q ^ ((r >> 1) & 3)) << 4); }

// B: W's row k (of the step's 32) and column chunk n8 (8 columns): blocks
// of 64 columns, each 32 rows of 128 bytes, chunk j of a row at j ^ (k &
// 7): the 128-byte swizzle of an N-major wgmma operand
__device__ __forceinline__ int b_offset(int k, int n8) {
  return (n8 >> 3) * (kBK * 128) + k * 128 + (((n8 & 7) ^ (k & 7)) << 4);
}

// One producer thread's pixel at one tap: its four corners' rows (-1
// outside the image) and weights, and the mask.  The arithmetic is
// deform_conv_forward_kernel's, operation for operation.
struct TapSample {
  int row[4];
  float w[4], m;
};

__device__ __forceinline__ TapSample sample_tap(const float* __restrict__ offsets, const float* __restrict__ mask,
                                                int pix, int b, int ho, int wo, int k, int H, int W, int stride) {
  TapSample t;
  if (pix < 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      t.row[c] = -1;
      t.w[c] = 0.f;
    }
    t.m = 0.f;
    return t;
  }
  const float2 off = __ldg(reinterpret_cast<const float2*>(offsets) + static_cast<int64_t>(pix) * kTaps + k);
  t.m = __ldg(mask + static_cast<int64_t>(pix) * kTaps + k);
  const float py = __fadd_rn(static_cast<float>(ho * stride + k / 3 - 1), off.x);
  const float px = __fadd_rn(static_cast<float>(wo * stride + k % 3 - 1), off.y);
  const float y = fminf(fmaxf(py, -2.f), H + 1.f);
  const float xf = fminf(fmaxf(px, -2.f), W + 1.f);
  const float y0f = floorf(y), x0f = floorf(xf);
  const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
  const float fy = __fsub_rn(y, y0f), fx = __fsub_rn(xf, x0f);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int cy = y0 + dy;
    const float wy = dy ? fy : __fsub_rn(1.f, fy);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int cx = x0 + dx;
      const int c = 2 * dy + dx;
      const bool valid = cy >= 0 && cy < H && cx >= 0 && cx < W;
      t.w[c] = __fmul_rn(dx ? fx : __fsub_rn(1.f, fx), wy);
      t.row[c] = valid ? (b * H + cy) * W + cx : -1;
    }
  }
  return t;
}

// The corner sum of one 8-channel chunk in the plain order (a corner
// outside the image was loaded as zeros: w * 0 adds +0, which changes no
// sum), times the mask, rounded to T.
template <typename T>
__device__ __forceinline__ uint4 sum_corners(const uint4 (&v)[4], const float4 w, float m) {
  const float wc[4] = {w.x, w.y, w.z, w.w};
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const T* e = reinterpret_cast<const T*>(&v[c]);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wc[c], to_float(e[i])));
  }
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = from_float<T>(__fmul_rn(acc[i], m));
  return packed;
}

template <typename T, typename Tl>
__global__ void __launch_bounds__(kThreads, 1)
deform_conv_fused_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                         const float* __restrict__ mask, const T* __restrict__ w,
                         T* __restrict__ out, int B, int H, int W, int C, int F, int Ho, int Wo,
                         int stride) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzles are of the address's bits: 1024-byte aligned stages
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int4* tap_rows = reinterpret_cast<int4*>(smem + kStages * Tl::kStageBytes);  // [tap][pixel]
  float4* tap_w = reinterpret_cast<float4*>(tap_rows + kTaps * Tl::kBM);
  float* tap_m = reinterpret_cast<float*>(tap_w + kTaps * Tl::kBM);
  uint64_t* full = reinterpret_cast<uint64_t*>(tap_m + kTaps * Tl::kBM);
  uint64_t* empty = full + kStages;
  const int M = B * Ho * Wo;
  const int m0 = blockIdx.y * Tl::kBM, n0 = blockIdx.x * Tl::kBN;
  const int per_tap = C / kBK;
  const int steps = kTaps * per_tap;
  const int group = threadIdx.x / kGroupThreads, gt = threadIdx.x % kGroupThreads;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      barrier_init(full + s, kGroupThreads);
      barrier_init(empty + s, 2 * kGroupThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  {
    // the taps of the tile's pixels, once: corner rows, weights, mask
    for (int i = threadIdx.x; i < kTaps * Tl::kBM; i += kThreads) {
      const int k = i / Tl::kBM, at = m0 + i % Tl::kBM;
      const TapSample t =
          sample_tap(offsets, mask, at < M ? at : -1, at / (Wo * Ho), at / Wo % Ho, at % Wo, k, H, W, stride);
      tap_rows[i] = make_int4(t.row[0], t.row[1], t.row[2], t.row[3]);
      tap_w[i] = make_float4(t.w[0], t.w[1], t.w[2], t.w[3]);
      tap_m[i] = t.m;
    }
  }
  __syncthreads();

  if (group < 2) {
    // the producers: warpgroup g fills steps g, g + 2, ...; thread t loads
    // chunk t % 4 of pixels t / 4 + 32 j (a warp's load of one corner reads
    // 8 pixels' 64 contiguous bytes) and its share of W's tile into
    // registers, all before it waits for the stage to be free, then sums
    // the corners into the A tile and stores W's chunks where wgmma reads
    // them, fences them for the tensor cores and arrives on the stage's
    // full barrier.  Two warpgroups keep two steps' loads in flight.
    const int q = gt % kChunks;
    for (int s = group; s < steps; s += 2) {
      const int k = s % kTaps, c_base = s / kTaps * kBK;
      uint4 v[Tl::kPixels][4];
#pragma unroll
      for (int j = 0; j < Tl::kPixels; ++j) {
        const int4 r = tap_rows[k * Tl::kBM + gt / kChunks + 32 * j];
        const int rows[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[j][c] = load16(x + (rows[c] >= 0 ? static_cast<int64_t>(rows[c]) * C + c_base + q * 8 : 0), rows[c] >= 0);
        }
      }
      uint4 wv[Tl::kWChunks];
      const int64_t k0 = static_cast<int64_t>(k) * C + c_base;
#pragma unroll
      for (int i = 0; i < Tl::kWChunks; ++i) {
        const int idx = gt + i * kGroupThreads;
        const int kr = idx / (Tl::kBN / 8), col = n0 + idx % (Tl::kBN / 8) * 8;
        wv[i] = load16(w + (col < F ? (k0 + kr) * F + col : 0), col < F);
      }
      barrier_wait(empty + s % kStages, ((s / kStages) & 1) ^ 1);
      unsigned char* stage = smem + (s % kStages) * Tl::kStageBytes;
#pragma unroll
      for (int j = 0; j < Tl::kPixels; ++j) {
        const int pixel = gt / kChunks + 32 * j;
        *reinterpret_cast<uint4*>(stage + a_offset(pixel, q)) =
            sum_corners<T>(v[j], tap_w[k * Tl::kBM + pixel], tap_m[k * Tl::kBM + pixel]);
      }
#pragma unroll
      for (int i = 0; i < Tl::kWChunks; ++i) {
        const int idx = gt + i * kGroupThreads;
        *reinterpret_cast<uint4*>(stage + Tl::kABytes + b_offset(idx / (Tl::kBN / 8), idx % (Tl::kBN / 8))) = wv[i];
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // A and B, for the tensor cores
      barrier_arrive(full + s % kStages);
    }
  } else {
    // the consumers: warpgroup g multiplies its 64 rows and kWgN columns of
    // the tile, one step a wgmma group, one group in flight
    const int g = group - 2;
    const int warp = gt / 32, lane = gt % 32;
    const int row0 = (g % Tl::kMGroups) * 64, col0 = (g / Tl::kMGroups) * kWgN;
    float acc[kWgN / 2];
#pragma unroll
    for (int i = 0; i < kWgN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      barrier_wait(full + s % kStages, (s / kStages) & 1);
      const unsigned char* stage = smem + (s % kStages) * Tl::kStageBytes;
      hold(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = smem_desc(stage + row0 * 64 + kk * 32, 16, 8 * 64, kSwizzle64);
        const uint64_t db = smem_desc(stage + Tl::kABytes + (col0 / 64) * (kBK * 128) + kk * 16 * 128,
                                      kBK * 128, 8 * 128, kSwizzle128);
        Wgmma<T, kWgN>::run(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      hold(acc);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");  // step s - 1's products are done
      hold(acc);
      if (s > 0) barrier_arrive(empty + (s - 1) % kStages);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    hold(acc);
    // the epilogue: the sums rounded to T go through shared memory (the
    // ring and the taps' table are free once both consumers are here), rows
    // of kBN + 8 elements so that a warp's fragment stores hit 32 banks,
    // then out in 16-byte chunks, a row's chunks by consecutive threads.
    // The accumulators of m64nNk16: warp w's rows 16 w + lane / 4 (+ 8),
    // columns 8 j + 2 (lane % 4) (+ 1).
    constexpr int kRow = Tl::kBN + 8;
    T* tile = reinterpret_cast<T*>(smem);
    asm volatile("bar.sync 1, %0;" ::"n"(2 * kGroupThreads) : "memory");
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + warp * 16 + half * 8 + lane / 4, c = col0 + j * 8 + (lane % 4) * 2;
        const T pair[2] = {from_float<T>(acc[4 * j + 2 * half]), from_float<T>(acc[4 * j + 2 * half + 1])};
        unsigned bits;
        memcpy(&bits, pair, sizeof(bits));
        *reinterpret_cast<unsigned*>(tile + r * kRow + c) = bits;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(2 * kGroupThreads) : "memory");
    const int cg = (threadIdx.x - 2 * kGroupThreads);
    for (int i = cg; i < Tl::kBM * (Tl::kBN / 8); i += 2 * kGroupThreads) {
      const int r = i / (Tl::kBN / 8), c = i % (Tl::kBN / 8) * 8;
      if (m0 + r < M && n0 + c < F) {
        *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m0 + r) * F + n0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * kRow + c);
      }
    }
  }
}

template <typename T, typename Tl>
int launch_tile(const void* x, const float* offsets, const float* mask, const void* w, void* out, int B, int H,
                int W, int C, int F, int Ho, int Wo, int stride, cudaStream_t s) {
  const int M = B * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((F + Tl::kBN - 1) / Tl::kBN),
                  static_cast<unsigned>((M + Tl::kBM - 1) / Tl::kBM));
  const int err = static_cast<int>(cudaFuncSetAttribute(deform_conv_fused_kernel<T, Tl>,
                                                        cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kSmem));
  if (err != 0) return err;
  deform_conv_fused_kernel<T, Tl><<<grid, kThreads, Tl::kSmem, s>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<const T*>(w), static_cast<T*>(out), B, H, W, C, F, Ho,
      Wo, stride);
  return static_cast<int>(cudaGetLastError());
}

// the tile by F: 128 pixels x 128 columns up to F = 128, else 64 pixels x
// 256 columns (F / 256 column tiles, each sampling the pixels)
template <typename T>
int launch_fused(const void* x, const float* offsets, const float* mask, const void* w, void* out, int B, int H,
                 int W, int C, int F, int Ho, int Wo, int stride, cudaStream_t s) {
  if (F <= 128) return launch_tile<T, Tile<128>>(x, offsets, mask, w, out, B, H, W, C, F, Ho, Wo, stride, s);
  return launch_tile<T, Tile<64>>(x, offsets, mask, w, out, B, H, W, C, F, Ho, Wo, stride, s);
}

}  // namespace

// x (B, H, W, C) channels-last in x_dtype (kBFloat16 or kFloat16), offsets
// (B, Ho, Wo, 18) and mask (B, Ho, Wo, 9) f32, w (9 * C, F) row-major in
// x_dtype (k = tap * C + c), out (B, Ho, Wo, F) in x_dtype, written.  C a
// multiple of 32, F of 8; x and w 16-byte aligned.  One launch.  Returns
// cudaGetLastError() after it, or cudaErrorInvalidValue for what the kernel
// does not take (the Python wrapper rejects those first).
extern "C" int deform_conv_fused_forward(const void* x, int x_dtype, const void* offsets,
                                         const void* mask, const void* w, void* out, int B, int H,
                                         int W, int C, int F, int stride, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || stride <= 0 || C <= 0 || C % kBK || F <= 0 || F % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  // pixel tiles (64 or 128 pixels) fit the grid's y extent; pixels,
  // offsets and input rows are int32
  const int64_t M = static_cast<int64_t>(B) * Ho * Wo;
  if (M / 64 >= 65535 || M * 2 * kTaps > INT_MAX || static_cast<int64_t>(B) * H * W > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  switch (x_dtype) {
    case kBFloat16:
      return launch_fused<__nv_bfloat16>(x, off, msk, w, out, B, H, W, C, F, Ho, Wo, stride, s);
    case kFloat16: return launch_fused<__half>(x, off, msk, w, out, B, H, W, C, F, Ho, Wo, stride, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
