// Modulated deformable convolution (DCNv2) forward in 16-bit types: the
// sampling fused with its kernel product on the tensor cores.
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
// their sums run on the tensor cores (mma.sync m16n8k16, T x T -> f32); the
// f32 sum is rounded once to T.  Only the order of that sum differs from the
// plain version's matmul.
//
// What bounds it on an H100: its operations, 2 * M * K * N = 19.8 GFLOP at
// every R50-DCN layer (M = B * Ho * Wo, K = 9 * Cin, N = F), 0.020 ms at
// 989 TFLOP/s of bf16 tensor-core rate, against 17-69 MB of x, offsets,
// mask, W and out (0.005-0.021 ms at 3.35 TB/s).  The columns (155 MB at
// stage 2) are never written.  It runs far from that bound: its time goes
// to the gather and the per-step work (barrier, B tile, ldmatrix), about as
// long as the columns kernel alone; the MMAs cost little.
//
// Where it is used: ops/deform_conv.deform_conv2d routes a 16-bit layer
// here only for F <= 128, where one channel tile covers F and every pixel's
// taps are sampled once.  Above that the tile below samples each pixel
// F / 128 times and loses to the columns kernel + cuBLAS (chip_smoke.py's
// deform_conv_fused lines time it at every R50-DCN shape); those layers
// take the columns route.  The kernel itself takes any F a multiple of 8.
//
// The tile: a block of 256 threads (8 warps), two blocks an SM, takes kBM =
// 64 output pixels x kBN = 128 output channels and walks K in steps of kBK =
// 32 channels of one tap (tap-major, as k = tap * Cin + c):
//   * the block's offsets and masks go to shared memory first, so that a
//     tap's corners wait on no global load;
//   * the gather: each thread copies its pixel's 4 corner rows, 8 channels
//     (16 bytes) each, by cp.async into a stage in shared memory (zero-filled
//     outside the image), kStages - 1 steps ahead;
//   * the sums: each thread turns its own 4 corner chunks into the A tile's
//     chunk (kBM x kBK, the columns' tile) in place, over the corner-0 plane;
//   * B (kBK x kBN of W, (9 * Cin, F) row-major) arrives by cp.async in the
//     same stage; one barrier a step;
//   * each warp holds a 32 x 32 tile of f32 sums: 2 x 4 m16n8 fragments,
//     operands by ldmatrix (B transposed; A's 16-byte chunks XOR-swizzled
//     so that the reads are free of bank conflicts);
//   * the epilogue rounds the sums to T and stores (B, Ho, Wo, F)
//     channels-last; rows past M and channels past F are neither sampled
//     (zero) nor stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "msda_common.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kStages = 3;  // steps whose gathers are in flight or waiting
constexpr int kThreads = 256;
constexpr int kBStride = kBN + 8;  // 272-byte rows of the B tile
constexpr int kWarpM = 32, kWarpN = 32;
// one stage in shared memory: the gathered corners [corner][pixel][kBK
// channels] (64-byte rows, 16-byte chunks swizzled), whose corner-0 plane
// the sums overwrite to become the A tile; the B tile; per pixel the four
// corner weights and the mask
constexpr int kRawElems = 4 * kBM * kBK;
constexpr int kBElems = kBK * kBStride;
constexpr int kInfoFloats = 5 * kBM;

template <typename T>
constexpr int kStageBytes = (kRawElems + kBElems) * static_cast<int>(sizeof(T)) + kInfoFloats * 4;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4], const unsigned (&a)[4],
                                             const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read then),
// through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}



__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// the 16-byte chunk q (of 4) of a 64-byte row: XOR-swizzled so that the
// ldmatrix reads of 8 consecutive rows hit 8 different bank groups
__device__ __forceinline__ int chunk_of(int row, int q) { return q ^ ((row >> 1) & 3); }

// the B tile of one step: kBK rows of W from row k0, kBN columns from n0
// (columns past F zero-filled), 2 cp.async of 16 bytes a thread
template <typename T>
__device__ __forceinline__ void load_b(const T* __restrict__ w, int F, int64_t k0, int n0,
                                       T* __restrict__ b_tile, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int kr = idx / (kBN / 8), q = idx % (kBN / 8);
    const int n = n0 + q * 8;
    const bool valid = n < F;
    cp_async16(b_tile + kr * kBStride + q * 8, valid ? w + (k0 + kr) * F + n : w, valid);
  }
}

// One thread's part of the sampling: its output pixel (4 threads of 8
// channels each a pixel) and, for the tap being issued, its corners' rows
// (-1 outside the image) and weights and the mask.  The arithmetic is
// deform_conv_forward_kernel's, operation for operation.
template <typename T>
struct Sampler {
  const T* x;
  const float* offsets;  // the block's pixels' offsets (kBM x 18) and masks (kBM x 9), in shared memory
  const float* mask;
  int H, W, C, stride;
  int pix;        // flat output pixel, -1 past M
  int p_local;    // its row in the block's tile
  int b, ho, wo;  // its coordinates
  int q;          // its 8 channels: chunk q of a kBK chunk
  int row[4];
  float w[4], m;

  __device__ __forceinline__ void tap(int k) {
    if (pix < 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        row[c] = -1;
        w[c] = 0.f;
      }
      m = 0.f;
      return;
    }
    const float2 off = reinterpret_cast<const float2*>(offsets)[p_local * kTaps + k];
    m = mask[p_local * kTaps + k];
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
        w[c] = __fmul_rn(dx ? fx : __fsub_rn(1.f, fx), wy);
        row[c] = valid ? (b * H + cy) * W + cx : -1;
      }
    }
  }

  // this thread's corner copies of channels [c_base + 8 q, + 8) into a
  // stage (zero-filled outside the image), and, from one thread a pixel,
  // the weights and mask beside them
  __device__ __forceinline__ void issue(int c_base, T* __restrict__ raw, float* __restrict__ info,
                                        int p_local) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool valid = row[c] >= 0;
      const T* src = valid ? x + static_cast<int64_t>(row[c]) * C + c_base + q * 8 : x;
      cp_async16(raw + (c * kBM + p_local) * kBK + chunk_of(p_local, q) * 8, src, valid);
    }
    if (q == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) info[c * kBM + p_local] = w[c];
      info[4 * kBM + p_local] = m;
    }
  }
};

// the corner sum of this thread's 8 channels in the plain order (a corner
// outside the image is zero-filled: w * 0 adds +0, which changes no sum),
// times the mask, rounded to T, over the corner-0 chunk it was read from
template <typename T>
__device__ __forceinline__ void convert(T* __restrict__ raw, const float* __restrict__ info, int p_local,
                                        int q) {
  const int at = p_local * kBK + chunk_of(p_local, q) * 8;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 v = *reinterpret_cast<const uint4*>(raw + c * kBM * kBK + at);
    const T* e = reinterpret_cast<const T*>(&v);
    const float wc = info[c * kBM + p_local];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wc, to_float(e[i])));
  }
  const float m = info[4 * kBM + p_local];
  uint4 packed;
  T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = from_float<T>(__fmul_rn(acc[i], m));
  *reinterpret_cast<uint4*>(raw + at) = packed;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
deform_conv_fused_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                         const float* __restrict__ mask, const T* __restrict__ w,
                         T* __restrict__ out, int B, int H, int W, int C, int F, int Ho, int Wo,
                         int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  const int M = B * Ho * Wo;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  auto raw_of = [&](int slot) { return reinterpret_cast<T*>(smem + slot * kStageBytes<T>); };
  auto b_of = [&](int slot) { return raw_of(slot) + kRawElems; };
  auto info_of = [&](int slot) { return reinterpret_cast<float*>(b_of(slot) + kBElems); };

  Sampler<T> sm;
  sm.x = x;
  sm.H = H;
  sm.W = W;
  sm.C = C;
  sm.stride = stride;
  sm.q = tid % 4;
  const int p_local = tid / 4;
  sm.p_local = p_local;
  const int p = m0 + p_local;
  sm.pix = p < M ? p : -1;
  sm.wo = p % Wo;
  sm.ho = (p / Wo) % Ho;
  sm.b = p / (Wo * Ho);

  float acc[kWarpM / 16][kWarpN / 8][4];
#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kWarpN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int chunks = C / kBK;
  const int steps = kTaps * chunks;
  // the block's offsets and masks, once: a tap's corners then wait on no
  // global load
  float* const off_s = reinterpret_cast<float*>(smem + kStages * kStageBytes<T>);
  float* const mask_s = off_s + kBM * 2 * kTaps;
  const int pixels = min(kBM, M - m0);
  for (int i = tid; i < pixels * 2 * kTaps; i += kThreads) off_s[i] = __ldg(offsets + m0 * 2 * kTaps + i);
  for (int i = tid; i < pixels * kTaps; i += kThreads) mask_s[i] = __ldg(mask + m0 * kTaps + i);
  sm.offsets = off_s;
  sm.mask = mask_s;
  __syncthreads();

  int k_issue = 0, c_issue = 0;  // the next step to issue
  sm.tap(0);
  // issue step `s` into its slot (an empty group past the last step, so
  // that the count of groups in flight stays kStages - 1)
  auto issue = [&](int s) {
    if (s < steps) {
      if (c_issue == C) {
        c_issue = 0;
        sm.tap(++k_issue);
      }
      const int slot = s % kStages;
      load_b(w, F, static_cast<int64_t>(k_issue) * C + c_issue, n0, b_of(slot), tid);
      sm.issue(c_issue, raw_of(slot), info_of(slot), p_local);
      c_issue += kBK;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  __syncthreads();  // the weights written beside the first stages

  for (int s = 0; s < steps; ++s) {
    const int slot = s % kStages;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    convert(raw_of(slot), info_of(slot), p_local, sm.q);
    __syncthreads();
    issue(s + kStages - 1);  // into the slot step s - 1 used, free since the barrier
    const T* a_cur = raw_of(slot);
    const T* b_cur = b_of(slot);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned b[kWarpN / 8][2];
#pragma unroll
      for (int j = 0; j < kWarpN / 16; ++j) {
        // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        const int mat = lane / 8;
        const int kr = kk + (mat % 2) * 8 + (lane % 8);
        const int n = wn * kWarpN + j * 16 + (mat / 2) * 8;
        unsigned r[4];
        ldmatrix_x4_trans(r, b_cur + kr * kBStride + n);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kWarpM / 16; ++i) {
        const int r = wm * kWarpM + i * 16 + (lane % 16);
        unsigned a[4];
        ldmatrix_x4(a, a_cur + r * kBK + chunk_of(r, kk / 8 + lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kWarpN / 8; ++j) Mma<T>::run(acc[i][j], a, b[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kWarpM / 16; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * kWarpM + i * 16 + half * 8 + lane / 4;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kWarpN / 8; ++j) {
        const int n = n0 + wn * kWarpN + j * 8 + (lane % 4) * 2;
        if (n >= F) continue;
        const T pair[2] = {from_float<T>(acc[i][j][2 * half]), from_float<T>(acc[i][j][2 * half + 1])};
        unsigned bits;
        memcpy(&bits, pair, sizeof(bits));
        *reinterpret_cast<unsigned*>(out + static_cast<int64_t>(m) * F + n) = bits;
      }
    }
  }
}

template <typename T>
int launch_fused(const void* x, const float* offsets, const float* mask, const void* w, void* out,
                 int B, int H, int W, int C, int F, int Ho, int Wo, int stride, cudaStream_t s) {
  const int M = B * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((F + kBN - 1) / kBN), static_cast<unsigned>((M + kBM - 1) / kBM));
  constexpr int kSmem = kStages * kStageBytes<T> + kBM * 3 * kTaps * 4;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      deform_conv_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem));
  if (err != 0) return err;
  deform_conv_fused_kernel<T><<<grid, kThreads, kSmem, s>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<const T*>(w), static_cast<T*>(out), B, H,
      W, C, F, Ho, Wo, stride);
  return static_cast<int>(cudaGetLastError());
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
  // pixel tiles fit the grid's y extent; pixels, offsets and input rows
  // are int32
  const int64_t M = static_cast<int64_t>(B) * Ho * Wo;
  if (M / kBM >= 65535 || M * 2 * kTaps > INT_MAX || static_cast<int64_t>(B) * H * W > INT_MAX) {
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
