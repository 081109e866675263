// Modulated deformable convolution sampling (DCNv2), forward and backward.
//
// Replaces salience_detr_tpu/models/bricks/deform_conv.py::_bilinear_sample_map
// (with the mask multiply of DeformConv2dPack, :92-95) and its autodiff.
//
// Semantics (deform_conv_sample_plain and deform_conv_sample_backward_plain
// in ops/deform_conv.py are the spec): x (B, H, W, C) channels-last, offsets
// (B, Ho, Wo, 18) f32 with (dy, dx) interleaved per tap, mask (B, Ho, Wo, 9)
// f32.  Tap k = 3 * (ky + 1) + (kx + 1) of output pixel (ho, wo) samples at
// py = (ho * stride + ky) + dy, px = (wo * stride + kx) + dx in pixel units;
// its 4 bilinear corners outside the image have weight 0 and are neither read
// nor written.  Forward: cols[b, ho, wo, k, :] = mask * sum over corners of
// (wx * wy) * x[corner, :], summed in f32 corner by corner in the order (0,
// 0), (0, 1), (1, 0), (1, 1) without fused multiply-adds, rounded once to x's
// dtype (the plain version's arithmetic, operation for operation).  Backward,
// with g = d_cols * mask: d_x[corner] += (wx * wy) * g; d_mask = <d_cols,
// sample>; d_offsets (dy, dx) = sum over corners of <g, x[corner]> times d
// (wx * wy) / d (py, px) = (+-wx, +-wy).
//
// What bounds it on an H100: bytes.  At the R50-DCN configuration's stage-2
// layers (B=4, 100x168 outputs, C=128, bf16) the forward writes a 155 MB
// column matrix from a 17-69 MB input (each input pixel is read by up to 36
// corners, mostly from L1/L2); the backward reads that many bytes of d_cols
// and adds C floats per valid corner into an f32 d_x with atomics.
//
// What this simple design does about it: the lanes of a warp hold CPL =
// min(8, C / 32) adjacent channels (looping over C / (32 * CPL) chunks), so
// every corner row and every column row is one coalesced request of 32 * CPL
// elements, and a tap's position and corner weights are computed once per
// lane.  The forward takes one warp per output pixel (b, ho, wo) and walks its
// 9 taps, the backward one warp per (b, ho, wo, tap).  The backward reduces
// its three dot products over the lanes with shuffles and writes them without
// atomics; d_x takes one vector atomicAdd (sm_90's float4 / float2 reduction)
// per 4 channels.  A
// fused implicit GEMM (the columns sampled into shared memory and consumed by
// wgmma there) would not write the columns at all; that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_common.cuh"

namespace {

constexpr int kTaps = 9;

// One tap of one output pixel: its corners' top-left (x0, y0), the corner
// weights' factors and the mask.  Clamping the position to [-2, size + 1]
// changes no corner's validity (a clamped tap has no corner in the image)
// and keeps the float -> int conversion defined for far-away taps.
struct Tap {
  int x0, y0;
  float fx, fy, m;
};

__device__ __forceinline__ Tap load_tap(const float* __restrict__ offsets,
                                        const float* __restrict__ mask, int64_t pix, int k,
                                        int ho, int wo, int stride, int H, int W) {
  const float2 off = __ldg(reinterpret_cast<const float2*>(offsets + pix * 2 * kTaps) + k);
  const float py = __fadd_rn(static_cast<float>(ho * stride + k / 3 - 1), off.x);
  const float px = __fadd_rn(static_cast<float>(wo * stride + k % 3 - 1), off.y);
  const float y = fminf(fmaxf(py, -2.f), H + 1.f);
  const float x = fminf(fmaxf(px, -2.f), W + 1.f);
  const float y0f = floorf(y), x0f = floorf(x);
  return {static_cast<int>(x0f), static_cast<int>(y0f), __fsub_rn(x, x0f), __fsub_rn(y, y0f),
          __ldg(mask + pix * kTaps + k)};
}

template <int CPL>
__device__ __forceinline__ void red_add(float* p, const float (&v)[CPL]) {
  if constexpr (CPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CPL; i += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + i), make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    }
  } else if constexpr (CPL == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// One warp per output pixel (b, ho, wo), its 9 taps in turn: lanes 0-17
// load the pixel's offsets and lanes 0-8 its masks once, and each tap takes
// its three values by shuffles, so the taps' corner loads do not wait on
// their own offset loads and can be in flight together.
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deform_conv_forward_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                           const float* __restrict__ mask, T* __restrict__ cols, int B, int H,
                           int W, int C, int Ho, int Wo, int stride) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (pix >= static_cast<int64_t>(B) * Ho * Wo) return;
  const int lane = threadIdx.x & 31;
  const int wo = static_cast<int>(pix % Wo);
  const int ho = static_cast<int>((pix / Wo) % Ho);
  const int b = static_cast<int>(pix / (static_cast<int64_t>(Wo) * Ho));
  const float my_off = lane < 2 * kTaps ? __ldg(offsets + pix * 2 * kTaps + lane) : 0.f;
  const float my_mask = lane < kTaps ? __ldg(mask + pix * kTaps + lane) : 0.f;
  const T* x_b = x + static_cast<int64_t>(b) * H * W * C;

#pragma unroll 3
  for (int k = 0; k < kTaps; ++k) {
    const float oy = __shfl_sync(0xffffffffu, my_off, 2 * k);
    const float ox = __shfl_sync(0xffffffffu, my_off, 2 * k + 1);
    const float m = __shfl_sync(0xffffffffu, my_mask, k);
    const float py = __fadd_rn(static_cast<float>(ho * stride + k / 3 - 1), oy);
    const float px = __fadd_rn(static_cast<float>(wo * stride + k % 3 - 1), ox);
    const float y = fminf(fmaxf(py, -2.f), H + 1.f);
    const float xf = fminf(fmaxf(px, -2.f), W + 1.f);
    const float y0f = floorf(y), x0f = floorf(xf);
    const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
    const float fy = __fsub_rn(y, y0f), fx = __fsub_rn(xf, x0f);
    T* out = cols + (pix * kTaps + k) * C;
    for (int c0 = lane * CPL; c0 < C; c0 += 32 * CPL) {
      float acc[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        if (cy < 0 || cy >= H) continue;
        const float wy = dy ? fy : __fsub_rn(1.f, fy);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          if (cx < 0 || cx >= W) continue;
          const float w = __fmul_rn(dx ? fx : __fsub_rn(1.f, fx), wy);
          float v[CPL];
          load_chunk<T, CPL>(x_b + (static_cast<int64_t>(cy) * W + cx) * C + c0, v);
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, v[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = __fmul_rn(acc[i], m);
      store_chunk<T, CPL>(out + c0, acc);
    }
  }
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deform_conv_backward_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                            const float* __restrict__ mask, const T* __restrict__ d_cols,
                            float* __restrict__ d_x, float* __restrict__ d_offsets,
                            float* __restrict__ d_mask, int B, int H, int W, int C, int Ho,
                            int Wo, int stride) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (item >= static_cast<int64_t>(B) * Ho * Wo * kTaps) return;
  const int lane = threadIdx.x & 31;
  const int64_t pix = item / kTaps;
  const int k = static_cast<int>(item % kTaps);
  const int wo = static_cast<int>(pix % Wo);
  const int ho = static_cast<int>((pix / Wo) % Ho);
  const int b = static_cast<int>(pix / (static_cast<int64_t>(Wo) * Ho));
  const Tap t = load_tap(offsets, mask, pix, k, ho, wo, stride, H, W);
  const int64_t image = static_cast<int64_t>(b) * H * W;
  const T* grad = d_cols + item * C;

  float dm = 0.f, dpy = 0.f, dpx = 0.f;
  for (int c0 = lane * CPL; c0 < C; c0 += 32 * CPL) {
    float g[CPL], gm[CPL];
    load_chunk<T, CPL>(grad + c0, g);
#pragma unroll
    for (int i = 0; i < CPL; ++i) gm[i] = g[i] * t.m;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int cy = t.y0 + dy;
      if (cy < 0 || cy >= H) continue;
      const float wy = dy ? t.fy : 1.f - t.fy;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int cx = t.x0 + dx;
        if (cx < 0 || cx >= W) continue;
        const float wx = dx ? t.fx : 1.f - t.fx;
        const float w = wx * wy;
        const int64_t row = (image + static_cast<int64_t>(cy) * W + cx) * C + c0;
        float v[CPL];
        load_chunk<T, CPL>(x + row, v);
        float dot = 0.f, sdot = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          dot = fmaf(gm[i], v[i], dot);
          sdot = fmaf(g[i], v[i], sdot);
        }
        dm = fmaf(w, sdot, dm);
        dpy = fmaf(dy ? wx : -wx, dot, dpy);
        dpx = fmaf(dx ? wy : -wy, dot, dpx);
        if (d_x != nullptr && w != 0.f) {
          float add[CPL];
#pragma unroll
          for (int i = 0; i < CPL; ++i) add[i] = w * gm[i];
          red_add<CPL>(d_x + row, add);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dm += __shfl_xor_sync(0xffffffffu, dm, off);
    dpy += __shfl_xor_sync(0xffffffffu, dpy, off);
    dpx += __shfl_xor_sync(0xffffffffu, dpx, off);
  }
  if (lane == 0) {
    reinterpret_cast<float2*>(d_offsets + pix * 2 * kTaps)[k] = make_float2(dpy, dpx);
    d_mask[pix * kTaps + k] = dm;
  }
}

// one warp per (b, ho, wo, tap)
inline unsigned grid_of(int B, int Ho, int Wo) {
  const int64_t warps = static_cast<int64_t>(B) * Ho * Wo * kTaps;
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <typename T, int CPL>
void launch_forward(const void* x, const float* offsets, const float* mask, void* cols, int B,
                    int H, int W, int C, int Ho, int Wo, int stride, cudaStream_t s) {
  const int64_t warps = static_cast<int64_t>(B) * Ho * Wo;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  deform_conv_forward_kernel<T, CPL><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<T*>(cols), B, H, W, C, Ho, Wo, stride);
}

template <typename T, int CPL>
void launch_backward(const void* x, const float* offsets, const float* mask, const void* d_cols,
                     float* d_x, float* d_offsets, float* d_mask, int B, int H, int W, int C,
                     int Ho, int Wo, int stride, cudaStream_t s) {
  deform_conv_backward_kernel<T, CPL><<<grid_of(B, Ho, Wo), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<const T*>(d_cols), d_x, d_offsets,
      d_mask, B, H, W, C, Ho, Wo, stride);
}

// channels per lane: 1, 2, 4 for C = 32, 64, 128; 8 for multiples of 256
inline int lane_channels(int C) {
  if (C == 32 || C == 64 || C == 128) return C / 32;
  return C > 0 && C % 256 == 0 ? 8 : 0;
}

template <typename T>
int dispatch_forward(const void* x, const float* offsets, const float* mask, void* cols, int B,
                     int H, int W, int C, int Ho, int Wo, int stride, cudaStream_t s) {
  switch (lane_channels(C)) {
    case 1: launch_forward<T, 1>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 2: launch_forward<T, 2>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 4: launch_forward<T, 4>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 8: launch_forward<T, 8>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_backward(const void* x, const float* offsets, const float* mask, const void* d_cols,
                      float* d_x, float* d_offsets, float* d_mask, int B, int H, int W, int C,
                      int Ho, int Wo, int stride, cudaStream_t s) {
  switch (lane_channels(C)) {
    case 1: launch_backward<T, 1>(x, offsets, mask, d_cols, d_x, d_offsets, d_mask, B, H, W, C, Ho, Wo, stride, s); break;
    case 2: launch_backward<T, 2>(x, offsets, mask, d_cols, d_x, d_offsets, d_mask, B, H, W, C, Ho, Wo, stride, s); break;
    case 4: launch_backward<T, 4>(x, offsets, mask, d_cols, d_x, d_offsets, d_mask, B, H, W, C, Ho, Wo, stride, s); break;
    case 8: launch_backward<T, 8>(x, offsets, mask, d_cols, d_x, d_offsets, d_mask, B, H, W, C, Ho, Wo, stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool dims_ok(int B, int H, int W, int C, int stride) {
  return B >= 0 && H > 0 && W > 0 && stride > 0 && lane_channels(C) > 0;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int deform_conv_forward(const void* x, int x_is_bf16, const void* offsets,
                                   const void* mask, void* cols, int B, int H, int W, int C,
                                   int stride, void* stream) {
  if (!dims_ok(B, H, W, C, stride)) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  if (x_is_bf16) {
    return dispatch_forward<__nv_bfloat16>(x, off, msk, cols, B, H, W, C, Ho, Wo, stride, s);
  }
  return dispatch_forward<float>(x, off, msk, cols, B, H, W, C, Ho, Wo, stride, s);
}

// d_x may be null (x needs no gradient): the scatter is skipped.  d_x, when
// given, must be zeroed f32 (B, H, W, C); d_offsets and d_mask are written.
extern "C" int deform_conv_backward(const void* x, int x_is_bf16, const void* offsets,
                                    const void* mask, const void* d_cols, void* d_x,
                                    void* d_offsets, void* d_mask, int B, int H, int W, int C,
                                    int stride, void* stream) {
  if (!dims_ok(B, H, W, C, stride)) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  float* dx = static_cast<float*>(d_x);
  float* doff = static_cast<float*>(d_offsets);
  float* dmsk = static_cast<float*>(d_mask);
  if (x_is_bf16) {
    return dispatch_backward<__nv_bfloat16>(x, off, msk, d_cols, dx, doff, dmsk, B, H, W, C, Ho,
                                            Wo, stride, s);
  }
  return dispatch_backward<float>(x, off, msk, d_cols, dx, doff, dmsk, B, H, W, C, Ho, Wo,
                                  stride, s);
}
