// The DCNv2 sampling backward as an output-tiled push with a warp-owned halo
// in shared memory: the design that the shipped gather
// (salience_detr_torch/csrc/deform_conv.cu, deform_conv_backward_gather) was
// measured against.  Build it as a baseline directory:
//
//     python3 chip_smoke.py --baseline-csrc tools/dcn_halo
//
// Same function as deform_conv_sample_backward_plain (ops/deform_conv.py).
// A block owns a tile of th x tw output pixels of one image and a slice of
// cs = min(C, 128) channels, one channel per thread, so each warp owns 32
// channels of every shared cell: plain adds, no shared atomics.  The tile's
// input halo, with a margin of kHaloRadius pixels of offset, accumulates
// w * mask * d_cols in f32 shared memory; every warp walks all of the tile's
// taps for its channels.  A tap with a corner outside the halo adds to d_x
// directly by f32 atomics.  Each batch of taps' three dot products (d_mask,
// d_offsets) are reduced over the lanes, combined over the warps in shared
// memory in warp order and written once (added by atomics when C is split
// over several blocks).  At the end the halo is added to d_x by float4
// reductions, skipping all-zero cells.  d_x is f32 and zeroed here; the
// caller casts it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../salience_detr_torch/csrc/msda_common.cuh"

namespace {

constexpr int kTaps = 9;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHaloRadius = 2;
constexpr int kHaloBatch = 128;
constexpr int kHaloSmemMax = 200 * 1024;

struct Tap {
  int x0, y0;
  float fx, fy, m;
};

__device__ __forceinline__ Tap make_tap(float oy, float ox, float m, int ho, int wo, int k,
                                        int stride, int H, int W) {
  const float py = __fadd_rn(static_cast<float>(ho * stride + k / 3 - 1), oy);
  const float px = __fadd_rn(static_cast<float>(wo * stride + k % 3 - 1), ox);
  const float y = fminf(fmaxf(py, -2.f), H + 1.f);
  const float x = fminf(fmaxf(px, -2.f), W + 1.f);
  const float y0f = floorf(y), x0f = floorf(x);
  return {static_cast<int>(x0f), static_cast<int>(y0f), __fsub_rn(x, x0f), __fsub_rn(y, y0f), m};
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

struct HaloPlan {
  int th, tw, hy, hx, cs, tiles_x, tiles_y, slices;
  size_t smem;
};

inline HaloPlan halo_plan(int B, int C, int Ho, int Wo, int stride) {
  HaloPlan p{};
  p.cs = C < 128 ? C : 128;
  p.slices = C / p.cs;
  p.th = stride == 1 ? 8 : 4;
  p.tw = stride == 1 ? 16 : 8;
  for (;;) {
    p.hy = (p.th - 1) * stride + 2 * kHaloRadius + 4;
    p.hx = (p.tw - 1) * stride + 2 * kHaloRadius + 4;
    p.smem = sizeof(float) * (static_cast<size_t>(p.hy) * p.hx * p.cs + p.th * p.tw * 27 +
                              kHaloBatch * (p.cs / 32) * 3);
    if (p.smem <= kHaloSmemMax || (p.th == 1 && p.tw == 1)) break;
    if (p.tw >= p.th) p.tw = (p.tw + 1) / 2; else p.th = (p.th + 1) / 2;
  }
  p.tiles_x = (Wo + p.tw - 1) / p.tw;
  p.tiles_y = (Ho + p.th - 1) / p.th;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(128)
dcn_halo_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                const float* __restrict__ mask, const T* __restrict__ d_cols,
                float* __restrict__ d_x, float* __restrict__ d_off, float* __restrict__ d_mask,
                int H, int W, int C, int Ho, int Wo, int stride, HaloPlan plan) {
  extern __shared__ float4 smem4[];
  const int cs = plan.cs, th = plan.th, tw = plan.tw, hy = plan.hy, hx = plan.hx;
  const int nw = cs / 32;
  float* halo = reinterpret_cast<float*>(smem4);
  float* tap_off = halo + hy * hx * cs;
  float* tap_mask = tap_off + th * tw * 18;
  float* part = tap_mask + th * tw * 9;
  const int tile = blockIdx.x;
  const int tx = tile % plan.tiles_x, ty = (tile / plan.tiles_x) % plan.tiles_y;
  const int b = tile / (plan.tiles_x * plan.tiles_y);
  const int cs0 = blockIdx.y * cs;
  const int ho0 = ty * th, wo0 = tx * tw;
  const int hy0 = ho0 * stride - 1 - kHaloRadius, hx0 = wo0 * stride - 1 - kHaloRadius;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = cs0 + tid;
  const int nitems = th * tw * kTaps;
  const int64_t image = static_cast<int64_t>(b) * H * W;

  for (int i = tid; i < hy * hx * cs; i += cs) halo[i] = 0.f;
  for (int i = tid; i < nitems; i += cs) {
    const int lp = i / kTaps, k = i % kTaps;
    const int ho = ho0 + lp / tw, wo = wo0 + lp % tw;
    float oy = 0.f, ox = 0.f, m = 0.f;
    if (ho < Ho && wo < Wo) {
      const int64_t item = ((static_cast<int64_t>(b) * Ho + ho) * Wo + wo) * kTaps + k;
      const float2 off = __ldg(reinterpret_cast<const float2*>(offsets) + item);
      oy = off.x;
      ox = off.y;
      m = __ldg(mask + item);
    }
    tap_off[2 * i] = oy;
    tap_off[2 * i + 1] = ox;
    tap_mask[i] = m;
  }
  __syncthreads();

  for (int base = 0; base < nitems; base += kHaloBatch) {
    const int batch = min(kHaloBatch, nitems - base);
    for (int ii = 0; ii < batch; ++ii) {
      const int i = base + ii, lp = i / kTaps, k = i % kTaps;
      const int ho = ho0 + lp / tw, wo = wo0 + lp % tw;
      float dm = 0.f, dpy = 0.f, dpx = 0.f;
      if (ho < Ho && wo < Wo) {
        const Tap t = make_tap(tap_off[2 * i], tap_off[2 * i + 1], tap_mask[i], ho, wo, k, stride,
                               H, W);
        const int64_t item = ((static_cast<int64_t>(b) * Ho + ho) * Wo + wo) * kTaps + k;
        const float g = to_float(d_cols[item * C + c]);
        const float gm = g * t.m;
        const bool inside = t.y0 >= hy0 && t.y0 + 1 < hy0 + hy && t.x0 >= hx0 && t.x0 + 1 < hx0 + hx;
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
            const float v = to_float(x[(image + static_cast<int64_t>(cy) * W + cx) * C + c]);
            const float dot = gm * v;
            dm = fmaf(w, g * v, dm);
            dpy = fmaf(dy ? wx : -wx, dot, dpy);
            dpx = fmaf(dx ? wy : -wy, dot, dpx);
            if (d_x != nullptr && w != 0.f) {
              if (inside) {
                halo[((cy - hy0) * hx + (cx - hx0)) * cs + tid] += w * gm;
              } else {
                atomicAdd(d_x + (image + static_cast<int64_t>(cy) * W + cx) * C + c, w * gm);
              }
            }
          }
        }
      }
      dm = warp_sum(dm);
      dpy = warp_sum(dpy);
      dpx = warp_sum(dpx);
      if (lane == 0) {
        float* q = part + (ii * nw + warp) * 3;
        q[0] = dm;
        q[1] = dpy;
        q[2] = dpx;
      }
    }
    __syncthreads();
    for (int ii = tid; ii < batch; ii += cs) {
      const int i = base + ii, lp = i / kTaps, k = i % kTaps;
      const int ho = ho0 + lp / tw, wo = wo0 + lp % tw;
      if (ho >= Ho || wo >= Wo) continue;
      float dm = 0.f, dpy = 0.f, dpx = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float* q = part + (ii * nw + w) * 3;
        dm += q[0];
        dpy += q[1];
        dpx += q[2];
      }
      const int64_t item = ((static_cast<int64_t>(b) * Ho + ho) * Wo + wo) * kTaps + k;
      if (plan.slices > 1) {
        atomicAdd(d_off + 2 * item, dpy);
        atomicAdd(d_off + 2 * item + 1, dpx);
        atomicAdd(d_mask + item, dm);
      } else {
        reinterpret_cast<float2*>(d_off)[item] = make_float2(dpy, dpx);
        d_mask[item] = dm;
      }
    }
    __syncthreads();
  }
  if (d_x == nullptr) return;
  const int c4s = cs / 4;
  for (int idx = tid; idx < hy * hx * c4s; idx += cs) {
    const int p = idx / c4s, q = idx % c4s;
    const int y = hy0 + p / hx, xx = hx0 + p % hx;
    if (y < 0 || y >= H || xx < 0 || xx >= W) continue;
    const float4 v = reinterpret_cast<const float4*>(halo + p * cs)[q];
    if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
    atomicAdd(reinterpret_cast<float4*>(d_x + (image + static_cast<int64_t>(y) * W + xx) * C + cs0) + q, v);
  }
}

template <typename T>
int launch_halo(const void* x, const float* off, const float* msk, const void* d_cols, float* d_x,
                float* d_off, float* d_mask, int B, int H, int W, int C, int Ho, int Wo,
                int stride, cudaStream_t s) {
  const HaloPlan plan = halo_plan(B, C, Ho, Wo, stride);
  cudaError_t err = cudaFuncSetAttribute(dcn_halo_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(plan.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B) * plan.tiles_x * plan.tiles_y, plan.slices);
  dcn_halo_kernel<T><<<grid, plan.cs, plan.smem, s>>>(
      static_cast<const T*>(x), off, msk, static_cast<const T*>(d_cols), d_x, d_off, d_mask, H, W,
      C, Ho, Wo, stride, plan);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// d_x: f32 (B, H, W, C), zeroed here, or null (no d_x); d_offsets and d_mask
// f32, written (zeroed here first when C > 128 splits the channels).
extern "C" int deform_conv_backward_halo(const void* x, int x_is_bf16, const void* offsets,
                                         const void* mask, const void* d_cols, void* d_x,
                                         void* d_offsets, void* d_mask, int B, int H, int W,
                                         int C, int stride, void* stream) {
  const bool c_ok = C == 32 || C == 64 || C == 128 || (C > 0 && C % 256 == 0);
  if (B < 0 || H <= 0 || W <= 0 || stride <= 0 || !c_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t items = static_cast<int64_t>(B) * Ho * Wo * kTaps;
  float* dx = static_cast<float*>(d_x);
  float* doff = static_cast<float*>(d_offsets);
  float* dmsk = static_cast<float*>(d_mask);
  cudaError_t err = cudaSuccess;
  if (dx != nullptr) err = cudaMemsetAsync(dx, 0, sizeof(float) * B * H * W * static_cast<int64_t>(C), s);
  if (err == cudaSuccess && C > 128) err = cudaMemsetAsync(doff, 0, sizeof(float) * 2 * items, s);
  if (err == cudaSuccess && C > 128) err = cudaMemsetAsync(dmsk, 0, sizeof(float) * items, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  if (x_is_bf16) {
    return launch_halo<__nv_bfloat16>(x, off, msk, d_cols, dx, doff, dmsk, B, H, W, C, Ho, Wo, stride, s);
  }
  return launch_halo<float>(x, off, msk, d_cols, dx, doff, dmsk, B, H, W, C, Ho, Wo, stride, s);
}
