// Multi-scale deformable attention backward (MSDA), one kernel for every
// location-group count G: the vector-Jacobian product of msda.cu's forward.
//
// Replaces, in salience_detr_tpu/ops/deform_attn.py:
//   * the custom VJP of the head-shared core (_make_quadgrad_reduce, its
//     _bwd, with the autodiff of the corner weights around it; G = 1, the
//     encoder)
//   * the autodiff of ms_deform_attn_core / ms_deform_attn_core_quad (G = H,
//     exact per-head locations, the decoder)
//
// Semantics (ms_deform_attn_backward_plain in ops/deform_attn.py is the
// spec): for each (b, q), head h with location group g = h * G / H, level l,
// point p, and each in-level corner with bilinear weight cw = wx * wy:
//   d_weights[b,q,h,l,p] += cw * <d_out[b,q,head h], value[corner, head h]>
//   d_value[b,corner,head h] += attn[b,q,h,l,p] * cw * d_out[b,q,head h]
//   d_loc[b,q,g,l,p] += attn * <d_out_h, value_h> * (d cw / d loc), summed
//                       over the H / G heads of the group, where
//                       d wx / d loc_x = -w_l or +w_l and likewise for y.
// Out-of-level corners are neither read nor written; the floor is piecewise
// constant and contributes nothing.
//
// What bounds it on an H100: the d_value scatter.  Every corner adds C
// floats into d_value with atomics (f32 RED to L2): at the flagship's first
// encoder layer (B=4, Q=11403, L=P=4, C=256) that is 187M atomic adds into a
// 91 MB f32 buffer, and neighbouring queries of the head-shared encoder
// sample the same corners, so the adds collide.  The gathers (the corner
// rows re-read for the dot products) are the same bytes the forward reads.
//
// What this simple design does about it: the forward's layout, one warp per
// (b, q) with lanes over channels, so a corner's C adds are one coalesced
// 32-lane request and each corner row is read once for all heads; the dot
// products reduce across the lanes of a head (d_weights) and of a location
// group (d_locations) with warp shuffles, and those two outputs are written
// once by one lane, without atomics.  Sums are f32.  Privatised or sorted
// scatters that avoid the collisions are later work.  Atomics add in no fixed
// order, so d_value differs from run to run in its last bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"
#include "msda_common.cuh"

namespace {

// value (B, S, C), loc (B, Q, G, L, P, 2) f32, attn (B, Q, H, L, P) f32,
// d_out (B, Q, C) in the value dtype; d_value (B, S, C) f32, zeroed by the
// caller; d_loc (B, Q, G, L, P, 2) f32 and d_attn (B, Q, H, L, P) f32, every
// element written here.
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_backward_kernel(const T* __restrict__ value, const LevelTable levels,
                     const float* __restrict__ loc, const float* __restrict__ attn,
                     const T* __restrict__ d_out, float* __restrict__ d_value,
                     float* __restrict__ d_loc, float* __restrict__ d_attn, int B, int S,
                     int Q, int H, int G, int P) {
  const int64_t bq = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (bq >= static_cast<int64_t>(B) * Q) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int C = 32 * CPL;
  const int L = levels.num_levels;
  const int b = static_cast<int>(bq / Q);
  const int c0 = lane * CPL;
  const int h = c0 / (C / H);
  const int g = h * G / H;
  // heads and groups hold aligned, power-of-two runs of lanes (H divides 32)
  const int lanes_per_head = 32 / H;
  const int lanes_per_group = 32 / G;

  const float* loc_q = loc + ((bq * G + g) * L) * P * 2;
  const float* attn_q = attn + ((bq * H + h) * L) * P;
  float* d_attn_q = d_attn + ((bq * H + h) * L) * P;
  float2* d_loc_q = reinterpret_cast<float2*>(d_loc) + (bq * G + g) * L * P;
  const int64_t batch_offset = static_cast<int64_t>(b) * S * C + c0;
  const T* value_b = value + batch_offset;
  float* d_value_b = d_value + batch_offset;

  float go[CPL];
  load_chunk<T, CPL>(d_out + bq * C + c0, go);

  for (int l = 0; l < L; ++l) {
    const int lh = levels.h[l], lw = levels.w[l], ls = levels.start[l];
    for (int p = 0; p < P; ++p) {
      const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + l * P + p);
      const float a = __ldg(attn_q + l * P + p);
      // the forward's clamp: it changes no corner's validity, and a clamped
      // point has no in-level corner, so its gradient is 0 either way
      const float x = fminf(fmaxf(pixel_coord(xy.x, lw), -2.f), lw + 1.f);
      const float y = fminf(fmaxf(pixel_coord(xy.y, lh), -2.f), lh + 1.f);
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = x - x0f, fy = y - y0f;
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
      float s = 0.f, gx = 0.f, gy = 0.f;  // this lane's partial sums
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        if (cy < 0 || cy >= lh) continue;
        const float wy = dy ? fy : 1.f - fy;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          if (cx < 0 || cx >= lw) continue;
          const float wx = dx ? fx : 1.f - fx;
          const int64_t row = static_cast<int64_t>(ls + cy * lw + cx) * C;
          float v[CPL];
          load_chunk<T, CPL>(value_b + row, v);
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < CPL; ++i) dot = fmaf(go[i], v[i], dot);
          s = fmaf(wx * wy, dot, s);
          gx = fmaf(dx ? wy : -wy, dot, gx);
          gy = fmaf(dy ? wx : -wx, dot, gy);
          const float aw = a * (wx * wy);
          float* dst = d_value_b + row;
#pragma unroll
          for (int i = 0; i < CPL; ++i) atomicAdd(dst + i, aw * go[i]);
        }
      }
      // every lane reaches the shuffles: the loops above are warp-uniform
      for (int off = lanes_per_head / 2; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if ((lane & (lanes_per_head - 1)) == 0) d_attn_q[l * P + p] = s;
      gx *= a;
      gy *= a;
      for (int off = lanes_per_group / 2; off > 0; off >>= 1) {
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
        gy += __shfl_xor_sync(0xffffffffu, gy, off);
      }
      if ((lane & (lanes_per_group - 1)) == 0) d_loc_q[l * P + p] = make_float2(gx * lw, gy * lh);
    }
  }
}

template <typename T, int CPL>
void launch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
            const void* d_out, void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
            int H, int G, int P, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(B) * Q;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_backward_kernel<T, CPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), levels, static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(d_out),
      static_cast<float*>(d_value), static_cast<float*>(d_loc), static_cast<float*>(d_attn), B,
      S, Q, H, G, P);
}

template <typename T>
int dispatch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
             const void* d_out, void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
             int C, int H, int G, int P, cudaStream_t stream) {
  switch (C / 32) {
    case 1:
      launch<T, 1>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                   stream);
      break;
    case 2:
      launch<T, 2>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                   stream);
      break;
    case 8:
      launch<T, 8>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                   stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int msda_backward(const void* value, int value_is_bf16, LevelTable levels,
                             const void* loc, const void* attn, const void* d_out,
                             void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
                             int C, int H, int G, int P, void* stream) {
  if (!shapes_ok(levels, S, C, H, G)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16) {
    return dispatch<__nv_bfloat16>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B,
                                   S, Q, C, H, G, P, s);
  }
  return dispatch<float>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, C,
                         H, G, P, s);
}
