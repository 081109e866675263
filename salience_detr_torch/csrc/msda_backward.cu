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
// floats into d_value with atomics (reductions in L2): at the flagship's
// first encoder layer (B=4, Q=11403, L=P=4, C=256) up to 187M float adds into
// a 91 MB f32 buffer, and neighbouring queries of the head-shared encoder
// sample the same corners, so the adds collide.  The gathers (the corner
// rows re-read for the dot products) are the same bytes the forward reads.
//
// What this design does about it: one warp per (b, q), each corner row read
// once for all heads; the lanes hold the channels in chunks of VW = 4 (or
// C / 32) floats, chunk k of lane l at channels k * 32 * VW + l * VW, so that
// each warp-wide vector reduction (sm_90's float4 / float2 atomicAdd, one
// RED of 16 B per lane) covers 32 * VW * 4 contiguous bytes: at C = 256, 2
// instructions of 512 B per corner, where a lane owning 8 adjacent channels
// needed 8 scalar instructions touching 32 sectors each.  A corner whose
// attn * cw is exactly 0 (a sixth of the in-level corners of the encoder's
// first layer at init, where most sampling points sit on pixel centres)
// adds nothing and is not scattered; its row is still read for d_locations.  d_weights and d_locations reduce across the lanes (and
// chunks) of a head or location group with warp shuffles and are written
// once, without atomics.  Sums are f32; the atomics add in no fixed order,
// so d_value differs from run to run in its last bits.  One block per
// (image, head, query tile) that added the two coarsest levels into a
// private f32 slice in shared memory was measured and lost at G = 1
// (PERF.md): shared-memory f32 atomics are compare-and-swap loops on this
// card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"
#include "msda_common.cuh"

namespace {

// One sampling point on a level of lh x lw pixels: the top-left corner
// (x0, y0) of its four bilinear corners and the fractions (fx, fy).
// Clamping to [-2, size + 1] changes no corner's validity (a clamped point
// has no corner in its level) and keeps the float -> int conversion defined
// for far-away points.
struct Bilinear {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ Bilinear bilinear(float2 xy, int lh, int lw) {
  const float x = fminf(fmaxf(pixel_coord(xy.x, lw), -2.f), lw + 1.f);
  const float y = fminf(fmaxf(pixel_coord(xy.y, lh), -2.f), lh + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  return {static_cast<int>(x0f), static_cast<int>(y0f), x - x0f, y - y0f};
}

// VW floats at p (aligned to 4 * VW bytes) added to global memory by one
// vector reduction.
template <int VW>
__device__ __forceinline__ void red_add(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VW == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Sums each chunk's partial v[k] over its channel group of `width` channels
// (a power of two dividing C: a head, D = C / H, or a location group, C / G).
// A group narrower than a chunk is a run of width / VW aligned lanes (xor
// shuffles); a wider one is whole chunks, summed in registers first.  Every
// lane ends with its groups' totals.  All 32 lanes must call it.
template <int VW, int NCH>
__device__ __forceinline__ void group_sum(float (&v)[NCH], int width) {
  static_assert(NCH == 1 || NCH == 2, "chunks per lane");
  if (width >= 32 * VW) {
    if (NCH == 2 && width == 64 * VW) {
      float t = v[0] + v[NCH - 1];
      for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
#pragma unroll
      for (int k = 0; k < NCH; ++k) v[k] = t;
      return;
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    return;
  }
  for (int off = width / VW / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
}

// value (B, S, C), loc (B, Q, G, L, P, 2) f32, attn (B, Q, H, L, P) f32,
// d_out (B, Q, C) in the value dtype; d_value (B, S, C) f32, zeroed by the
// caller; d_loc (B, Q, G, L, P, 2) f32 and d_attn (B, Q, H, L, P) f32, every
// element written here.  C = 32 * VW * NCH.
template <typename T, int VW, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_backward_kernel(const T* __restrict__ value, const LevelTable levels,
                     const float* __restrict__ loc, const float* __restrict__ attn,
                     const T* __restrict__ d_out, float* __restrict__ d_value,
                     float* __restrict__ d_loc, float* __restrict__ d_attn, int B, int S,
                     int Q, int H, int G, int P) {
  constexpr int C = 32 * VW * NCH;
  const int64_t bq = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (bq >= static_cast<int64_t>(B) * Q) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int L = levels.num_levels;
  const int LP = L * P;
  const int b = static_cast<int>(bq / Q);
  const int D = C / H, CG = C / G;  // channels of a head, of a location group

  int c0[NCH], h[NCH], g[NCH];
  float go[NCH][VW];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    c0[k] = k * 32 * VW + lane * VW;
    h[k] = c0[k] / D;
    g[k] = c0[k] / CG;
    load_chunk<T, VW>(d_out + bq * C + c0[k], go[k]);
  }
  const int64_t batch_offset = static_cast<int64_t>(b) * S * C;
  const T* value_b = value + batch_offset;
  float* d_value_b = d_value + batch_offset;

  for (int l = 0; l < L; ++l) {
    const int lh = levels.h[l], lw = levels.w[l], ls = levels.start[l];
    for (int p = 0; p < P; ++p) {
      float s[NCH], gx[NCH], gy[NCH];  // this lane's partial sums, per chunk
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const float2 xy =
            __ldg(reinterpret_cast<const float2*>(loc) + (bq * G + g[k]) * LP + l * P + p);
        const float a = __ldg(attn + (bq * H + h[k]) * LP + l * P + p);
        const Bilinear pt = bilinear(xy, lh, lw);
        s[k] = gx[k] = gy[k] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int cy = pt.y0 + dy;
          if (cy < 0 || cy >= lh) continue;
          const float wy = dy ? pt.fy : 1.f - pt.fy;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int cx = pt.x0 + dx;
            if (cx < 0 || cx >= lw) continue;
            const float wx = dx ? pt.fx : 1.f - pt.fx;
            const int64_t row = static_cast<int64_t>(ls + cy * lw + cx) * C + c0[k];
            float v[VW];
            load_chunk<T, VW>(value_b + row, v);
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < VW; ++i) dot = fmaf(go[k][i], v[i], dot);
            s[k] = fmaf(wx * wy, dot, s[k]);
            gx[k] = fmaf(dx ? wy : -wy, dot, gx[k]);
            gy[k] = fmaf(dy ? wx : -wx, dot, gy[k]);
            const float aw = a * (wx * wy);
            if (aw != 0.f) {  // adding +-0 changes nothing
              float add[VW];
#pragma unroll
              for (int i = 0; i < VW; ++i) add[i] = aw * go[k][i];
              red_add<VW>(d_value_b + row, add);
            }
          }
        }
        gx[k] *= a;
        gy[k] *= a;
      }
      // every lane reaches the shuffles: the loops above are warp-uniform
      group_sum<VW, NCH>(s, D);
      group_sum<VW, NCH>(gx, CG);
      group_sum<VW, NCH>(gy, CG);
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (c0[k] % D == 0) d_attn[(bq * H + h[k]) * LP + l * P + p] = s[k];
        if (c0[k] % CG == 0)
          reinterpret_cast<float2*>(d_loc)[(bq * G + g[k]) * LP + l * P + p] =
              make_float2(gx[k] * lw, gy[k] * lh);
      }
    }
  }
}

template <typename T, int VW, int NCH>
void launch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
            const void* d_out, void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
            int H, int G, int P, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(B) * Q;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_backward_kernel<T, VW, NCH><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), levels, static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(d_out),
      static_cast<float*>(d_value), static_cast<float*>(d_loc), static_cast<float*>(d_attn), B,
      S, Q, H, G, P);
}

template <typename T>
int dispatch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
             const void* d_out, void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
             int C, int H, int G, int P, cudaStream_t stream) {
  switch (C) {
    case 32:
      launch<T, 1, 1>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                      stream);
      break;
    case 64:
      launch<T, 2, 1>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                      stream);
      break;
    case 256:
      launch<T, 4, 2>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
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
