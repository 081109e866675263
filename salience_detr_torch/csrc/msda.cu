// Multi-scale deformable attention forward (MSDA), one kernel for every
// location-group count G.
//
// Replaces, in salience_detr_tpu/ops/deform_attn.py:
//   * ms_deform_attn_core_shared (G = 1, head-shared locations: the encoder)
//   * ms_deform_attn_core_quad / ms_deform_attn_core (G = H, exact per-head
//     locations: the decoder)
// and computes in one pass what the Pallas stage kernels of tools/ computed
// apart: the corner gather (bench_gather.py gather_c), the bilinear corner
// collapse (bench_msda2.py _pl_blk_sampled / _pl_nat_sampled, bench_msda5.py)
// and the per-head weighted reduce (bench_msda2.py pallas_reduce,
// bench_msda3.py make_reduce).
//
// Semantics: grid_sample with align_corners=False and zero padding.  For each
// (b, q), head h uses location group g = h * G / H; for each level l and point
// p, x = loc_x * w_l - 0.5, y = loc_y * h_l - 0.5, the four corners come from
// floor(x), floor(y), and a corner outside its level gets weight 0 and is
// never read.  out[b, q, h*D:(h+1)*D] = sum_{l,p,corner} attn[b,q,h,l,p] *
// corner_weight * value[b, corner_token, h*D:(h+1)*D], accumulated in f32 and
// stored in the value dtype.
//
// What bounds it on an H100: gathers.  At the flagship's first encoder layer
// (B=4, Q=11403, L=P=4, C=256, bf16) every query reads 64 corner rows of
// 512 B, about 1.5 GB of row reads from a 45.7 MB value tensor; the tensor
// almost fits the 50 MB L2, so the reads are L2 hits at L2 bandwidth and the
// arithmetic (2 flops per byte read) is negligible.
//
// What this simple design does about it: one warp per (b, q) with the lanes
// over channels, so each corner row is read as one coalesced 512 B request
// (16 B per lane in bf16) and, for G = 1, one row read serves all heads.
// Nothing is staged in shared memory and no intermediate leaves registers:
// the gathered rows are consumed as they arrive, which is what the TPU stage
// kernels could not do across their separate passes.  Two redesigns were
// measured against it on the train step's own inputs and lost (PERF.md):
// one block per (image, head, query tile) with the head's slice of
// the coarse levels staged in shared memory (1.9x slower on the encoder's
// inputs), and this layout with each point's four corner loads issued
// together (15% slower there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"
#include "msda_common.cuh"

namespace {

// value (B, S, C), loc (B, Q, G, L, P, 2) f32, attn (B, Q, H, L, P) f32,
// out (B, Q, C).  Lane `lane` of the warp for (b, q) owns channels
// [lane * CPL, (lane + 1) * CPL), which lie in one head (D % CPL == 0).
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_forward_kernel(const T* __restrict__ value, const LevelTable levels,
                    const float* __restrict__ loc, const float* __restrict__ attn,
                    T* __restrict__ out, int B, int S, int Q, int H, int G, int P) {
  const int64_t bq = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (bq >= static_cast<int64_t>(B) * Q) return;
  const int lane = threadIdx.x & 31;
  const int C = 32 * CPL;
  const int L = levels.num_levels;
  const int b = static_cast<int>(bq / Q);
  const int c0 = lane * CPL;
  const int h = c0 / (C / H);
  const int g = h * G / H;

  const float* loc_q = loc + ((bq * G + g) * L) * P * 2;
  const float* attn_q = attn + ((bq * H + h) * L) * P;
  const T* value_b = value + static_cast<int64_t>(b) * S * C + c0;

  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int lh = levels.h[l], lw = levels.w[l], ls = levels.start[l];
    // unrolled (P = 4 in every configuration) so that the next points'
    // loads can issue before this point's sums
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + l * P + p);
      const float a = __ldg(attn_q + l * P + p);
      // clamping to [-2, size + 1] changes no corner's validity and keeps the
      // float -> int conversion defined for far-away points
      const float x = fminf(fmaxf(pixel_coord(xy.x, lw), -2.f), lw + 1.f);
      const float y = fminf(fmaxf(pixel_coord(xy.y, lh), -2.f), lh + 1.f);
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = x - x0f, fy = y - y0f;
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        if (cy < 0 || cy >= lh) continue;
        const float wy = dy ? fy : 1.f - fy;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          if (cx < 0 || cx >= lw) continue;
          const float wgt = a * (wy * (dx ? fx : 1.f - fx));
          float v[CPL];
          load_chunk<T, CPL>(value_b + static_cast<int64_t>(ls + cy * lw + cx) * C, v);
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[i] = fmaf(wgt, v[i], acc[i]);
        }
      }
    }
  }
  store_chunk<T, CPL>(out + bq * C + c0, acc);
}

template <typename T, int CPL>
void launch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
            void* out, int B, int S, int Q, int H, int G, int P, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(B) * Q;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_forward_kernel<T, CPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), levels, static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<T*>(out), B, S, Q, H, G, P);
}

template <typename T>
int dispatch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
             void* out, int B, int S, int Q, int C, int H, int G, int P,
             cudaStream_t stream) {
  switch (C / 32) {
    case 1: launch<T, 1>(value, levels, loc, attn, out, B, S, Q, H, G, P, stream); break;
    case 2: launch<T, 2>(value, levels, loc, attn, out, B, S, Q, H, G, P, stream); break;
    case 8: launch<T, 8>(value, levels, loc, attn, out, B, S, Q, H, G, P, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int msda_forward(const void* value, int value_is_bf16, LevelTable levels,
                            const void* loc, const void* attn, void* out, int B, int S,
                            int Q, int C, int H, int G, int P, void* stream) {
  if (!shapes_ok(levels, S, C, H, G)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16) {
    return dispatch<__nv_bfloat16>(value, levels, loc, attn, out, B, S, Q, C, H, G, P, s);
  }
  return dispatch<float>(value, levels, loc, attn, out, B, S, Q, C, H, G, P, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
