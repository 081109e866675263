// K7 and K8: the bilinear corner collapse of pre-gathered corner rows, one
// template over where an item's four corner rows sit.
//
// Replaces the Pallas corner-collapse kernels of the MSDA shootout:
//   * K7, corner-blocked rows: tools/bench_msda2.py _pl_blk_sampled (kernel
//     _make_blk_kernel), used by pl_blk and pl_blk_bf16.  Groups of 4 * blk
//     rows hold blk items' corner-0 rows, then their corner-1, -2 and -3 rows
//     (the permutation of _corner_blocked), so item j of group gi has its
//     corners blk rows apart.  out = (g0*w0 + g1*w1) + (g2*w2 + g3*w3).
//   * K8, packed rows: tools/bench_msda2.py _pl_nat_sampled (kernel
//     _make_nat_kernel), used by pl_nat and pl_nat_bf16; the same kernel
//     alone on pre-gathered rows, tools/bench_msda5.py main.kern; and its 2-D
//     block form with bf16 weights, tools/bench_msda5.py extra_probes.kern2d.
//     An item's four C-wide corner rows lie side by side in one 4C row.
//     out = ((g0*w0 + g1*w1) + g2*w2) + g3*w3.
// Each product is rounded to f32 and the sums are taken in the Pallas
// kernel's order without fused multiply-adds, so the f32 value is the one the
// Pallas kernel and the plain PyTorch version compute, and a bf16 output
// rounds that same value.  Weights are f32 or bf16 (widened to f32), the
// output f32 or bf16.
//
// What bounds it on an H100: streaming bytes.  At the hot layer (B = 4,
// Q = 11403, L = P = 4: 729,792 items, C = 256) it reads 1.49 GB of bf16 rows
// and writes 0.75 GB of f32 or 0.37 GB of bf16, a floor of about 0.67 ms or
// 0.56 ms at 3.35 TB/s.
//
// What the design does about it: one warp per item, lanes over the channels 8
// at a time, so each corner row is one coalesced 512 B read (16 B per lane)
// and the output row one coalesced write; the four corner reads are
// independent and in flight together.  The items past n_items (the padding
// of the corner-blocked layout's last group) are neither read nor written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_common.cuh"

namespace {

// g: corner rows of C bf16 channels; w: one weight per corner row, in the
// layout of g's rows; out (n_items, C).  kBlocked: item j of group gi has
// corner k at row gi * 4 * blk + k * blk + j of a (rows, C) array.  Packed:
// item n has corner k at row n, columns [k * C, (k + 1) * C) of an
// (n_items, 4C) array, and its weights at w[4n + k].
template <bool kBlocked, typename W, typename O>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
corner_collapse_kernel(const __nv_bfloat16* __restrict__ g, const W* __restrict__ w,
                       O* __restrict__ out, int64_t n_items, int blk, int C) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (item >= n_items) return;
  const int lane = threadIdx.x & 31;
  int64_t row[4];  // element offset of each corner row
  float wk[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int64_t widx;
    if constexpr (kBlocked) {
      const int64_t gi = item / blk, j = item - gi * blk;
      widx = gi * 4 * blk + static_cast<int64_t>(k) * blk + j;
      row[k] = widx * C;
    } else {
      widx = item * 4 + k;
      row[k] = item * 4 * C + static_cast<int64_t>(k) * C;
    }
    wk[k] = to_float(w[widx]);
  }
  for (int c0 = lane * 8; c0 < C; c0 += 256) {
    float v[4][8];
#pragma unroll
    for (int k = 0; k < 4; ++k) load_chunk<__nv_bfloat16, 8>(g + row[k] + c0, v[k]);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float p0 = __fmul_rn(v[0][e], wk[0]), p1 = __fmul_rn(v[1][e], wk[1]);
      const float p2 = __fmul_rn(v[2][e], wk[2]), p3 = __fmul_rn(v[3][e], wk[3]);
      if constexpr (kBlocked) {
        acc[e] = __fadd_rn(__fadd_rn(p0, p1), __fadd_rn(p2, p3));
      } else {
        acc[e] = __fadd_rn(__fadd_rn(__fadd_rn(p0, p1), p2), p3);
      }
    }
    store_chunk<O, 8>(out + item * C + c0, acc);
  }
}

template <bool kBlocked, typename W, typename O>
void launch(const void* g, const void* w, void* out, int64_t n_items, int blk, int C,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  corner_collapse_kernel<kBlocked, W, O><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const W*>(w), static_cast<O*>(out),
      n_items, blk, C);
}

template <bool kBlocked>
int dispatch(const void* g, const void* w, int w_is_bf16, void* out, int out_is_bf16,
             int64_t n_items, int blk, int C, void* stream) {
  if (n_items < 0 || C <= 0 || C % 256 || (kBlocked && blk <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_items == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (w_is_bf16) {
    if (out_is_bf16) launch<kBlocked, bf16, bf16>(g, w, out, n_items, blk, C, s);
    else launch<kBlocked, bf16, float>(g, w, out, n_items, blk, C, s);
  } else {
    if (out_is_bf16) launch<kBlocked, float, bf16>(g, w, out, n_items, blk, C, s);
    else launch<kBlocked, float, float>(g, w, out, n_items, blk, C, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both return cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a shape the kernel does not take (the Python wrappers reject those
// first): C a multiple of 256.
// K7: g (groups, 4 * blk, C), w (groups, 4 * blk), out (n_items, C) with
// n_items <= groups * blk.
extern "C" int corner_collapse_blocked(const void* g, const void* w, int w_is_bf16, void* out,
                                       int out_is_bf16, int64_t n_items, int blk, int C,
                                       void* stream) {
  return dispatch<true>(g, w, w_is_bf16, out, out_is_bf16, n_items, blk, C, stream);
}

// K8: g (n_items, 4C), w (n_items, 4), out (n_items, C).
extern "C" int corner_collapse_packed(const void* g, const void* w, int w_is_bf16, void* out,
                                      int out_is_bf16, int64_t n_items, int C, void* stream) {
  return dispatch<false>(g, w, w_is_bf16, out, out_is_bf16, n_items, 0, C, stream);
}
