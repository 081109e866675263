// K6: weighted reduce of pre-gathered rows with per-(sub-row, head) weights.
//
// Replaces the Pallas weighted-reduce kernels of the MSDA shootout:
//   * tools/bench_msda2.py pallas_reduce (kernel _reduce_kernel), called by
//     quad_pl (K = 4 corners per quad row) and flat_pl (K = P points);
//   * tools/bench_msda3.py make_reduce(QT, I, K, wdtype).run, the same kernel
//     with the query tile, the item and sub-row counts and the weight type as
//     parameters (the query tile has no counterpart here).
// out[n, c] = sum_k sum_i g[n, i, k*C + c] * wt[n, i, k*H + c / D], D = C / H,
// in f32: the sum over the items i per sub-row k first, then the K partial
// sums in order k = 0, 1, ..., as the Pallas kernel adds them.  The TPU kernel
// spread each head's weight over its D lanes by a product with a 0/1
// expansion matrix; that product is exact, so here lane c simply reads the
// weight of its head.  bf16 weights are widened to f32 (on the TPU the
// expansion matrix was bf16 then, and the product exact as well).
//
// What bounds it on an H100: the gathered rows, read once.  At the hot layer
// (N = B*Q = 45612, I = 16, K = 4, C = 256) g is 1.49 GB of bf16, so its floor
// is about 0.45 ms at 3.35 TB/s; the weights (47 MB in f32) and the output
// (47 MB) add little.
//
// What the design does about it: one warp per row n, lanes over the C
// channels 8 at a time, so every 2 KB sub-row of g is read as fully coalesced
// 16 B loads (512 B per warp instruction), and the loop over items is
// unrolled to keep several loads in flight.  Each lane's 8 channels lie in
// one head, so its weight is one broadcast load.  No shared memory, no
// atomics; the ragged tail needs no padding since a warp is a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_common.cuh"

namespace {

// g (N, I, K*C) bf16, wt (N, I, K*H) W, out (N, C) f32; one warp per n.
template <int K, typename W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
weighted_reduce_kernel(const __nv_bfloat16* __restrict__ g, const W* __restrict__ wt,
                       float* __restrict__ out, int64_t N, int I, int C, int H) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (n >= N) return;
  const int lane = threadIdx.x & 31;
  const int D = C / H;
  const __nv_bfloat16* g_n = g + n * I * K * C;
  const W* w_n = wt + n * I * K * H;
  for (int c0 = lane * 8; c0 < C; c0 += 256) {
    const int h = c0 / D;
    float s[K][8];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < 8; ++e) s[k][e] = 0.f;
    }
#pragma unroll 2
    for (int i = 0; i < I; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float w = to_float(w_n[(i * K + k) * H + h]);
        float v[8];
        load_chunk<__nv_bfloat16, 8>(g_n + static_cast<int64_t>(i * K + k) * C + c0, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s[k][e] = fmaf(v[e], w, s[k][e]);
      }
    }
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[e] = s[0][e];
#pragma unroll
      for (int k = 1; k < K; ++k) acc[e] += s[k][e];
    }
    store_chunk<float, 8>(out + n * C + c0, acc);
  }
}

template <int K, typename W>
void launch(const void* g, const void* wt, void* out, int64_t N, int I, int C, int H,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((N + kWarpsPerBlock - 1) / kWarpsPerBlock);
  weighted_reduce_kernel<K, W><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const W*>(wt),
      static_cast<float*>(out), N, I, C, H);
}

template <typename W>
int dispatch(const void* g, const void* wt, void* out, int64_t N, int I, int K, int C, int H,
             cudaStream_t stream) {
  switch (K) {
    case 1: launch<1, W>(g, wt, out, N, I, C, H, stream); break;
    case 2: launch<2, W>(g, wt, out, N, I, C, H, stream); break;
    case 4: launch<4, W>(g, wt, out, N, I, C, H, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first): K
// in {1, 2, 4}, C a multiple of 256, H dividing C with C / H a multiple of 8.
extern "C" int weighted_reduce(const void* g, const void* wt, int wt_is_bf16, void* out,
                               int64_t N, int I, int K, int C, int H, void* stream) {
  if (N < 0 || I < 0 || C <= 0 || C % 256 || H <= 0 || C % H || (C / H) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wt_is_bf16) return dispatch<__nv_bfloat16>(g, wt, out, N, I, K, C, H, s);
  return dispatch<float>(g, wt, out, N, I, K, C, H, s);
}
