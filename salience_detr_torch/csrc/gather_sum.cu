// K5: unweighted sum of gathered per-head rows, the stage kernel of the
// gather-strategy experiment.
//
// Replaces tools/bench_gather.py gather_c (its Pallas kernel, `kernel`): for
// each batch b, head h and query q, out[b, h, q] = sum_g value[b, idx[b, h,
// q, g], h, :], G rows of D channels summed in f32 and stored in bf16.
//
// What bounds it on an H100: gathered rows.  At the experiment's shape
// (B=4, H=8, Q=11403, G=64, D=32) it reads 23.4M rows of 64 B, 1.49 GB of row
// reads, from a 45.7 MB value tensor.  The TPU kernel staged one head's
// (S, D) slice in VMEM; here that slice is 1.43 MB at S=22323, far over the
// 227 KB of shared memory a block can use, while the whole value tensor fits
// the 50 MB L2.  So nothing is staged: rows are read straight from global
// memory and hit in L2.
//
// What the design does about it: value is read in its (B, S, H, D) layout (no
// head-major copy).  A 64 B row (D = 32) is read by 4 lanes of 16 B each, so
// one warp instruction fetches 8 rows of one (b, h, q) at once; the warp's 8
// lane groups accumulate their rows in f32 registers and are summed with
// shuffles at the end.  Indices are loaded 32 at a time, coalesced, and
// broadcast by shuffle.  An index outside [0, S) is skipped, never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "msda_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kHeadDim = 32;                    // channels of a head row, D
constexpr int kLanesPerRow = kHeadDim / 8;       // 8 bf16 (16 B) per lane
constexpr int kRowsPerLoad = 32 / kLanesPerRow;  // rows per warp instruction

// value (B, S, H, D) bf16, idx (B, H, Q, G) int32, out (B, H, Q, D) bf16; one
// warp per (b, h, q).  Lane `lane` reads channels [8 * part, 8 * part + 8) of
// the rows at slots slot, slot + kRowsPerLoad, ... of each 32-index window.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_sum_kernel(const __nv_bfloat16* __restrict__ value, const int* __restrict__ idx,
                  __nv_bfloat16* __restrict__ out, int B, int S, int H, int Q, int G) {
  const int64_t bhq = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (bhq >= static_cast<int64_t>(B) * H * Q) return;
  const int lane = threadIdx.x & 31;
  const int part = lane % kLanesPerRow, slot = lane / kLanesPerRow;
  const int64_t bh = bhq / Q;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const int* idx_q = idx + bhq * G;
  const __nv_bfloat16* rows = value + (static_cast<int64_t>(b) * S * H + h) * kHeadDim + part * 8;
  const int64_t row_stride = static_cast<int64_t>(H) * kHeadDim;

  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int n = min(32, G - g0);
    const int mine = lane < n ? __ldg(idx_q + g0 + lane) : -1;
#pragma unroll
    for (int r = 0; r < 32; r += kRowsPerLoad) {
      const int s = __shfl_sync(kFullMask, mine, r + slot);
      if (r + slot < n && s >= 0 && s < S) {
        float v[8];
        load_chunk<__nv_bfloat16, 8>(rows + s * row_stride, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] += v[e];
      }
    }
  }
#pragma unroll
  for (int off = kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(kFullMask, acc[e], off);
  }
  if (slot == 0) store_chunk<__nv_bfloat16, 8>(out + bhq * kHeadDim + part * 8, acc);
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first):
// D must be 32.
extern "C" int gather_sum(const void* value, const void* idx, void* out, int B, int S, int H,
                          int head_dim, int Q, int G, void* stream) {
  if (head_dim != kHeadDim || B < 0 || S <= 0 || H <= 0 || Q < 0 || G < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t warps = static_cast<int64_t>(B) * H * Q;
  if (warps == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gather_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(value), static_cast<const int*>(idx),
      static_cast<__nv_bfloat16*>(out), B, S, H, Q, G);
  return static_cast<int>(cudaGetLastError());
}
