// Shared by the backward kernels that bin entries by destination row and sum
// each row in a fixed order (deform_conv.cu, msda_backward.cu): the prefix
// sum of counts, which gives each row's list (or each digit value's run) its
// first slot, and the warp's sort that puts a short list in key order.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// internal linkage: each including source gets its own copy
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoKey = INT_MAX;
constexpr int kScanThreads = 1024;  // 32 warps: block_exclusive_scan relies on it
constexpr int kScanPerThread = 4;
constexpr int kScanTile = kScanThreads * kScanPerThread;

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// the exclusive prefix of v over a block of kScanThreads threads; *total
// receives the block's sum
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += n;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int base = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is free for the next call
  return base + incl - v;
}

// scan pass 1: the sum of each tile of kScanTile counts
__global__ void __launch_bounds__(kScanThreads)
scan_sums_kernel(const int* __restrict__ counts, int64_t n, int* __restrict__ sums) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanPerThread;
  int v = 0;
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) v += first + i < n ? counts[first + i] : 0;
  int total;
  block_exclusive_scan(v, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// scan pass 2: each tile adds the sums of the tiles before it and scans its
// counts: offs[r] = the first slot of row r's list; *count_sum, when
// given, receives the sum of all n counts
__global__ void __launch_bounds__(kScanThreads)
scan_offsets_kernel(const int* __restrict__ counts, int64_t n, const int* __restrict__ sums,
                    int* __restrict__ offs, int* __restrict__ count_sum = nullptr) {
  int before = 0;
  for (int j = threadIdx.x; j < static_cast<int>(blockIdx.x); j += kScanThreads) before += sums[j];
  int prefix;
  block_exclusive_scan(before, &prefix);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanPerThread;
  int v[kScanPerThread], mine = 0;
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) {
    v[i] = first + i < n ? counts[first + i] : 0;
    mine += v[i];
  }
  int total;
  int run = prefix + block_exclusive_scan(mine, &total);
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) {
    if (first + i < n) offs[first + i] = run;
    run += v[i];
  }
  if (count_sum != nullptr && first < n && n <= first + kScanPerThread) *count_sum = run;  // this thread holds count n - 1
}

// ascending bitonic sort of the warp's 32 * KPL keys, key j * 32 + lane in
// k[j] of that lane
template <int KPL>
__device__ __forceinline__ void warp_sort(int (&k)[KPL]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32 * KPL; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const bool up = ((j * 32 + lane) & size) == 0;
        if (d >= 32) {
          const int jd = d >> 5;
          if ((j & jd) == 0) {
            const int a = k[j], b = k[j | jd];
            if (up ? a > b : a < b) {
              k[j] = b;
              k[j | jd] = a;
            }
          }
        } else {
          const int other = __shfl_xor_sync(kFull, k[j], d);
          const bool lower = (lane & d) == 0;
          k[j] = lower == up ? min(k[j], other) : max(k[j], other);
        }
      }
    }
  }
}

}  // namespace
