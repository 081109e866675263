// Grid NMS over the two-stage proposal tokens, one block per image.
//
// Replaces salience_detr_tpu/ops/nms.py::grid_nms_topk and its
// _greedy_fixpoint.  The reference runs NMS (IoU 0.3) on 2x2 boxes centred on
// the feature-grid cells of the top-K tokens, batched per (image, level); for
// such boxes IoU > 0.3 iff two cells are 4-neighbours on the same level, so
// greedy NMS reduces to: walk the candidates in rank order and keep one iff no
// 4-neighbour on its level is already kept.  The JAX package computes the same
// greedy result as a vectorized fixpoint over dense rank maps; the output is
// bit-exact with it: the first num_out survivors in rank order, then the
// best-ranked suppressed candidates as backfill.
//
// What bounds it on an H100: the walk is sequential (each decision depends on
// all earlier ones) and runs on one thread, so its time is K times the
// latency of one step.  A first version that searched the level and divided
// inside the walk took 1.1-1.3 ms for K = 3600 (about 0.3 us a step).  A
// torch-eager fixpoint instead needs one host synchronisation per
// relaxation round (133-165 ms for the plain version here).
//
// What the simple design does about it: everything the walk needs per
// candidate that does not depend on earlier decisions (its token, its row
// width, which of its 4 neighbours exist) is computed by all threads first
// and staged in shared memory with a byte map of "kept" over all S tokens
// (22,323 bytes at the flagship).  A step of the walk is then 4 independent
// shared-memory loads and a store; no step waits on device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

namespace {

constexpr int kThreads = 256;

// topk (B, K) int32 token indices in descending score order, each in [0, S);
// out (B, num_out) int32.  Dynamic shared memory: 9K + S bytes.
__global__ void __launch_bounds__(kThreads)
grid_nms_kernel(const int* __restrict__ topk, const LevelTable levels, int* __restrict__ out,
                int S, int K, int num_out) {
  extern __shared__ int smem[];
  int* ti = smem;        // K: the candidates' tokens
  int* info = smem + K;  // K: row width << 4 | neighbour bits (1 left, 2 right, 4 up, 8 down)
  unsigned char* kept_map = reinterpret_cast<unsigned char*>(smem + 2 * K);  // S bytes
  unsigned char* keep = kept_map + S;                                         // K bytes
  const int* src = topk + static_cast<int64_t>(blockIdx.x) * K;
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    const int t = src[r];
    int l = 0;
    while (l + 1 < levels.num_levels && t >= levels.start[l + 1]) ++l;
    const int lw = levels.w[l];
    const int sp = t - levels.start[l];
    const int y = sp / lw, x = sp - y * lw;
    ti[r] = t;
    info[r] = lw << 4 | (x > 0) | (x + 1 < lw) << 1 | (y > 0) << 2 | (y + 1 < levels.h[l]) << 3;
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) kept_map[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  for (int r = 0; r < K; ++r) {
    const int t = ti[r], inf = info[r], lw = inf >> 4;
    // a missing neighbour reads the candidate's own (still unset) cell
    const bool hit = kept_map[inf & 1 ? t - 1 : t] | kept_map[inf & 2 ? t + 1 : t] |
                     kept_map[inf & 4 ? t - lw : t] | kept_map[inf & 8 ? t + lw : t];
    keep[r] = !hit;
    if (!hit) kept_map[t] = 1;
  }
  int* o = out + static_cast<int64_t>(blockIdx.x) * num_out;
  int n = 0;
  for (int r = 0; r < K && n < num_out; ++r)
    if (keep[r]) o[n++] = ti[r];
  for (int r = 0; r < K && n < num_out; ++r)
    if (!keep[r]) o[n++] = ti[r];
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int grid_nms_forward(const void* topk, LevelTable levels, void* out, int B, int K,
                                int num_out, void* stream) {
  const int S = level_table_tokens(levels);
  const size_t smem = static_cast<size_t>(S) + 9 * static_cast<size_t>(K);
  if (levels.num_levels <= 0 || levels.num_levels > kLevelsMax || K <= 0 || num_out < 0 ||
      num_out > K || smem > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || num_out == 0) return static_cast<int>(cudaSuccess);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        grid_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  grid_nms_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(topk), levels, static_cast<int*>(out), S, K, num_out);
  return static_cast<int>(cudaGetLastError());
}
