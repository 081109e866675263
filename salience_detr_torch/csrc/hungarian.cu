// Batched exact min-cost assignment of padded ground truths to queries.
//
// Replaces salience_detr_tpu/ops/hungarian.py::hungarian_assignment (:36)
// vmapped by batched_assignment (:106): successive shortest augmenting paths
// with Bellman-Ford relaxation, one dense (N x M) min-reduction per round.
// Any exact algorithm gives the same matching wherever the optimum is
// unique; this one is the shortest-augmenting-path method with potentials
// (the Jonker-Volgenant family scipy's linear_sum_assignment belongs to),
// whose every augmentation is a Dijkstra sweep.
//
// Contract: cost_t (B, M, N) f32, the (B, N queries, M gts) cost transposed
// so that one gt's costs over the queries are contiguous; valid (B, M) uint8;
// out (B, M) int32, the query matched to each valid gt and -1 for padded
// gts.  Requires M <= N.  An image whose costs leave some gt no finite path
// (NaN or inf costs, as from a diverged model) stops and reports -1 for all
// its gts, where the augmentation would otherwise follow stale path links
// and might never end.
//
// What bounds it on an H100: latency.  Each image is a sequential chain of
// at most M augmentations, each a sequence of sweeps over the N columns with
// a block-wide argmin between them; the work per sweep (N = 900 columns) is
// a few hundred instructions per thread, so the time is the number of sweeps
// times a block reduction's latency, a few microseconds each.  Bandwidth is
// irrelevant: one image's costs are 360 KB and stay in L2.
//
// What this design does about it: one CTA per image (B CTAs run
// concurrently on separate SMs); all state (potentials, distances, the
// matching, the path) lives in shared memory, so no sweep leaves the SM and
// no host synchronisation happens inside the solve, where the torch-eager
// Bellman-Ford twin syncs the host once per relaxation round.  Potentials
// and distances are f64, so that f32 costs are compared exactly and ties
// resolve as they would in exact arithmetic, lowest query index first.
//
// Rows are the valid gts in index order (1-based, row 0 is the dummy of the
// algorithm), columns the queries (1-based, column 0 the dummy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kInf = 1e300;

struct ArgMin {
  double v;
  int j;
};

__device__ __forceinline__ ArgMin better(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin o;
    o.v = __shfl_xor_sync(0xffffffffu, x.v, off);
    o.j = __shfl_xor_sync(0xffffffffu, x.j, off);
    x = better(x, o);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
hungarian_kernel(const float* __restrict__ cost_t, const uint8_t* __restrict__ valid,
                 int* __restrict__ out, int N, int M) {
  extern __shared__ double smem[];
  double* v = smem;                 // column potentials, N + 1
  double* minv = v + (N + 1);       // tentative distances, N + 1
  double* u = minv + (N + 1);       // row potentials, M + 1
  int* p = reinterpret_cast<int*>(u + (M + 1));  // row matched to column j (0 = free), N + 1
  int* way = p + (N + 1);           // previous column on the shortest path, N + 1
  int* gt_of_row = way + (N + 1);   // M + 1
  uint8_t* used = reinterpret_cast<uint8_t*>(gt_of_row + (M + 1));  // N + 1
  __shared__ ArgMin warp_best[kWarps];
  __shared__ ArgMin best;
  __shared__ int n_rows;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* cost_b = cost_t + static_cast<int64_t>(blockIdx.x) * M * N;
  const uint8_t* valid_b = valid + static_cast<int64_t>(blockIdx.x) * M;
  int* out_b = out + static_cast<int64_t>(blockIdx.x) * M;

  for (int j = tid; j <= N; j += kThreads) {
    v[j] = 0.0;
    p[j] = 0;
    way[j] = 0;
  }
  for (int i = tid; i <= M; i += kThreads) u[i] = 0.0;
  for (int k = tid; k < M; k += kThreads) out_b[k] = -1;
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < M; ++k)
      if (valid_b[k]) gt_of_row[++n] = k;
    n_rows = n;
  }
  __syncthreads();

  bool unreachable = false;  // no finite reduced cost left: NaN or inf costs
  for (int i = 1; i <= n_rows && !unreachable; ++i) {
    for (int j = tid; j <= N; j += kThreads) {
      minv[j] = kInf;
      used[j] = 0;
    }
    if (tid == 0) p[0] = i;
    __syncthreads();
    int j0 = 0;
    while (true) {
      // one Dijkstra step from column j0: relax every unused column through
      // row i0, then pick the closest one
      if (tid == 0) used[j0] = 1;
      __syncthreads();
      const int i0 = p[j0];
      const double u0 = u[i0];
      const float* row = cost_b + static_cast<int64_t>(gt_of_row[i0]) * N;
      ArgMin mine{kInf, N + 1};
      for (int j = tid + 1; j <= N; j += kThreads) {
        if (used[j]) continue;
        const double cur = static_cast<double>(__ldg(row + j - 1)) - u0 - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        mine = better(mine, ArgMin{minv[j], j});
      }
      mine = warp_argmin(mine);
      if (lane == 0) warp_best[warp] = mine;
      __syncthreads();
      if (warp == 0) {
        ArgMin x = lane < kWarps ? warp_best[lane] : ArgMin{kInf, N + 1};
        x = warp_argmin(x);
        if (lane == 0) best = x;
      }
      __syncthreads();
      const double delta = best.v;
      const int j1 = best.j;
      // no column reached at a finite distance (NaN or inf costs): the
      // chosen column's path link would be stale, so stop this image; every
      // block thread reads the same best
      if (!(delta < kInf)) {
        unreachable = true;
        break;
      }
      // shift the potentials so that reduced costs stay >= 0; the rows of
      // the used columns are distinct, so their updates do not collide
      for (int j = tid; j <= N; j += kThreads) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      __syncthreads();
      j0 = j1;
      if (p[j0] == 0) break;  // a free column: the path is complete
    }
    // augment along the path back to the dummy column
    if (tid == 0 && !unreachable) {
      while (j0 != 0) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }
  if (unreachable) return;  // the image keeps -1 for every gt
  for (int j = tid + 1; j <= N; j += kThreads)
    if (p[j] != 0) out_b[gt_of_row[p[j]]] = j - 1;
}

}  // namespace

// Shared memory the kernel needs for N queries and M gt slots.
static size_t hungarian_smem(int N, int M) {
  return static_cast<size_t>(N + 1) * (2 * sizeof(double) + 2 * sizeof(int) + 1) +
         static_cast<size_t>(M + 1) * (sizeof(double) + sizeof(int));
}

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int hungarian_forward(const void* cost_t, const void* valid, void* out, int B, int N,
                                 int M, void* stream) {
  const size_t smem = hungarian_smem(N, M);
  if (N <= 0 || M < 0 || M > N || smem > 200 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || M == 0) return static_cast<int>(cudaSuccess);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hungarian_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hungarian_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost_t), static_cast<const uint8_t*>(valid),
      static_cast<int*>(out), N, M);
  return static_cast<int>(cudaGetLastError());
}
