// Batched exact min-cost assignment of padded ground truths to queries.
//
// Replaces salience_detr_tpu/ops/hungarian.py::hungarian_assignment (:36)
// vmapped by batched_assignment (:106): successive shortest augmenting paths
// with Bellman-Ford relaxation, one dense (N x M) min-reduction per round.
// Any exact algorithm gives the same matching wherever the optimum is
// unique; this one is the shortest-augmenting-path method with potentials
// (the Jonker-Volgenant family scipy's linear_sum_assignment belongs to),
// whose every augmentation is a Dijkstra sweep, with scipy's (Crouse's)
// lazy potentials: the distances are not shifted after each step, and the
// scanned rows' and columns' potentials are updated once per augmentation.
//
// Contract: cost_t (B, M, ld) f32, the (B, N queries, M gts) cost transposed
// so that one gt's costs over the queries are contiguous, each row padded to
// ld >= N floats, a multiple of 4 (16 bytes, for the bulk copies below);
// valid (B, M) uint8; out (B, M) int32, the query matched to each valid gt
// and -1 for padded gts.  Requires M <= N <= 32 * kThreads.  The images are
// independent problems, so a caller batches all its matchings into one
// launch (the criterion stacks a train step's seven sets).  An image whose
// costs leave some gt no finite path (NaN or inf costs, as from a diverged
// model) stops and reports -1 for all its gts; the other images of the
// launch are solved as usual.
//
// What bounds it on an H100: latency.  Each image is a chain of Dijkstra
// steps, each a relaxation of the N columns through one cost row followed by
// an argmin over the block whose result picks the next row; the work per
// step is a few columns per thread, so the time is the number of steps
// times one step's latency.  Bandwidth is irrelevant (one image's costs are
// 360 KB at the flagship).
//
// What this design does about it:
// * one block per image, so a launch of the whole step's 7 x 4 images runs
//   them on 28 SMs at once, in the time of its slowest image;
// * the image's valid cost rows are staged in shared memory by bulk copies
//   (one per row, issued by one thread at the start, each completing on its
//   own mbarrier) that land while the first augmentations run; a step then
//   reads its row from shared memory, not through an L2 load whose address
//   depends on the previous step's argmin.  Rows past the shared-memory
//   budget (more than about 60 gts at N = 900) are read from device memory;
// * each thread owns the columns j = tid + c * kThreads and keeps their
//   potentials, distances, scanned flags and path links in registers, so a
//   step has exactly one block barrier: the argmin.  Each warp reduces its
//   (distance, column) pairs with three redux instructions on a 64-bit key
//   that orders like the f64 distance; the warps' results go to one of two
//   alternating slots in shared memory, and after the barrier every thread
//   reduces the kWarps slots itself;
// * the lazy potentials leave no per-step update pass, and an augmentation
//   of one step (the row's closest query is free, the common case) is
//   matched by the thread that owns the query, without a barrier.
// Potentials and distances are f64, so that f32 costs are compared exactly
// and ties resolve as they would in exact arithmetic, lowest query index
// first.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a block may take on sm_90 (227 KB), less 1 KB for
// the static variables
constexpr size_t kSmemBudget = 227 * 1024 - 1024;
constexpr unsigned long long kSign = 1ull << 63;
constexpr unsigned long long kInfKey = 0xfff0000000000000ull;  // key of +inf

struct Partial {
  unsigned long long key;
  unsigned j;
  unsigned pad;
};

// A 64-bit key that orders like the double; -0 is folded into +0 first.
__device__ __forceinline__ unsigned long long order_key(double x) {
  const unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(x + 0.0));
  return (b & kSign) ? ~b : (b | kSign);
}

__device__ __forceinline__ double key_value(unsigned long long k) {
  return __longlong_as_double(static_cast<long long>((k & kSign) ? (k & ~kSign) : ~k));
}

// The lowest key of the warp and, among the lanes that hold it, the lowest column.
__device__ __forceinline__ void warp_argmin(unsigned long long& key, unsigned& j) {
  const unsigned hi = static_cast<unsigned>(key >> 32), lo = static_cast<unsigned>(key);
  const unsigned min_hi = __reduce_min_sync(kFull, hi);
  const unsigned min_lo = __reduce_min_sync(kFull, hi == min_hi ? lo : 0xffffffffu);
  j = __reduce_min_sync(kFull, hi == min_hi && lo == min_lo ? j : 0xffffffffu);
  key = static_cast<unsigned long long>(min_hi) << 32 | min_lo;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// One bulk copy of ``bytes`` from device to shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the first phase of ``bar`` (the copy's arrival) to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Relax this thread's unscanned columns through one cost row and keep the
// closest: d[j] = min(d[j], base + cost[j] - v[j]).
template <int kCols>
__device__ __forceinline__ void relax(const float* row, bool in_smem, double base, int i, int N,
                                      unsigned scanned, const double (&v)[kCols], double (&d)[kCols],
                                      int (&from)[kCols], unsigned long long& key, unsigned& jbest) {
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = threadIdx.x + c * kThreads;
    if (j < N && !(scanned >> c & 1u)) {
      const float cost = in_smem ? row[j] : __ldg(row + j);
      const double r = base + static_cast<double>(cost) - v[c];
      if (r < d[c]) {
        d[c] = r;
        from[c] = i;
      }
      const unsigned long long k = order_key(d[c]);
      if (k < key) {  // columns rise with c: the lowest one wins a tie
        key = k;
        jbest = j;
      }
    }
  }
}

// kCols: columns per thread, N <= kCols * kThreads.  Dynamic shared memory:
// the staged rows (cap x ld f32), then u (M f64), the rows' mbarriers (cap),
// the argmin slots (2 x kWarps), row4col and path (N int32 each), col4row
// and gt_of_row (M int32 each).
template <int kCols>
__global__ void __launch_bounds__(kThreads, 1)
hungarian_kernel(const float* __restrict__ cost_t, const uint8_t* __restrict__ valid,
                 int* __restrict__ out, int N, int M, int ld, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);
  double* u = reinterpret_cast<double*>(rows + static_cast<size_t>(cap) * ld);  // row potentials
  uint64_t* arrived = reinterpret_cast<uint64_t*>(u + M);
  Partial* slots = reinterpret_cast<Partial*>(arrived + cap);
  int* row4col = reinterpret_cast<int*>(slots + 2 * kWarps);  // row matched to each query, -1 if free
  int* path = row4col + N;        // row through which each scanned column was reached
  int* col4row = path + N;        // query matched to each row
  int* gt_of_row = col4row + M;   // rows are the valid gts in index order
  __shared__ int n_rows_shared;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* cost_b = cost_t + static_cast<int64_t>(blockIdx.x) * M * ld;
  const uint8_t* valid_b = valid + static_cast<int64_t>(blockIdx.x) * M;
  int* out_b = out + static_cast<int64_t>(blockIdx.x) * M;

  for (int k = tid; k < M; k += kThreads) {
    out_b[k] = -1;
    u[k] = 0.0;
    col4row[k] = -1;
  }
  for (int j = tid; j < N; j += kThreads) row4col[j] = -1;
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < M; base += 32) {
      const int k = base + lane;
      const bool ok = k < M && valid_b[k];
      const unsigned mask = __ballot_sync(kFull, ok);
      if (ok) gt_of_row[n + __popc(mask & ((1u << lane) - 1))] = k;
      n += __popc(mask);
    }
    if (lane == 0) n_rows_shared = n;
  }
  __syncthreads();
  const int n_rows = n_rows_shared;
  const int n_staged = min(n_rows, cap);
  if (tid == 0) {
    for (int r = 0; r < n_staged; ++r) mbar_init(arrived + r);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const unsigned bytes = static_cast<unsigned>(ld) * sizeof(float);
    for (int r = 0; r < n_staged; ++r)
      bulk_load(rows + static_cast<size_t>(r) * ld, cost_b + static_cast<int64_t>(gt_of_row[r]) * ld, bytes,
                arrived + r);
  }
  __syncthreads();

  double v[kCols], d[kCols];  // column potentials, distances of this augmentation
  int from[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = 0.0;
  unsigned step = 0;
  bool reachable = true;
  int cur = 0;
  for (; cur < n_rows; ++cur) {
    // row cur is first read now; rows below it were waited for before
    if (cur < n_staged) mbar_wait(arrived + cur);
#pragma unroll
    for (int c = 0; c < kCols; ++c) d[c] = __longlong_as_double(0x7ff0000000000000ll);
    unsigned scanned = 0;
    double min_val = 0.0;
    int i = cur, sink = -1, path_len = 0;
    while (true) {
      // one Dijkstra step from row i
      unsigned long long key = ~0ull;
      unsigned jbest = 0xffffffffu;
      const double base = min_val - u[i];
      if (i < n_staged)
        relax<kCols>(rows + static_cast<size_t>(i) * ld, true, base, i, N, scanned, v, d, from, key, jbest);
      else
        relax<kCols>(cost_b + static_cast<int64_t>(gt_of_row[i]) * ld, false, base, i, N, scanned, v, d, from,
                     key, jbest);
      warp_argmin(key, jbest);
      Partial* slot = slots + (step++ & 1) * kWarps;
      if (lane == 0) slot[warp] = Partial{key, jbest, 0};
      __syncthreads();
      key = slot[0].key;
      jbest = slot[0].j;
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const Partial p = slot[w];
        if (p.key < key || (p.key == key && p.j < jbest)) {
          key = p.key;
          jbest = p.j;
        }
      }
      // no column left at a finite distance (NaN or inf costs): the same
      // decision in every thread
      if (key >= kInfKey) {
        reachable = false;
        break;
      }
      min_val = key_value(key);
      ++path_len;
      if (static_cast<int>(jbest % kThreads) == tid) scanned |= 1u << (jbest / kThreads);
      const int r4 = row4col[jbest];
      if (r4 < 0) {  // a free query: the path is complete
        sink = static_cast<int>(jbest);
        break;
      }
      i = r4;
    }
    if (!reachable) break;
    if (path_len == 1) {
      // row cur's closest query is free: only u[cur] moves (the sink's
      // delta is 0), and the match needs no barrier, since the other threads
      // read row4col only after the next step's barrier
      if (sink % kThreads == tid) {
        row4col[sink] = cur;
        col4row[cur] = sink;
        u[cur] += min_val;
      }
      continue;
    }
    // the scanned columns' and rows' potentials, and the path links; the
    // scanned columns other than the sink are matched to distinct rows
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (scanned >> c & 1u) {
        const int j = tid + c * kThreads;
        const double delta = min_val - d[c];
        v[c] -= delta;
        if (j != sink) u[row4col[j]] += delta;
        path[j] = from[c];
      }
    }
    if (tid == 0) u[cur] += min_val;
    __syncthreads();
    // augment along the path back to row cur; the other threads read
    // row4col again only after the next step's barrier
    if (tid == 0) {
      int j = sink;
      while (true) {
        const int r = path[j];
        row4col[j] = r;
        const int next = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = next;
      }
    }
  }
  if (!reachable) {
    // the image keeps -1 for every gt; the rows still in flight must land
    // before the block exits
    for (int r = cur + 1; r < n_staged; ++r) mbar_wait(arrived + r);
    return;
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads)
    if (row4col[j] >= 0) out_b[gt_of_row[row4col[j]]] = j;
}

template <int kCols>
int launch(const void* cost_t, const void* valid, void* out, int B, int N, int M, int ld, int cap,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hungarian_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hungarian_kernel<kCols><<<B, kThreads, smem, stream>>>(
      static_cast<const float*>(cost_t), static_cast<const uint8_t*>(valid), static_cast<int*>(out), N, M,
      ld, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int assignment_forward(const void* cost_t, const void* valid, void* out, int B, int N, int M,
                                  int ld, void* stream) {
  if (N <= 0 || M < 0 || M > N || N > 32 * kThreads || ld < N || ld % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || M == 0) return static_cast<int>(cudaSuccess);
  // everything but the staged rows, then as many rows as fit (each with its mbarrier)
  const size_t fixed = static_cast<size_t>(M) * (sizeof(double) + 2 * sizeof(int)) +
                       2 * kWarps * sizeof(Partial) + 2 * static_cast<size_t>(N) * sizeof(int);
  const size_t per_row = static_cast<size_t>(ld) * sizeof(float) + sizeof(uint64_t);
  const int cap = static_cast<int>(std::min<size_t>(M, (kSmemBudget - fixed) / per_row));
  const size_t smem = fixed + cap * per_row;
  const int cols = (N + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols <= 4) return launch<4>(cost_t, valid, out, B, N, M, ld, cap, smem, s);
  if (cols <= 8) return launch<8>(cost_t, valid, out, B, N, M, ld, cap, smem, s);
  if (cols <= 16) return launch<16>(cost_t, valid, out, B, N, M, ld, cap, smem, s);
  return launch<32>(cost_t, valid, out, B, N, M, ld, cap, smem, s);
}
