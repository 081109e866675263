// Grid NMS over the two-stage proposal tokens, one block per image.
//
// Replaces salience_detr_tpu/ops/nms.py::grid_nms_topk and its
// _greedy_fixpoint.  The reference runs NMS (IoU 0.3) on 2x2 boxes centred on
// the feature-grid cells of the top-K tokens, batched per (image, level); for
// such boxes IoU > 0.3 iff two cells are 4-neighbours on the same level, so
// greedy NMS reduces to: walk the candidates in rank order and keep one iff no
// 4-neighbour on its level is already kept.  The output is bit-exact with the
// JAX package's fixpoint for any candidate order: the first num_out survivors
// in rank order, then the best-ranked suppressed candidates as backfill.
//
// What bounds it on an H100: the dependency chains.  A candidate is decided
// once its better-ranked 4-neighbours are, so the work is the depth of the
// chains of better-ranked neighbours, not K.  A walk of all K candidates in
// rank order on one thread takes about 80 ns a step on an H100 (0.30 ms for
// K = 3600), although the chains of a random or a served top-K are a few
// candidates deep, and the four levels are independent problems.
//
// What this design does about it:
// * one block of 1024 threads per image; a prologue scatters the candidates'
//   ranks into a 16-bit rank map over the S tokens and, for each candidate,
//   keeps the ranks of its better-ranked 4-neighbours (the rest point at a
//   slot that reads "suppressed");
// * then the fixpoint of the JAX package in parallel rounds, in place: an
//   undecided candidate is suppressed once a better-ranked neighbour is kept
//   and kept once all of them are suppressed; a round is one block barrier,
//   and the rounds end when every candidate is decided;
// * a chain deeper than kMaxRounds (a raster clump needs about 190 rounds, a
//   snake path one per candidate) ends the rounds; one warp then decides
//   the rest in rank order, 32 ranks at a time: the lanes find which of
//   their better-ranked neighbours lie in the window, and the window's
//   decisions follow in registers.  Either way the result is the greedy
//   one; only time differs;
// * the survivors and the backfill go to their output slots by a block-wide
//   prefix count of the kept candidates in rank order.
// Splitting the image's levels over separate blocks would balance poorly
// (level 0 holds three quarters of the tokens) and would need a merge across
// blocks; the rounds already run all levels at once.
//
// Past the shared memory (13K + 2S + 1 bytes: at K = 3600, S above about
// 92k tokens, e.g. the 5-scale levels of a 1344 x 1344 canvas) the same
// kernel keeps the 16-bit rank map in a global scratch buffer of B x S
// (grid_nms_forward_global): the map is written once and read once per
// candidate's neighbours in the prologue, and everything after it reads
// shared memory as before.

#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// rounds before the rest goes to the walk
constexpr int kMaxRounds = 16;
// dynamic shared memory a block may take on sm_90 (227 KB), less 1 KB for
// the static variables
constexpr size_t kSmemBudget = 227 * 1024 - 1024;
constexpr uint8_t kUndecided = 0, kKept = 1, kSuppressed = 2;

// topk (B, K) int32 token indices in descending score order, unique, each in
// [0, S); out (B, num_out) int32.  Dynamic shared memory, 13K + 2S + 1 bytes:
// better (K x 4 uint16), token (K int32), rank (S uint16), status (K + 1
// bytes, slot K always "suppressed").  With kGlobalRank the rank map is the
// block's S entries of rank_scratch (B x S uint16) and the shared memory
// 13K + 1 bytes.
template <bool kGlobalRank>
__global__ void __launch_bounds__(kThreads)
grid_nms_kernel(const int* __restrict__ topk, const LevelTable levels, int* __restrict__ out,
                unsigned short* __restrict__ rank_scratch, int S, int K, int num_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  ushort4* better = reinterpret_cast<ushort4*>(smem);
  int* token = reinterpret_cast<int*>(better + K);
  unsigned short* rank = kGlobalRank ? rank_scratch + static_cast<int64_t>(blockIdx.x) * S
                                     : reinterpret_cast<unsigned short*>(token + K);
  uint8_t* status = kGlobalRank ? reinterpret_cast<uint8_t*>(token + K) : reinterpret_cast<uint8_t*>(rank + S);
  __shared__ int decided_in[3];
  __shared__ int warp_sums[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* src = topk + static_cast<int64_t>(blockIdx.x) * K;
  for (int t = tid; t < S; t += kThreads) rank[t] = static_cast<unsigned short>(K);
  for (int r = tid; r <= K; r += kThreads) status[r] = r < K ? kUndecided : kSuppressed;
  if (tid < 3) decided_in[tid] = 0;
  __syncthreads();
  for (int r = tid; r < K; r += kThreads) {
    const int t = src[r];
    token[r] = t;
    rank[t] = static_cast<unsigned short>(r);
  }
  __syncthreads();
  for (int r = tid; r < K; r += kThreads) {
    const int t = token[r];
    int l = 0;
    while (l + 1 < levels.num_levels && t >= levels.start[l + 1]) ++l;
    const int lw = levels.w[l], sp = t - levels.start[l];
    const int y = sp / lw, x = sp - y * lw;
    // the rank of a better-ranked neighbour candidate, else K
    auto better_rank = [&](bool exists, int t2) -> unsigned short {
      const int r2 = exists ? rank[t2] : K;
      return static_cast<unsigned short>(r2 < r ? r2 : K);
    };
    better[r] = make_ushort4(better_rank(x > 0, t - 1), better_rank(x + 1 < lw, t + 1),
                             better_rank(y > 0, t - lw), better_rank(y + 1 < levels.h[l], t + lw));
  }
  __syncthreads();

  // Parallel rounds.  Statuses only go from undecided to final, so a read
  // that races with a write sees either, and both give a right decision.
  int undecided = K;
  bool walk = false;
  for (int pass = 0; undecided > 0; ++pass) {
    int decided = 0;
    for (int r = tid; r < K; r += kThreads) {
      if (status[r] != kUndecided) continue;
      const ushort4 n = better[r];
      const int s0 = status[n.x], s1 = status[n.y], s2 = status[n.z], s3 = status[n.w];
      if ((s0 | s1 | s2 | s3) & kKept) {
        status[r] = kSuppressed;
        ++decided;
      } else if (s0 & s1 & s2 & s3 & kSuppressed) {
        status[r] = kKept;
        ++decided;
      }
    }
    // three counters in turn: the one read after this barrier, the one
    // zeroed for the next round, and the previous round's, still being read
    if (decided) atomicAdd(&decided_in[pass % 3], decided);
    if (tid == 0) decided_in[(pass + 1) % 3] = 0;
    __syncthreads();
    const int n = decided_in[pass % 3];
    undecided -= n;
    if (undecided > 0 && pass + 1 == kMaxRounds) {
      walk = true;
      break;
    }
  }
  if (walk && warp == 0) {
    // One warp decides the rest in windows of 32 consecutive ranks, lane i
    // on rank base + i.  Every rank below a window is decided, so a lane's
    // better-ranked neighbours are either decided or earlier lanes of the
    // window; each lane keeps the mask of the latter, and the window's
    // decisions follow in lane order from those masks in registers.
    for (int base = 0; base < K; base += 32) {
      const int r = base + lane;
      const int s = r < K ? status[r] : kSuppressed;
      const unsigned open = __ballot_sync(kFull, s == kUndecided);
      if (!open) continue;
      unsigned earlier = 0;
      bool hit = false;  // a kept neighbour below the window
      if (s == kUndecided) {
        const ushort4 n = better[r];
        const int nb[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int b = nb[q];
          if (b >= base && b < K) {
            earlier |= 1u << (b - base);
          } else if (b < base) {
            hit |= status[b] == kKept;
          }
        }
      }
      const unsigned blocked = __ballot_sync(kFull, hit);
      unsigned kept = __ballot_sync(kFull, s == kKept);
      for (int i = 0; i < 32; ++i) {
        const unsigned e = __shfl_sync(kFull, earlier, i);
        if ((open & ~blocked) >> i & 1u && !(e & kept)) kept |= 1u << i;
      }
      if (s == kUndecided) status[r] = kept >> lane & 1u ? kKept : kSuppressed;
      __syncwarp();
    }
  }
  __syncthreads();

  // Each thread owns a run of consecutive ranks; an exclusive prefix count of
  // the kept ones over the block places every survivor, and the suppressed
  // candidate of rank r follows all survivors at r minus the survivors before it.
  const int per = (K + kThreads - 1) / kThreads;
  const int lo = min(K, tid * per), hi = min(K, lo + per);
  int mine = 0;
  for (int r = lo; r < hi; ++r) mine += status[r] == kKept;
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += o;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int total_kept = warp_sums[kWarps - 1];
  int kept_before = (warp > 0 ? warp_sums[warp - 1] : 0) + incl - mine;
  int* o = out + static_cast<int64_t>(blockIdx.x) * num_out;
  for (int r = lo; r < hi; ++r) {
    if (status[r] == kKept) {
      if (kept_before < num_out) o[kept_before] = token[r];
      ++kept_before;
    } else if (total_kept + r - kept_before < num_out) {
      o[total_kept + r - kept_before] = token[r];
    }
  }
}

template <bool kGlobalRank>
int launch(const void* topk, LevelTable levels, void* out, void* rank_scratch, int B, int K, int num_out,
           void* stream) {
  const int S = level_table_tokens(levels);
  const size_t smem = 13 * static_cast<size_t>(K) + 1 + (kGlobalRank ? 0 : 2 * static_cast<size_t>(S));
  if (levels.num_levels <= 0 || levels.num_levels > kLevelsMax || K <= 0 || K > 65535 || num_out < 0 ||
      num_out > K || smem > kSmemBudget || (kGlobalRank && rank_scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || num_out == 0) return static_cast<int>(cudaSuccess);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(grid_nms_kernel<kGlobalRank>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  grid_nms_kernel<kGlobalRank><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(topk), levels, static_cast<int*>(out), static_cast<unsigned short*>(rank_scratch), S,
      K, num_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
// The rank map in shared memory: 13K + 2S + 1 bytes of it.
extern "C" int grid_nms_forward(const void* topk, LevelTable levels, void* out, int B, int K, int num_out,
                                void* stream) {
  return launch<false>(topk, levels, out, nullptr, B, K, num_out, stream);
}

// The rank map in rank_scratch, B x S uint16 of global memory the caller
// allocates (any contents); 13K + 1 bytes of shared memory.
extern "C" int grid_nms_forward_global(const void* topk, LevelTable levels, void* out, void* rank_scratch, int B,
                                       int K, int num_out, void* stream) {
  return launch<true>(topk, levels, out, rank_scratch, B, K, num_out, stream);
}
