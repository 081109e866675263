// Greedy NMS keep mask over score-ordered boxes, one thread-block cluster per
// image.
//
// Replaces salience_detr_tpu/ops/nms.py::nms_keep_mask and its
// _greedy_fixpoint: boxes (B, N, 4) xyxy in descending score order -> a
// (B, N) keep mask, where a box is kept iff no better-ranked kept box has an
// IoU above the threshold with it.  The JAX package iterates a fixpoint over
// the dense (N, N) conflict matrix; this kernel computes the same exact
// sequential-greedy result by walking the ranks in order.
//
// What bounds it on an H100: latency, not bytes (B x N x 16 B in, B x N
// out) nor operations (at most N^2 / 2 IoU tests an image).  Two parts: the
// conflict fill (N^2 / 64 ballots of 32 IoU tests an image), which is
// parallel, and the serial walk over the ranks (on an H100 about 18 ns a
// rank reading local shared memory, 50-80 ns reading another block's).  One
// block per image, the earlier design, ran the fill on B of the 132 SMs and
// kept the bitmask in global memory above 1024 boxes.  The conflict test is
// bit-exact with ops/boxes.py's box_iou_pairwise: every area, intersection,
// union and the quotient are rounded as the plain version rounds them (no
// FMA contraction, the max(union, 1e-12) clamp before the divide, NaN
// propagated as torch's maximum/minimum/clamp propagate it), and the test is
// `iou > threshold` in float32.  Identical boxes (IoU exactly 1) are common
// on the post-process path, where one query wins the flat top-k under
// several labels.
//
// What this design does about it:
// * each image is a cluster of C blocks (cudaLaunchKernelEx with a cluster
//   dimension; C up to 8, or 16 as a non-portable size) that share out the
//   rows of the N x ceil(N/32)-word conflict bitmask by 32-rank window,
//   interleaved back and forth: round j of C windows goes to blocks 0 ..
//   C-1 when j is even and C-1 .. 0 when it is odd (window_owner), so that
//   each block's long and short rows of the triangle pair up evenly.  Row i holds the
//   lower-ranked j > i that i would suppress, from word i / 32 on (the words
//   before hold no such j and are neither written nor read).  A warp fills a
//   row: lane b tests iou(i, 32w + b) against box i held in registers, a
//   ballot packs word w, and the row's words are stored 32 at a time, one a
//   lane.  Every block holds the image's boxes and their areas (computed
//   once per box) in shared memory;
// * where the rows live (``rows``):
//   - kLocal, while the whole bitmask fits one block's shared memory beside
//     the boxes (20N + 4N ceil(N/32) + 4 ceil(N/32) bytes, N up to 1,280 in
//     227 KB): the blocks store their row words straight into block 0's
//     shared memory through distributed shared memory
//     (cluster.map_shared_rank), and after one cluster barrier block 0's
//     walk reads only its own shared memory;
//   - kRemote, past that and while a block's own windows fit beside the
//     boxes (20N + 128 ceil(W/C) W + 4W bytes, W = ceil(N/32); N up to
//     3,200 at C = 8, 4,128 at C = 16): each block keeps its rows, and the
//     walk reads the window's row words from the owning block through
//     distributed shared memory.  No block exits while the walk may read it: every thread waits
//     on a final cluster barrier;
//   - kGlobal, beyond: the rows in a global scratch buffer the caller
//     allocates, the boxes read from global memory;
// * one warp of block 0 walks the ranks 32 at a time over a removed-mask in
//   shared memory (one word per 32 ranks, word w owned by lane w % 32): the
//   window's row words are shuffled out independently of the decisions, so
//   each rank's decision is one test and one OR in registers; then each lane
//   ORs the kept ranks' row words into the removed words it owns (32
//   predicated loads in flight together), the next window's own row words
//   load beside them, and the window's keep bits are written as bool.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCluster = 16;

// where the conflict bitmask's rows live
constexpr int kLocal = 0;
constexpr int kRemote = 1;
constexpr int kGlobal = 2;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// box_iou_pairwise(a, b) of ops/boxes.py > threshold, in its order of
// operations.  A zero intersection gives an IoU of +-0 for any union but NaN
// (the clamp keeps it at least 1e-12), so that case skips the division,
// whose zero numerator would take the slow path.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b, float threshold) {
  const float w = max_nan(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h = max_nan(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = max_nan(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  if (inter == 0.0f) return !isnan(uni) && 0.0f > threshold;
  return __fdiv_rn(inter, uni) > threshold;
}

// Dynamic shared memory of one block: the boxes (float4), their areas, the
// removed-mask (W words) and the rows the block holds (kLocal: all N rows,
// used in block 0; kRemote: its ceil(W / C) windows of 32 rows).  kGlobal
// holds only the removed-mask.
inline size_t smem_bytes(int rows, int N, int C) {
  const size_t W = (static_cast<size_t>(N) + 31) / 32;
  if (rows == kGlobal) return 4 * W;
  const size_t held = rows == kLocal ? static_cast<size_t>(N) : 32 * ((W + C - 1) / C);
  return 20 * static_cast<size_t>(N) + 4 * W + 4 * held * W;
}

// The block of a cluster of C that fills window k, the k / C-th window it
// holds: rounds of C windows alternate in direction.
__device__ __forceinline__ int window_owner(int k, int C) {
  const int r = k % C;
  return (k / C) & 1 ? C - 1 - r : r;
}

// boxes (B, N, 4) float32; keep (B, N) bool; scratch (B, N, W) words for
// kGlobal.  Blocks blockIdx.x = image * C + rank.  With fill_only the kernel
// stops after the fill (keep is not written): the fill's share of the time.
template <int Rows>
__global__ void __launch_bounds__(kThreads, 1)
nms_keep_cluster_kernel(const float* __restrict__ boxes, float threshold, uint8_t* __restrict__ keep,
                        unsigned* __restrict__ scratch, int N, int fill_only) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int image = blockIdx.x / C;
  const int W = (N + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* gbox = reinterpret_cast<const float4*>(boxes) + static_cast<int64_t>(image) * N;
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + N);
  unsigned* removed = Rows == kGlobal ? reinterpret_cast<unsigned*>(smem) : reinterpret_cast<unsigned*>(area + N);
  unsigned* mask = removed + W;
  // this block has started (a relaxed arrival: the boxes below are its own);
  // the wait before the fill means every block of the cluster has, so that
  // its shared memory may be written by the others
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (Rows != kGlobal) {
    for (int i = tid; i < N; i += kThreads) {
      const float4 b = gbox[i];
      box[i] = b;
      area[i] = box_area(b);
    }
  }
  for (int w = tid; w < W; w += kThreads) removed[w] = 0u;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  unsigned* block0_mask = Rows == kLocal ? cluster.map_shared_rank(mask, 0) : mask;
  for (int t = warp; t < 32 * ((W + C - 1) / C); t += kWarps) {
    const int kk = t >> 5, k = kk * C + (kk & 1 ? C - 1 - rank : rank);
    const int i = 32 * k + (t & 31);
    if (i >= N) continue;  // warp-uniform
    const float4 a = Rows == kGlobal ? gbox[i] : box[i];
    const float area_a = Rows == kGlobal ? box_area(a) : area[i];
    unsigned* row = Rows == kLocal    ? block0_mask + static_cast<int64_t>(i) * W
                    : Rows == kRemote ? mask + static_cast<int64_t>(t) * W
                                      : scratch + (static_cast<int64_t>(image) * N + i) * W;
    for (int w0 = k; w0 < W; w0 += 32) {  // lane u keeps word w0 + u
      const int nw = min(32, W - w0);
      unsigned mine = 0;
      for (int u = 0; u < nw; ++u) {
        const int j = 32 * (w0 + u) + lane;
        bool hit = false;
        if (j > i && j < N) {
          if (Rows == kGlobal) {
            const float4 b = gbox[j];
            hit = iou_above(a, area_a, b, box_area(b), threshold);
          } else {
            hit = iou_above(a, area_a, box[j], area[j], threshold);
          }
        }
        const unsigned bits = __ballot_sync(kFull, hit);
        if (lane == u) mine = bits;
      }
      if (lane < nw) row[w0 + lane] = mine;
    }
  }
  // every row word is written and visible to the cluster
  cluster.sync();
  if (fill_only || (Rows != kRemote && (rank != 0 || warp != 0))) return;

  if (rank == 0 && warp == 0) {
    // rows of window k: row 32k + b, word w at rows_of(k)[b * W + w]
    auto rows_of = [&](int k) -> const unsigned* {
      if (Rows == kLocal) return mask + static_cast<int64_t>(32 * k) * W;
      if (Rows == kRemote) {
        return cluster.map_shared_rank(mask, window_owner(k, C)) + static_cast<int64_t>(32 * (k / C)) * W;
      }
      return scratch + (static_cast<int64_t>(image) * N + 32 * k) * W;
    };
    uint8_t* out = keep + static_cast<int64_t>(image) * N;
    const unsigned* rows = rows_of(0);
    unsigned own = lane < N ? rows[lane * W] : 0u;  // rank r's row word inside its window
    for (int k = 0; k < W; ++k) {
      const int r = 32 * k + lane;
      // rank b is kept iff bit b of cur is clear when its turn comes; its row
      // word only holds later ranks, so the bit never changes after that
      unsigned cur = removed[k];
      const int n = min(32, N - 32 * k);
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const unsigned word = __shfl_sync(kFull, own, b);
        if (!(cur & 1u << b)) cur |= word;
      }
      unsigned kept = ~cur;
      if (n < 32) kept &= (1u << n) - 1u;
      const unsigned* next = rows;
      if (k + 1 < W) {
        next = rows_of(k + 1);
        own = r + 32 < N ? next[lane * W + k + 1] : 0u;
      }
      // lane owns words k + 1 + lane, + 32, ...: OR in the kept ranks' rows
      for (int w = k + 1 + lane; w < W; w += 32) {
        unsigned acc = 0;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          if (kept >> b & 1u) acc |= rows[b * W + w];
        }
        removed[w] |= acc;
      }
      __syncwarp();
      if (r < N) out[r] = kept >> lane & 1u;
      rows = next;
    }
  }
  // kRemote: no block exits while the walk may still read its rows
  if (Rows == kRemote) cluster.sync();
}

template <int Rows>
int launch(const void* boxes, float threshold, void* keep, void* scratch, int B, int N, int C, int fill_only,
           cudaStream_t stream) {
  auto kernel = nms_keep_cluster_kernel<Rows>;
  const size_t smem = smem_bytes(Rows, N, C);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(B) * C);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = C;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters == 0) return static_cast<int>(cudaErrorInvalidConfiguration);  // the cluster cannot be placed
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(boxes), threshold, static_cast<uint8_t*>(keep),
                           static_cast<unsigned*>(scratch), N, fill_only);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// One launch for B images of N boxes: rows 0 (kLocal), 1 (kRemote) or 2
// (kGlobal, scratch: B x N x ceil(N/32) words of global memory, any
// contents), cluster 1..16 blocks an image.  Returns cudaGetLastError()
// after the launch; cudaErrorInvalidValue for arguments the kernel does not
// take (rows kLocal/kRemote whose shared memory exceeds the card's opt-in
// maximum among them) and cudaErrorInvalidConfiguration when the card can
// place no cluster of this size (cudaOccupancyMaxActiveClusters is 0): the
// launch is refused, never replaced by another.
extern "C" int nms_keep_cluster_forward(const void* boxes, float threshold, void* keep, void* scratch, int B, int N,
                                        int rows, int cluster, int fill_only, void* stream) {
  if (B < 0 || N < 0 || cluster < 1 || cluster > kMaxCluster || rows < kLocal || rows > kGlobal ||
      (rows == kGlobal && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == kLocal) return launch<kLocal>(boxes, threshold, keep, scratch, B, N, cluster, fill_only, s);
  if (rows == kRemote) return launch<kRemote>(boxes, threshold, keep, scratch, B, N, cluster, fill_only, s);
  return launch<kGlobal>(boxes, threshold, keep, scratch, B, N, cluster, fill_only, s);
}
