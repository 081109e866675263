// Greedy NMS keep mask over score-ordered boxes, one block per image.
//
// Replaces salience_detr_tpu/ops/nms.py::nms_keep_mask and its
// _greedy_fixpoint: boxes (B, N, 4) xyxy in descending score order -> a
// (B, N) keep mask, where a box is kept iff no better-ranked kept box has an
// IoU above the threshold with it.  The JAX package iterates a fixpoint over
// the dense (N, N) conflict matrix; this kernel computes the same exact
// sequential-greedy result by walking the ranks in order.
//
// What bounds it on an H100: latency, not bytes (B x N x 16 B in, B x N
// out) nor operations (at most N^2 / 2 IoU tests an image): one block per
// image keeps B of the 132 SMs busy.  At B=4, N=300 the conflict fill takes
// about 0.020 ms and the serial walk about 16 ns a rank (measured on an
// H100).  The conflict test is bit-exact with ops/boxes.py's
// box_iou_pairwise: every area, intersection, union and the quotient are
// rounded as the plain version rounds them (no FMA contraction, the
// max(union, 1e-12) clamp before the divide, NaN propagated as torch's
// maximum/minimum/clamp propagate it), and the test is `iou > threshold` in
// float32.  Identical boxes (IoU exactly 1) are common on the post-process
// path, where one query wins the flat top-k under several labels.
//
// What this design does about it:
// * the block's 32 warps fill an N x ceil(N/32) conflict bitmask in shared
//   memory, a warp a row at a time, one 32-bit word per step: lane b tests
//   iou(i, 32w + b) against box i held in registers and a ballot packs the
//   word; row i holds the lower-ranked j > i that i would suppress (words
//   wholly at or below the diagonal are zero, not computed), the areas are
//   computed once per box, and a zero intersection skips the division;
// * one warp walks the ranks 32 at a time with a removed-mask of one word
//   per lane (hence N <= 1024): the window's row words are shuffled out
//   independently of the decisions, so each rank's decision is one test and
//   one OR in registers; then every later lane ORs the kept ranks' row words
//   into its own word (32 predicated loads in flight together), and the
//   window's keep bits are written as bool.
// At N = 300 the mask takes 12 KB of shared memory, at N = 1024 128 KB.
//
// Above 1024 boxes (nms_keep_forward_global) the bitmask, N x ceil(N/32)
// words (512 KB an image at N = 2048), lives in a global scratch buffer the
// caller allocates, and the walk keeps the removed-mask in shared memory,
// word w owned by lane w % 32: each lane holds ceil(N / 1024) words.  The
// fill and the walk are those above, the boxes and their areas read from
// global memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// one 32-bit removed-mask word per lane of the walking warp
constexpr int kMaxBoxes = 1024;

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

// boxes (B, N, 4) float32; keep (B, N) bool.  Dynamic shared memory
// 20N + 4N * ceil(N / 32) bytes: the image's boxes, their areas, the bitmask.
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes, float threshold, uint8_t* __restrict__ keep, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + N);
  unsigned* mask = reinterpret_cast<unsigned*>(area + N);
  const int W = (N + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src = boxes + static_cast<int64_t>(blockIdx.x) * N * 4;
  for (int t = tid; t < 4 * N; t += kThreads) reinterpret_cast<float*>(box)[t] = src[t];
  __syncthreads();
  for (int i = tid; i < N; i += kThreads) area[i] = box_area(box[i]);
  __syncthreads();

  for (int i = warp; i < N; i += kWarps) {
    const float4 a = box[i];
    const float area_a = area[i];
    unsigned* row = mask + i * W;
    const int w0 = i >> 5;  // the words before w0 hold no j > i
    if (lane < w0) row[lane] = 0u;
    for (int w = w0; w < W; ++w) {
      const int j = 32 * w + lane;
      const bool hit = j > i && j < N && iou_above(a, area_a, box[j], area[j], threshold);
      const unsigned bits = __ballot_sync(kFull, hit);
      if (lane == 0) row[w] = bits;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // lane w holds the removed bits of ranks 32w .. 32w + 31
  unsigned removed = 0;
  uint8_t* out = keep + static_cast<int64_t>(blockIdx.x) * N;
  for (int k = 0; k < W; ++k) {
    const int r = 32 * k + lane;
    // rank r's row word inside window k: the ranks of the window it suppresses
    const unsigned own = r < N ? mask[r * W + k] : 0u;
    unsigned cur = __shfl_sync(kFull, removed, k);
    const int n = min(32, N - 32 * k);
    unsigned kept = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const unsigned row = __shfl_sync(kFull, own, b);
      if (!(cur >> b & 1u)) {
        kept |= 1u << b;
        cur |= row;
      }
    }
    if (n < 32) kept &= (1u << n) - 1u;
    if (lane > k && lane < W) {  // predicated loads, all in flight together
      const unsigned* col = mask + 32 * k * W + lane;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if (kept >> b & 1u) removed |= col[b * W];
      }
    }
    if (r < N) out[r] = kept >> lane & 1u;
  }
}

// The same keep mask for any N: mask (B, N, ceil(N/32)) unsigned words of
// global scratch (any contents); dynamic shared memory 4 * ceil(N/32) bytes,
// the removed-mask.
__global__ void __launch_bounds__(kThreads)
nms_keep_global_kernel(const float* __restrict__ boxes, float threshold, uint8_t* __restrict__ keep,
                       unsigned* __restrict__ mask_scratch, int N) {
  extern __shared__ unsigned removed[];
  const int W = (N + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* box = reinterpret_cast<const float4*>(boxes) + static_cast<int64_t>(blockIdx.x) * N;
  unsigned* mask = mask_scratch + static_cast<int64_t>(blockIdx.x) * N * W;
  for (int w = tid; w < W; w += kThreads) removed[w] = 0u;

  for (int i = warp; i < N; i += kWarps) {
    const float4 a = box[i];
    const float area_a = box_area(a);
    unsigned* row = mask + static_cast<int64_t>(i) * W;
    // the words before i / 32 hold no j > i and are never read
    for (int w = i >> 5; w < W; ++w) {
      const int j = 32 * w + lane;
      bool hit = false;
      if (j > i && j < N) {
        const float4 b = box[j];
        hit = iou_above(a, area_a, b, box_area(b), threshold);
      }
      const unsigned bits = __ballot_sync(kFull, hit);
      if (lane == 0) row[w] = bits;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  uint8_t* out = keep + static_cast<int64_t>(blockIdx.x) * N;
  for (int k = 0; k < W; ++k) {
    const int r = 32 * k + lane;
    const unsigned own = r < N ? mask[static_cast<int64_t>(r) * W + k] : 0u;
    unsigned cur = removed[k];
    const int n = min(32, N - 32 * k);
    unsigned kept = 0;
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const unsigned row = __shfl_sync(kFull, own, b);
      if (!(cur >> b & 1u)) {
        kept |= 1u << b;
        cur |= row;
      }
    }
    if (n < 32) kept &= (1u << n) - 1u;
    // lane owns words k + 1 + lane, + 32, ...: OR in the kept ranks' rows
    for (int w = k + 1 + lane; w < W; w += 32) {
      const unsigned* col = mask + static_cast<int64_t>(32 * k) * W + w;
      unsigned acc = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        if (kept >> b & 1u) acc |= col[static_cast<int64_t>(b) * W];
      }
      removed[w] |= acc;
    }
    __syncwarp();
    if (r < N) out[r] = kept >> lane & 1u;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int nms_keep_forward(const void* boxes, float threshold, void* keep, int B, int N, void* stream) {
  if (B < 0 || N < 0 || N > kMaxBoxes) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const size_t words = static_cast<size_t>(N) * ((N + 31) / 32);
  const size_t smem = 20 * static_cast<size_t>(N) + 4 * words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_keep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), threshold, static_cast<uint8_t*>(keep), N);
  return static_cast<int>(cudaGetLastError());
}

// Any N: the bitmask in mask_scratch, B x N x ceil(N/32) unsigned words of
// global memory the caller allocates (any contents).
extern "C" int nms_keep_forward_global(const void* boxes, float threshold, void* keep, void* mask_scratch, int B,
                                       int N, void* stream) {
  if (B < 0 || N < 0 || mask_scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = 4 * static_cast<size_t>((N + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(nms_keep_global_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_keep_global_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), threshold, static_cast<uint8_t*>(keep), static_cast<unsigned*>(mask_scratch),
      N);
  return static_cast<int>(cudaGetLastError());
}
