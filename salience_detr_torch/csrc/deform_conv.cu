// Modulated deformable convolution sampling (DCNv2), forward and backward.
// The forward here writes the columns: the float32 route of the layer
// (then torch.matmul) and the recompute of its backward; the 16-bit forward
// fuses the sampling with its kernel product (deform_conv_gemm.cu).
//
// Replaces salience_detr_tpu/models/bricks/deform_conv.py::_bilinear_sample_map
// (with the mask multiply of DeformConv2dPack, :92-95) and its autodiff.
//
// Semantics (deform_conv_sample_plain and deform_conv_sample_backward_plain
// in ops/deform_conv.py are the spec): x (B, H, W, C) channels-last, offsets
// (B, Ho, Wo, 18) f32 with (dy, dx) interleaved per tap, mask (B, Ho, Wo, 9)
// f32.  Tap k = 3 * (ky + 1) + (kx + 1) of output pixel (ho, wo) samples at
// py = (ho * stride + ky) + dy, px = (wo * stride + kx) + dx in pixel units;
// its 4 bilinear corners outside the image have weight 0 and are neither read
// nor written.  Forward: cols[b, ho, wo, k, :] = mask * sum over corners of
// (wx * wy) * x[corner, :], summed in f32 corner by corner in the order (0,
// 0), (0, 1), (1, 0), (1, 1) without fused multiply-adds, rounded once to x's
// dtype: float32, bfloat16 or float16 (the plain version's arithmetic,
// operation for operation).  Backward,
// with g = d_cols * mask: d_x[corner] += (wx * wy) * g; d_mask = <d_cols,
// sample>; d_offsets (dy, dx) = sum over corners of <g, x[corner]> times d
// (wx * wy) / d (py, px) = (+-wx, +-wy).
//
// What bounds it on an H100: bytes.  At the R50-DCN configuration's stage-2
// layers (B=4, 100x168 outputs, C=128, bf16) the forward writes a 155 MB
// column matrix from a 17-69 MB input (each input pixel is read by up to 36
// corners, mostly from L1/L2); the backward reads that many bytes of d_cols
// and writes d_x, 17-69 MB in x's dtype.
//
// The forward takes one warp per output pixel (b, ho, wo), its lanes holding
// CPL = min(8, C / 32) adjacent channels (looping over C / (32 * CPL)
// chunks), so that every corner row and column row is one coalesced request.
//
// The backward is a pull: each input pixel's d_x row is summed by one warp
// in registers and stored once, in x's dtype, with no atomic add of a float.
// Its (item = (b, ho, wo, tap), corner) entries are binned by destination
// pixel with a counting sort on the device:
//   0-1. zero the counts; count: a thread per item takes each in-image
//      corner's rank in its pixel's list from an int atomic on the pixel's
//      count, and keeps the corner's wx * wy * mask;
//   2. scan: the counts' exclusive prefix sum (two passes of 4096-count
//      tiles) gives each list's first slot;
//   3. place: a thread per item writes its keys (item * 4 + corner) at
//      their slots, without atomics;
//   4. gather: a warp per pixel sorts its list (a bitonic sort in
//      registers up to 128 keys, a selection of the next smallest key beyond
//      that) and takes the entries in key order, 4 rows in flight: d_x +=
//      w * mask * d_cols[item], and the entry's <d_cols[item], x[pixel]>
//      (4 reduced in 6 shuffles) goes to a per-key slot; x's row is read
//      once per pixel;
//   5. combine: a thread per item turns its corners' dot products into
//      d_mask and d_offsets.
// The summation order is the key order whatever ranks the atomics gave, so
// every output is bitwise repeatable.  d_cols is read once per corner (from
// L2 for all but the first corner of a tap), x once per pixel.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "msda_common.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kCorners = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kItemThreads = 256;
constexpr int kScanThreads = 1024;  // 32 warps: block_exclusive_scan relies on it
constexpr int kScanPerThread = 4;
constexpr int kScanTile = kScanThreads * kScanPerThread;
constexpr int kNoKey = INT_MAX;
constexpr int kBatch = 4;  // entries a gather warp takes at a time: 4 rows in flight
// blocks of the gather that must fit an SM: 4 (at most 64 registers a
// thread) where a lane holds 8 channels, which measured faster than 75
// registers; none where fewer registers suffice or more spill
template <int CPL>
constexpr int kGatherMinBlocks = CPL == 8 ? 4 : 1;

// One tap of one output pixel: its corners' top-left (x0, y0), the corner
// weights' factors and the mask.  Clamping the position to [-2, size + 1]
// changes no corner's validity (a clamped tap has no corner in the image)
// and keeps the float -> int conversion defined for far-away taps.
struct Tap {
  int x0, y0;
  float fx, fy, m;
};

__device__ __forceinline__ Tap make_tap(float oy, float ox, float m, int ho, int wo, int k,
                                        int stride, int H, int W) {
  const float py = __fadd_rn(static_cast<float>(ho * stride + k / 3 - 1), oy);
  const float px = __fadd_rn(static_cast<float>(wo * stride + k % 3 - 1), ox);
  const float y = fminf(fmaxf(py, -2.f), H + 1.f);
  const float x = fminf(fmaxf(px, -2.f), W + 1.f);
  const float y0f = floorf(y), x0f = floorf(x);
  return {static_cast<int>(x0f), static_cast<int>(y0f), __fsub_rn(x, x0f), __fsub_rn(y, y0f), m};
}

// item = ((b * Ho + ho) * Wo + wo) * 9 + k; its (dy, dx) offset pair is
// float2 number `item` of offsets, its mask element `item` of mask
__device__ __forceinline__ Tap load_tap(const float* __restrict__ offsets,
                                        const float* __restrict__ mask, int64_t item, int Ho,
                                        int Wo, int stride, int H, int W, int& b) {
  const int64_t pix = item / kTaps;
  const int k = static_cast<int>(item % kTaps);
  const int wo = static_cast<int>(pix % Wo);
  const int ho = static_cast<int>((pix / Wo) % Ho);
  b = static_cast<int>(pix / (static_cast<int64_t>(Wo) * Ho));
  const float2 off = __ldg(reinterpret_cast<const float2*>(offsets) + item);
  return make_tap(off.x, off.y, __ldg(mask + item), ho, wo, k, stride, H, W);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One warp per output pixel (b, ho, wo), its 9 taps in turn: lanes 0-17
// load the pixel's offsets and lanes 0-8 its masks once, and each tap takes
// its three values by shuffles, so the taps' corner loads do not wait on
// their own offset loads and can be in flight together.
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deform_conv_forward_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                           const float* __restrict__ mask, T* __restrict__ cols, int B, int H,
                           int W, int C, int Ho, int Wo, int stride) {
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (pix >= static_cast<int64_t>(B) * Ho * Wo) return;
  const int lane = threadIdx.x & 31;
  const int wo = static_cast<int>(pix % Wo);
  const int ho = static_cast<int>((pix / Wo) % Ho);
  const int b = static_cast<int>(pix / (static_cast<int64_t>(Wo) * Ho));
  const float my_off = lane < 2 * kTaps ? __ldg(offsets + pix * 2 * kTaps + lane) : 0.f;
  const float my_mask = lane < kTaps ? __ldg(mask + pix * kTaps + lane) : 0.f;
  const T* x_b = x + static_cast<int64_t>(b) * H * W * C;

#pragma unroll 3
  for (int k = 0; k < kTaps; ++k) {
    const float oy = __shfl_sync(0xffffffffu, my_off, 2 * k);
    const float ox = __shfl_sync(0xffffffffu, my_off, 2 * k + 1);
    const float m = __shfl_sync(0xffffffffu, my_mask, k);
    const float py = __fadd_rn(static_cast<float>(ho * stride + k / 3 - 1), oy);
    const float px = __fadd_rn(static_cast<float>(wo * stride + k % 3 - 1), ox);
    const float y = fminf(fmaxf(py, -2.f), H + 1.f);
    const float xf = fminf(fmaxf(px, -2.f), W + 1.f);
    const float y0f = floorf(y), x0f = floorf(xf);
    const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
    const float fy = __fsub_rn(y, y0f), fx = __fsub_rn(xf, x0f);
    T* out = cols + (pix * kTaps + k) * C;
    for (int c0 = lane * CPL; c0 < C; c0 += 32 * CPL) {
      float acc[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        if (cy < 0 || cy >= H) continue;
        const float wy = dy ? fy : __fsub_rn(1.f, fy);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          if (cx < 0 || cx >= W) continue;
          const float w = __fmul_rn(dx ? fx : __fsub_rn(1.f, fx), wy);
          float v[CPL];
          load_chunk<T, CPL>(x_b + (static_cast<int64_t>(cy) * W + cx) * C + c0, v);
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, v[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = __fmul_rn(acc[i], m);
      store_chunk<T, CPL>(out + c0, acc);
    }
  }
}

// ---------------------------------------------------------------- backward

__global__ void __launch_bounds__(kItemThreads)
dcn_zero_kernel(int* __restrict__ counts, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kItemThreads + threadIdx.x;
  if (i < n) counts[i] = 0;
}

// 1. count: per in-image corner one count at its pixel, whose old value is
// the corner's rank in the pixel's list, and its weight times the mask, both
// at its key.  The lanes of a warp (neighbouring taps) that count at one
// pixel are served by one atomic of their number, each taking its rank
// among them in lane order.
__global__ void __launch_bounds__(kItemThreads)
dcn_count_kernel(const float* __restrict__ offsets, const float* __restrict__ mask,
                 int* __restrict__ counts, int* __restrict__ rank, float* __restrict__ wcoef,
                 int B, int H, int W, int Ho, int Wo, int stride) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kItemThreads + threadIdx.x;
  const bool live = item < static_cast<int64_t>(B) * Ho * Wo * kTaps;
  const int lane = threadIdx.x & 31;
  int b = 0;
  Tap t{-4, -4, 0.f, 0.f, 0.f};  // no corner in the image
  if (live) t = load_tap(offsets, mask, item, Ho, Wo, stride, H, W, b);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int cy = t.y0 + dy, cx = t.x0 + dx;
      const bool valid = cy >= 0 && cy < H && cx >= 0 && cx < W;
      const unsigned counting = __ballot_sync(kFull, valid);
      if (!valid) continue;
      int* at = counts + (static_cast<int64_t>(b) * H + cy) * W + cx;
      const unsigned peers = __match_any_sync(counting, reinterpret_cast<unsigned long long>(at));
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(at, __popc(peers));
      base = __shfl_sync(peers, base, leader);
      const int64_t key = item * kCorners + 2 * dy + dx;
      rank[key] = base + __popc(peers & ((1u << lane) - 1));
      const float wy = dy ? t.fy : 1.f - t.fy, wx = dx ? t.fx : 1.f - t.fx;
      wcoef[key] = wx * wy * t.m;
    }
  }
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

// 2a. the sum of each tile of kScanTile counts
__global__ void __launch_bounds__(kScanThreads)
dcn_scan_sums_kernel(const int* __restrict__ counts, int64_t n, int* __restrict__ sums) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScanTile + threadIdx.x * kScanPerThread;
  int v = 0;
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) v += first + i < n ? counts[first + i] : 0;
  int total;
  block_exclusive_scan(v, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// 2b. each tile adds the sums of the tiles before it and scans its counts:
// offs[p] = the first slot of pixel p's list
__global__ void __launch_bounds__(kScanThreads)
dcn_scan_offsets_kernel(const int* __restrict__ counts, int64_t n, const int* __restrict__ sums,
                        int* __restrict__ offs) {
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
}

// 3. place: each in-image corner's key at its rank in its pixel's list
__global__ void __launch_bounds__(kItemThreads)
dcn_place_kernel(const float* __restrict__ offsets, const float* __restrict__ mask,
                 const int* __restrict__ offs, const int* __restrict__ rank,
                 int* __restrict__ keys, int B, int H, int W, int Ho, int Wo, int stride) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kItemThreads + threadIdx.x;
  if (item >= static_cast<int64_t>(B) * Ho * Wo * kTaps) return;
  int b;
  const Tap t = load_tap(offsets, mask, item, Ho, Wo, stride, H, W, b);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int cy = t.y0 + dy;
    if (cy < 0 || cy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int cx = t.x0 + dx;
      if (cx < 0 || cx >= W) continue;
      const int64_t key = item * kCorners + 2 * dy + dx;
      keys[__ldg(offs + (static_cast<int64_t>(b) * H + cy) * W + cx) + __ldg(rank + key)] =
          static_cast<int>(key);
    }
  }
}

// the sums over the warp of N = 4 or 8 values: lanes halve the values they
// carry at offsets 16, 8 (and 4), then sum the one left; on return lane
// (32 / N) * e holds the sum of v[e].  6 shuffles for 4 values, 9 for 8.
template <int N>
__device__ __forceinline__ float reduce_n(float (&v)[N], int lane) {
#pragma unroll
  for (int half = N / 2, off = 16; half >= 1; half /= 2, off /= 2) {
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      v[i] = (up ? v[i + half] : v[i]) + __shfl_xor_sync(kFull, send, off);
    }
  }
  float c = v[0];
#pragma unroll
  for (int off = 16 / N; off > 0; off /= 2) c += __shfl_xor_sync(kFull, c, off);
  return c;
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

// The gather's state for one warp: this lane's channels of the pixel's x row
// and of its d_x sum.
template <typename T, int CPL>
struct PixelSum {
  float xv[CPL];
  float acc[CPL];
};

// N entries (keys in ascending order, kNoKey for none; the same on every
// lane): d_x += w * mask * d_cols[item], and <d_cols[item], x[pixel]> over
// this chunk's channels into dots[key].  The rows are loaded before any is
// used, so N are in flight.
template <typename T, int CPL, int N>
__device__ __forceinline__ void take(const int (&key)[N], const T* __restrict__ d_cols,
                                     const float* __restrict__ wcoef, float* __restrict__ dots,
                                     int C, int c0, PixelSum<T, CPL>& s, int lane) {
  float g[N][CPL], wc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (key[e] != kNoKey) {
      wc[e] = __ldg(wcoef + key[e]);
      load_chunk<T, CPL>(d_cols + static_cast<int64_t>(key[e] >> 2) * C + c0, g[e]);
    } else {
      wc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) g[e][i] = 0.f;
    }
  }
  float part[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    part[e] = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      s.acc[i] = fmaf(wc[e], g[e][i], s.acc[i]);
      part[e] = fmaf(g[e][i], s.xv[i], part[e]);
    }
  }
  const float dot = reduce_n<N>(part, lane);
  int mine = kNoKey;  // the key whose sum this lane holds, without indexing key[] at run time
#pragma unroll
  for (int e = 0; e < N; ++e) mine = lane / (32 / N) == e ? key[e] : mine;
  if (lane % (32 / N) == 0 && mine != kNoKey) dots[mine] = dot;
}

// a list of at most 32 * KPL keys: sorted in registers, then taken in order
template <typename T, int CPL, int KPL>
__device__ __forceinline__ void gather_sorted(const int* __restrict__ list, int n,
                                              const T* __restrict__ d_cols,
                                              const float* __restrict__ wcoef,
                                              float* __restrict__ dots, int C, int c0,
                                              PixelSum<T, CPL>& s, int lane) {
  int k[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) k[j] = j * 32 + lane < n ? __ldg(list + j * 32 + lane) : kNoKey;
  warp_sort<KPL>(k);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    if (j * 32 >= n) break;
    for (int l = 0; l < 32; l += kBatch) {
      int key[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) key[e] = __shfl_sync(kFull, k[j], l + e);
      if (key[0] == kNoKey) break;
      take<T, CPL, kBatch>(key, d_cols, wcoef, dots, C, c0, s, lane);
    }
  }
}

// a longer list (more than 128 corners on one pixel: offsets that pile taps
// up): the next smallest key is found by a pass over the list, n / 32 loads
// a lane per entry; the order is the key order all the same
template <typename T, int CPL>
__device__ __forceinline__ void gather_selected(const int* __restrict__ list, int n,
                                                const T* __restrict__ d_cols,
                                                const float* __restrict__ wcoef,
                                                float* __restrict__ dots, int C, int c0,
                                                PixelSum<T, CPL>& s, int lane) {
  int last = -1;
  for (int t = 0; t < n; t += kBatch) {
    int key[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      int best = kNoKey;
      if (t + e < n) {
        for (int i = lane; i < n; i += 32) {
          const int v = __ldg(list + i);
          if (v > last && v < best) best = v;
        }
        best = warp_min(best);
        last = best;
      }
      key[e] = best;
    }
    take<T, CPL, kBatch>(key, d_cols, wcoef, dots, C, c0, s, lane);
  }
}

// 4. gather: one warp per input pixel and chunk of 32 * CPL channels
// (blockIdx.y); d_x (may be null) is written once, in x's dtype
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kGatherMinBlocks<CPL>)
dcn_gather_kernel(const T* __restrict__ x, const T* __restrict__ d_cols,
                  const int* __restrict__ counts, const int* __restrict__ offs,
                  const int* __restrict__ keys, const float* __restrict__ wcoef,
                  float* __restrict__ dots, T* __restrict__ d_x, int64_t npix, int C,
                  int64_t nkeys) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (p >= npix) return;
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * 32 * CPL + lane * CPL;
  PixelSum<T, CPL> s;
  load_chunk<T, CPL>(x + p * C + c0, s.xv);
#pragma unroll
  for (int i = 0; i < CPL; ++i) s.acc[i] = 0.f;
  const int n = __ldg(counts + p);
  const int* list = keys + __ldg(offs + p);
  float* dch = dots + blockIdx.y * nkeys;
  if (n <= 32) {
    gather_sorted<T, CPL, 1>(list, n, d_cols, wcoef, dch, C, c0, s, lane);
  } else if (n <= 64) {
    gather_sorted<T, CPL, 2>(list, n, d_cols, wcoef, dch, C, c0, s, lane);
  } else if (n <= 128) {
    gather_sorted<T, CPL, 4>(list, n, d_cols, wcoef, dch, C, c0, s, lane);
  } else {
    gather_selected<T, CPL>(list, n, d_cols, wcoef, dch, C, c0, s, lane);
  }
  if (d_x != nullptr) store_chunk<T, CPL>(d_x + p * C + c0, s.acc);
}

// 5. combine: per item, its corners' <d_cols, x[corner]> (summed over the
// channel chunks in order) -> d_mask = sum w * dot, d_offsets = mask * sum
// (+-wx, +-wy) * dot
__global__ void __launch_bounds__(kItemThreads)
dcn_combine_kernel(const float* __restrict__ offsets, const float* __restrict__ mask,
                   const float* __restrict__ dots, int64_t nkeys, int chunks,
                   float* __restrict__ d_offsets, float* __restrict__ d_mask, int B, int H, int W,
                   int Ho, int Wo, int stride) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kItemThreads + threadIdx.x;
  if (item >= static_cast<int64_t>(B) * Ho * Wo * kTaps) return;
  int b;
  const Tap t = load_tap(offsets, mask, item, Ho, Wo, stride, H, W, b);
  float dm = 0.f, dpy = 0.f, dpx = 0.f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int cy = t.y0 + dy;
    if (cy < 0 || cy >= H) continue;
    const float wy = dy ? t.fy : 1.f - t.fy;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int cx = t.x0 + dx;
      if (cx < 0 || cx >= W) continue;
      const float wx = dx ? t.fx : 1.f - t.fx;
      const int64_t key = item * kCorners + 2 * dy + dx;
      float dot = 0.f;
      for (int ch = 0; ch < chunks; ++ch) dot += dots[ch * nkeys + key];
      dm = fmaf(wx * wy, dot, dm);
      dpy = fmaf(dy ? wx : -wx, dot, dpy);
      dpx = fmaf(dx ? wy : -wy, dot, dpx);
    }
  }
  reinterpret_cast<float2*>(d_offsets)[item] = make_float2(dpy * t.m, dpx * t.m);
  d_mask[item] = dm;
}

template <typename T, int CPL>
void launch_forward(const void* x, const float* offsets, const float* mask, void* cols, int B,
                    int H, int W, int C, int Ho, int Wo, int stride, cudaStream_t s) {
  const int64_t warps = static_cast<int64_t>(B) * Ho * Wo;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  deform_conv_forward_kernel<T, CPL><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<T*>(cols), B, H, W, C, Ho, Wo, stride);
}

// channels per lane: 1, 2, 4 for C = 32, 64, 128; 8 for multiples of 256
inline int lane_channels(int C) {
  if (C == 32 || C == 64 || C == 128) return C / 32;
  return C > 0 && C % 256 == 0 ? 8 : 0;
}

// the gather's channels per lane: the whole row in one chunk up to C = 512
// (1, 2, 4, 8, 16), chunks of 256 channels beyond
inline int gather_channels(int C) {
  if (lane_channels(C) == 0) return 0;
  return C <= 512 ? C / 32 : 8;
}

template <typename T>
int dispatch_forward(const void* x, const float* offsets, const float* mask, void* cols, int B,
                     int H, int W, int C, int Ho, int Wo, int stride, cudaStream_t s) {
  switch (lane_channels(C)) {
    case 1: launch_forward<T, 1>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 2: launch_forward<T, 2>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 4: launch_forward<T, 4>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 8: launch_forward<T, 8>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

inline bool dims_ok(int B, int H, int W, int C, int stride) {
  return B >= 0 && H > 0 && W > 0 && stride > 0 && lane_channels(C) > 0;
}

// The backward's scratch, carved from one workspace in this order, each
// part 16-byte aligned: counts and offs (an int per input pixel), the scan's
// tile sums, the keys, each key's rank in its list and its weight (4 per
// item), and the dot products (4 per item and channel chunk).
struct Workspace {
  int* counts;
  int* offs;
  int* sums;
  int* keys;
  int* rank;
  float* wcoef;
  float* dots;
  int64_t npix, nkeys, bytes;
  int nscan, chunks;
};

inline int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

inline Workspace plan_workspace(void* base, int B, int H, int W, int C, int stride) {
  Workspace w{};
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  w.npix = static_cast<int64_t>(B) * H * W;
  w.nkeys = static_cast<int64_t>(B) * Ho * Wo * kTaps * kCorners;
  w.nscan = static_cast<int>((w.npix + kScanTile - 1) / kScanTile);
  w.chunks = C / (32 * gather_channels(C));
  char* p = static_cast<char*>(base);
  int64_t at = 0;
  auto take = [&](int64_t bytes) {
    char* q = p == nullptr ? nullptr : p + at;
    at += align16(bytes);
    return q;
  };
  w.counts = reinterpret_cast<int*>(take(4 * w.npix));
  w.offs = reinterpret_cast<int*>(take(4 * w.npix));
  w.sums = reinterpret_cast<int*>(take(4 * static_cast<int64_t>(w.nscan)));
  w.keys = reinterpret_cast<int*>(take(4 * w.nkeys));
  w.rank = reinterpret_cast<int*>(take(4 * w.nkeys));
  w.wcoef = reinterpret_cast<float*>(take(4 * w.nkeys));
  w.dots = reinterpret_cast<float*>(take(4 * w.nkeys * w.chunks));
  w.bytes = at;
  return w;
}

template <typename T, int CPL>
void launch_gather(const Workspace& w, const void* x, const void* d_cols, void* d_x, int C,
                   cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((w.npix + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  static_cast<unsigned>(w.chunks));
  dcn_gather_kernel<T, CPL><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(d_cols), w.counts, w.offs, w.keys, w.wcoef,
      w.dots, static_cast<T*>(d_x), w.npix, C, w.nkeys);
}

template <typename T>
int dispatch_gather(const Workspace& w, const void* x, const void* d_cols, void* d_x, int C,
                    cudaStream_t s) {
  switch (gather_channels(C)) {
    case 1: launch_gather<T, 1>(w, x, d_cols, d_x, C, s); break;
    case 2: launch_gather<T, 2>(w, x, d_cols, d_x, C, s); break;
    case 4: launch_gather<T, 4>(w, x, d_cols, d_x, C, s); break;
    case 8: launch_gather<T, 8>(w, x, d_cols, d_x, C, s); break;
    case 16: launch_gather<T, 16>(w, x, d_cols, d_x, C, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys are int32: 4 per item must stay below 2^31
inline bool keys_fit(int B, int H, int W, int stride) {
  const int64_t Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  return static_cast<int64_t>(B) * Ho * Wo * kTaps * kCorners < INT_MAX;
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
// x_dtype: kFloat32, kBFloat16 or kFloat16 (msda_common.cuh), the dtype of x
// and cols.
extern "C" int deform_conv_forward(const void* x, int x_dtype, const void* offsets,
                                   const void* mask, void* cols, int B, int H, int W, int C,
                                   int stride, void* stream) {
  if (!dims_ok(B, H, W, C, stride)) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  switch (x_dtype) {
    case kFloat32: return dispatch_forward<float>(x, off, msk, cols, B, H, W, C, Ho, Wo, stride, s);
    case kBFloat16:
      return dispatch_forward<__nv_bfloat16>(x, off, msk, cols, B, H, W, C, Ho, Wo, stride, s);
    case kFloat16: return dispatch_forward<__half>(x, off, msk, cols, B, H, W, C, Ho, Wo, stride, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Bytes of the workspace deform_conv_backward_gather needs at this shape, or
// -1 for a shape it does not take.
extern "C" int64_t deform_conv_backward_workspace(int B, int H, int W, int C, int stride) {
  if (!dims_ok(B, H, W, C, stride) || !keys_fit(B, H, W, stride)) return -1;
  return plan_workspace(nullptr, B, H, W, C, stride).bytes;
}

// x, d_cols and d_x in x_dtype (as deform_conv_forward's); d_x (B, H, W, C)
// in x's dtype, every element written (null: x needs no
// gradient, nothing is written there); d_offsets and d_mask f32, written;
// workspace: deform_conv_backward_workspace bytes, 16-byte aligned, any
// contents.  Seven launches on the stream: zeroing the counts, count,
// two scan passes, place, gather, combine.
extern "C" int deform_conv_backward_gather(const void* x, int x_dtype, const void* offsets,
                                           const void* mask, const void* d_cols, void* d_x,
                                           void* d_offsets, void* d_mask, void* workspace, int B,
                                           int H, int W, int C, int stride, void* stream) {
  if (!dims_ok(B, H, W, C, stride) || !keys_fit(B, H, W, stride) || x_dtype < kFloat32 ||
      x_dtype > kFloat16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const float* msk = static_cast<const float*>(mask);
  const Workspace w = plan_workspace(workspace, B, H, W, C, stride);
  const int64_t items = w.nkeys / kCorners;
  const unsigned item_blocks = static_cast<unsigned>((items + kItemThreads - 1) / kItemThreads);
  const unsigned pixel_blocks = static_cast<unsigned>((w.npix + kItemThreads - 1) / kItemThreads);
  dcn_zero_kernel<<<pixel_blocks, kItemThreads, 0, s>>>(w.counts, w.npix);
  dcn_count_kernel<<<item_blocks, kItemThreads, 0, s>>>(off, msk, w.counts, w.rank, w.wcoef, B, H,
                                                         W, Ho, Wo, stride);
  dcn_scan_sums_kernel<<<w.nscan, kScanThreads, 0, s>>>(w.counts, w.npix, w.sums);
  dcn_scan_offsets_kernel<<<w.nscan, kScanThreads, 0, s>>>(w.counts, w.npix, w.sums, w.offs);
  dcn_place_kernel<<<item_blocks, kItemThreads, 0, s>>>(off, msk, w.offs, w.rank, w.keys, B, H, W,
                                                         Ho, Wo, stride);
  const int gathered = x_dtype == kBFloat16 ? dispatch_gather<__nv_bfloat16>(w, x, d_cols, d_x, C, s)
                       : x_dtype == kFloat16  ? dispatch_gather<__half>(w, x, d_cols, d_x, C, s)
                                              : dispatch_gather<float>(w, x, d_cols, d_x, C, s);
  if (gathered != 0) return gathered;
  dcn_combine_kernel<<<item_blocks, kItemThreads, 0, s>>>(
      off, msk, w.dots, w.nkeys, w.chunks, static_cast<float*>(d_offsets),
      static_cast<float*>(d_mask), B, H, W, Ho, Wo, stride);
  return static_cast<int>(cudaGetLastError());
}
