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
// its 4 bilinear corners outside the image have weight 0.  Forward:
// cols[b, ho, wo, k, :] = mask * sum over corners of (wx * wy) * x[corner,
// :], summed in f32 corner by corner in the order (0, 0), (0, 1), (1, 0),
// (1, 1) without fused multiply-adds, rounded once to x's dtype: float32,
// bfloat16 or float16.  A corner outside the image is weighed 0 against x
// at its address clamped into the image, as the plain version (and the JAX
// package) does, so that the forward equals the plain version bit for bit
// for any x (0 * inf is NaN in both).  Backward, with g = d_cols * mask:
// d_x[corner] += (wx * wy) * g over the in-image corners; d_mask = <d_cols,
// sample>; d_offsets (dy, dx) = sum over corners of <g, x[corner]> times d
// (wx * wy) / d (py, px) = (+-wx, +-wy).
//
// What bounds it on an H100: bytes.  At the R50-DCN configuration's stage-2
// layers (B=4, 100x168 outputs, C=128, bf16) the forward writes a 155 MB
// column matrix from a 17-69 MB input (each input pixel is read by up to 36
// corners, mostly from L1/L2); the backward reads that many bytes of d_cols
// and writes d_x, 17-69 MB in x's dtype.
//
// What the forward's design does about it: every lane moves 16 bytes a
// load and a store at every C (a group of C / 8 lanes per output pixel in
// 16-bit types up to C = 256, so a warp takes 2 pixels at C = 128, and a
// warp per (pixel, 256-channel chunk) above; C / 4 lanes and 128-channel
// chunks in f32); the corners are predicated (clamped addresses, weight 0
// outside the image), so the 12 corner loads of 3 taps issue before any sum
// and each tap's loads wait on no branch; the columns are stored streaming
// (st.global.cs), keeping the input rows in L2 for the corners that read
// them again.  The first design took a warp per pixel with 8-byte lanes at
// C = 128, skipped outside corners by branches and walked C = 512 in two
// chunks a warp.
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

// The pixel's 18 offsets and 9 masks, "slots" 0-17 and 18-26, spread over
// the G lanes of its group: lane j of the group holds slots j, j + G, ...,
// so that every value is loaded once per group; a tap takes its values by
// shuffles within the group.
template <int G>
struct TapSlots {
  static constexpr int kRegs = (2 * kTaps + kTaps + G - 1) / G;
  float v[kRegs];

  __device__ __forceinline__ void load(const float* __restrict__ offsets,
                                       const float* __restrict__ mask, int64_t pix, int sub) {
#pragma unroll
    for (int r = 0; r < kRegs; ++r) {
      const int s = sub + r * G;
      v[r] = s < 2 * kTaps   ? __ldg(offsets + pix * 2 * kTaps + s)
             : s < 3 * kTaps ? __ldg(mask + pix * kTaps + s - 2 * kTaps)
                             : 0.f;
    }
  }

  // slot s (a compile-time constant once the tap loop is unrolled) from the
  // group's lane s % G
  __device__ __forceinline__ float get(int s) const {
    return __shfl_sync(kFull, v[s / G], s % G, G);
  }
};

// The corners of kTapGroup taps, issued together: each corner's address is
// clamped into the image and a corner outside it keeps weight 0 (the plain
// version's where(valid, wx * wy, 0) times the clamped row), so no load
// waits on a validity test and 4 * kTapGroup 16-byte loads are in flight.
constexpr int kTapGroup = 3;

// A group of G lanes per (output pixel, chunk of G * VEC channels), VEC =
// 16 / sizeof(T) channels a lane: every corner row and column row is one
// 16-byte load or store a lane, a group covering G * 16 contiguous bytes;
// 32 / G items a warp.  The sums are the plain version's operations in its
// order: per tap w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11, left to
// right, each product and sum rounded (no FMA), then times the mask, then
// rounded once to T.  The columns are stored streaming (st.global.cs), so
// that they do not evict from L2 the input rows that later pixels' corners
// read again.
template <typename T, int G>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deform_conv_forward_kernel(const T* __restrict__ x, const float* __restrict__ offsets,
                           const float* __restrict__ mask, T* __restrict__ cols, int B, int H,
                           int W, int C, int Ho, int Wo, int stride, int chunks) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int64_t items = static_cast<int64_t>(B) * Ho * Wo * chunks;
  const int64_t warp_item = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32) *
                            (32 / G);
  if (warp_item >= items) return;  // whole warps: the shuffles below take every lane
  const int lane = threadIdx.x & 31;
  const int sub = lane % G;
  const int64_t mine = warp_item + lane / G;
  const bool live = mine < items;  // a group past the end redoes the last item, storing nothing
  const int64_t item = live ? mine : items - 1;
  const int64_t pix = item / chunks;
  const int c0 = static_cast<int>(item % chunks) * (G * VEC) + sub * VEC;
  const int wo = static_cast<int>(pix % Wo);
  const int ho = static_cast<int>((pix / Wo) % Ho);
  const int b = static_cast<int>(pix / (static_cast<int64_t>(Wo) * Ho));
  TapSlots<G> slots;
  slots.load(offsets, mask, pix, sub);
  const T* x_b = x + static_cast<int64_t>(b) * H * W * C + c0;
  T* out = cols + pix * kTaps * C + c0;

#pragma unroll
  for (int k0 = 0; k0 < kTaps; k0 += kTapGroup) {
    uint4 raw[kTapGroup][4];
    float w[kTapGroup][4];
#pragma unroll
    for (int t = 0; t < kTapGroup; ++t) {
      const int k = k0 + t;
      const float py = __fadd_rn(static_cast<float>(ho * stride + k / 3 - 1), slots.get(2 * k));
      const float px = __fadd_rn(static_cast<float>(wo * stride + k % 3 - 1), slots.get(2 * k + 1));
      const float y = fminf(fmaxf(py, -2.f), H + 1.f);
      const float xf = fminf(fmaxf(px, -2.f), W + 1.f);
      const float y0f = floorf(y), x0f = floorf(xf);
      const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
      const float fy = __fsub_rn(y, y0f), fx = __fsub_rn(xf, x0f);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        const float wy = dy ? fy : __fsub_rn(1.f, fy);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          const bool valid = cy >= 0 && cy < H && cx >= 0 && cx < W;
          w[t][2 * dy + dx] = valid ? __fmul_rn(dx ? fx : __fsub_rn(1.f, fx), wy) : 0.f;
          const int row = min(max(cy, 0), H - 1) * W + min(max(cx, 0), W - 1);
          raw[t][2 * dy + dx] = __ldg(reinterpret_cast<const uint4*>(x_b + static_cast<int64_t>(row) * C));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTapGroup; ++t) {
      float acc[VEC];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T* e = reinterpret_cast<const T*>(&raw[t][c]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float term = __fmul_rn(w[t][c], to_float(e[i]));
          acc[i] = c ? __fadd_rn(acc[i], term) : term;
        }
      }
      const float m = slots.get(2 * kTaps + k0 + t);
      uint4 packed;
      T* e = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = from_float<T>(__fmul_rn(acc[i], m));
      if (live) __stcs(reinterpret_cast<uint4*>(out + (k0 + t) * C), packed);
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

template <typename T, int G>
void launch_forward(const void* x, const float* offsets, const float* mask, void* cols, int B,
                    int H, int W, int C, int Ho, int Wo, int stride, cudaStream_t s) {
  const int chunks = C / (G * (16 / static_cast<int>(sizeof(T))));
  const int64_t warps = (static_cast<int64_t>(B) * Ho * Wo * chunks + 32 / G - 1) / (32 / G);
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  deform_conv_forward_kernel<T, G><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), offsets, mask, static_cast<T*>(cols), B, H, W, C, Ho, Wo, stride,
      chunks);
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

// the forward's lanes per item: C / VEC up to a whole warp (C = 32, 64,
// 128: 4, 8, 16 lanes in 16-bit types, 8, 16, 32 in f32), then chunks of 32
// * VEC channels (256 in 16-bit types, 128 in f32)
template <typename T>
int dispatch_forward(const void* x, const float* offsets, const float* mask, void* cols, int B,
                     int H, int W, int C, int Ho, int Wo, int stride, cudaStream_t s) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  switch (C < 32 * VEC ? C / VEC : 32) {
    case 4: launch_forward<T, 4>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 8: launch_forward<T, 8>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 16: launch_forward<T, 16>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
    case 32: launch_forward<T, 32>(x, offsets, mask, cols, B, H, W, C, Ho, Wo, stride, s); break;
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
