// Multi-scale deformable attention backward (MSDA), one kernel for every
// location-group count G: the vector-Jacobian product of msda.cu's forward.
//
// Replaces, in salience_detr_tpu/ops/deform_attn.py:
//   * the custom VJP of the head-shared core (_make_quadgrad_reduce, its
//     _bwd, with the autodiff of the corner weights around it; G = 1, the
//     encoder)
//   * the autodiff of ms_deform_attn_core / ms_deform_attn_core_quad (G = H,
//     exact per-head locations, the decoder)
//
// Semantics (ms_deform_attn_backward_plain in ops/deform_attn.py is the
// spec): for each (b, q), head h with location group g = h * G / H, level l,
// point p, and each in-level corner with bilinear weight cw = wx * wy:
//   d_weights[b,q,h,l,p] += cw * <d_out[b,q,head h], value[corner, head h]>
//   d_value[b,corner,head h] += attn[b,q,h,l,p] * cw * d_out[b,q,head h]
//   d_loc[b,q,g,l,p] += attn * <d_out_h, value_h> * (d cw / d loc), summed
//                       over the H / G heads of the group, where
//                       d wx / d loc_x = -w_l or +w_l and likewise for y.
// Out-of-level corners are neither read nor written; the floor is piecewise
// constant and contributes nothing.
//
// Two designs write d_value; d_locations and d_weights are the same in both
// (a warp per (b, q) reduces them across its lanes with shuffles and writes
// each once, without atomics).
//
// The scatter (msda_backward): every in-level corner adds its C floats into
// a zeroed f32 d_value with vector atomics (reductions in L2).  One warp per
// (b, q), each corner row read once for all heads; the lanes hold the
// channels in chunks of VW = 4 (or C / 32) floats, chunk k of lane l at
// channels k * 32 * VW + l * VW, so that each warp-wide vector reduction
// (sm_90's float4 / float2 atomicAdd, one RED of 16 B per lane) covers 32 *
// VW * 4 contiguous bytes.  A corner whose attn * cw is exactly 0 adds
// nothing and is not scattered.  The atomics add in no fixed order, so
// d_value differs from run to run in its last bits.  At the flagship's
// first encoder layer (B=4, Q=11403, L=P=4, C=256) that is up to 187M float
// adds into a 91 MB buffer, and neighbouring queries of the head-shared
// encoder sample the same corners, so the adds collide.  A block per
// (image, head, query tile) adding the two coarsest levels into a private
// f32 slice in shared memory was measured and lost at G = 1 (PERF.md):
// shared-memory f32 atomics are compare-and-swap loops on this card.
//
// The ordered design (msda_backward_ordered): a pull with no atomic add,
// bitwise repeatable.  Entries are the in-level corners of every item (b,
// q, g, l, p) with a nonzero bilinear weight cw, keyed item * 4 + corner; a
// row is (b, s, g), the C / G channels of location group g at value token s
// (the whole token at G = 1, one head at G = H).  Launches:
//   1. entries: a thread per key writes the key's row (or none) and cw
//      (attn * cw at G = H);
//   2-4. a stable sort of the entries by row, least significant digit
//      first, one pass a digit of up to kDigitBitsMax bits (three passes at
//      the flagship's and the 5-scale encoder's shapes): each block counts
//      the digit values of its tile of consecutive positions, the scan over
//      (value, tile) gives every (value, tile) its first slot, and each
//      block stages its tile's entries by value in position order in shared
//      memory and writes each value's run to consecutive slots.  The keys
//      enter in key order and every pass keeps the order of equal digits,
//      so each row's entries leave the sort in key order with no sort of
//      their own, however long the row;
//   5. bounds: each row's first and end slot in the sorted entries;
//   6. gather: a team of lanes per row (32 lanes at G = 1, 4 at G = H = 8)
//      sums attn * cw * d_out[b, q, its channels] over the row's entries in
//      key order and writes the row once in the value's dtype; the coarsest
//      level's rows, the longest (about 600 entries at the flagship's first
//      encoder layer), are taken first;
//   7. d_locations and d_weights: the scatter design's kernel without its
//      scatter.
// Every sum runs in key order, so the result depends on the inputs alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"
#include "msda_common.cuh"
#include "row_lists.cuh"

namespace {

// One sampling point on a level of lh x lw pixels: the top-left corner
// (x0, y0) of its four bilinear corners and the fractions (fx, fy).
// Clamping to [-2, size + 1] changes no corner's validity (a clamped point
// has no corner in its level) and keeps the float -> int conversion defined
// for far-away points.
struct Bilinear {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ Bilinear bilinear(float2 xy, int lh, int lw) {
  const float x = fminf(fmaxf(pixel_coord(xy.x, lw), -2.f), lw + 1.f);
  const float y = fminf(fmaxf(pixel_coord(xy.y, lh), -2.f), lh + 1.f);
  const float x0f = floorf(x), y0f = floorf(y);
  return {static_cast<int>(x0f), static_cast<int>(y0f), x - x0f, y - y0f};
}

// VW floats at p (aligned to 4 * VW bytes) added to global memory by one
// vector reduction.
template <int VW>
__device__ __forceinline__ void red_add(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VW == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// Sums each chunk's partial v[k] over its channel group of `width` channels
// (a power of two dividing C: a head, D = C / H, or a location group, C / G).
// A group narrower than a chunk is a run of width / VW aligned lanes (xor
// shuffles); a wider one is whole chunks, summed in registers first.  Every
// lane ends with its groups' totals.  All 32 lanes must call it.
template <int VW, int NCH>
__device__ __forceinline__ void group_sum(float (&v)[NCH], int width) {
  static_assert(NCH == 1 || NCH == 2, "chunks per lane");
  if (width >= 32 * VW) {
    if (NCH == 2 && width == 64 * VW) {
      float t = v[0] + v[NCH - 1];
      for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
#pragma unroll
      for (int k = 0; k < NCH; ++k) v[k] = t;
      return;
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    return;
  }
  for (int off = width / VW / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
  }
}

// value (B, S, C), loc (B, Q, G, L, P, 2) f32, attn (B, Q, H, L, P) f32,
// d_out (B, Q, C) in the value dtype; d_value (B, S, C) f32, zeroed by the
// caller (unused without kScatter); d_loc (B, Q, G, L, P, 2) f32 and d_attn
// (B, Q, H, L, P) f32, every element written here.  C = 32 * VW * NCH.
template <typename T, int VW, int NCH, bool kScatter>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_backward_kernel(const T* __restrict__ value, const LevelTable levels,
                     const float* __restrict__ loc, const float* __restrict__ attn,
                     const T* __restrict__ d_out, float* __restrict__ d_value,
                     float* __restrict__ d_loc, float* __restrict__ d_attn, int B, int S,
                     int Q, int H, int G, int P) {
  constexpr int C = 32 * VW * NCH;
  const int64_t bq = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (bq >= static_cast<int64_t>(B) * Q) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int L = levels.num_levels;
  const int LP = L * P;
  const int b = static_cast<int>(bq / Q);
  const int D = C / H, CG = C / G;  // channels of a head, of a location group

  int c0[NCH], h[NCH], g[NCH];
  float go[NCH][VW];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    c0[k] = k * 32 * VW + lane * VW;
    h[k] = c0[k] / D;
    g[k] = c0[k] / CG;
    load_chunk<T, VW>(d_out + bq * C + c0[k], go[k]);
  }
  const int64_t batch_offset = static_cast<int64_t>(b) * S * C;
  const T* value_b = value + batch_offset;
  float* d_value_b = d_value + batch_offset;

  for (int l = 0; l < L; ++l) {
    const int lh = levels.h[l], lw = levels.w[l], ls = levels.start[l];
    for (int p = 0; p < P; ++p) {
      float s[NCH], gx[NCH], gy[NCH];  // this lane's partial sums, per chunk
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const float2 xy =
            __ldg(reinterpret_cast<const float2*>(loc) + (bq * G + g[k]) * LP + l * P + p);
        const float a = __ldg(attn + (bq * H + h[k]) * LP + l * P + p);
        const Bilinear pt = bilinear(xy, lh, lw);
        s[k] = gx[k] = gy[k] = 0.f;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int cy = pt.y0 + dy;
          if (cy < 0 || cy >= lh) continue;
          const float wy = dy ? pt.fy : 1.f - pt.fy;
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int cx = pt.x0 + dx;
            if (cx < 0 || cx >= lw) continue;
            const float wx = dx ? pt.fx : 1.f - pt.fx;
            const int64_t row = static_cast<int64_t>(ls + cy * lw + cx) * C + c0[k];
            float v[VW];
            load_chunk<T, VW>(value_b + row, v);
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < VW; ++i) dot = fmaf(go[k][i], v[i], dot);
            s[k] = fmaf(wx * wy, dot, s[k]);
            gx[k] = fmaf(dx ? wy : -wy, dot, gx[k]);
            gy[k] = fmaf(dy ? wx : -wx, dot, gy[k]);
            const float aw = a * (wx * wy);
            if (kScatter && aw != 0.f) {  // adding +-0 changes nothing
              float add[VW];
#pragma unroll
              for (int i = 0; i < VW; ++i) add[i] = aw * go[k][i];
              red_add<VW>(d_value_b + row, add);
            }
          }
        }
        gx[k] *= a;
        gy[k] *= a;
      }
      // every lane reaches the shuffles: the loops above are warp-uniform
      group_sum<VW, NCH>(s, D);
      group_sum<VW, NCH>(gx, CG);
      group_sum<VW, NCH>(gy, CG);
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (c0[k] % D == 0) d_attn[(bq * H + h[k]) * LP + l * P + p] = s[k];
        if (c0[k] % CG == 0)
          reinterpret_cast<float2*>(d_loc)[(bq * G + g[k]) * LP + l * P + p] =
              make_float2(gx[k] * lw, gy[k] * lh);
      }
    }
  }
}

template <typename T, int VW, int NCH, bool kScatter>
void launch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
            const void* d_out, void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
            int H, int G, int P, cudaStream_t stream) {
  const int64_t warps = static_cast<int64_t>(B) * Q;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_backward_kernel<T, VW, NCH, kScatter><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(value), levels, static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(d_out),
      static_cast<float*>(d_value), static_cast<float*>(d_loc), static_cast<float*>(d_attn), B,
      S, Q, H, G, P);
}

template <typename T, bool kScatter>
int dispatch(const void* value, const LevelTable& levels, const void* loc, const void* attn,
             const void* d_out, void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
             int C, int H, int G, int P, cudaStream_t stream) {
  switch (C) {
    case 32:
      launch<T, 1, 1, kScatter>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                      stream);
      break;
    case 64:
      launch<T, 2, 1, kScatter>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                      stream);
      break;
    case 256:
      launch<T, 4, 2, kScatter>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, H, G, P,
                      stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- the ordered design

constexpr int kItemThreads = 256;
constexpr int kSortWarps = 8;                   // warps a block of the sort passes
constexpr int kSortRounds = 8;                  // a sort warp takes 32 * kSortRounds consecutive positions
constexpr int kTile = kSortWarps * 32 * kSortRounds;  // a block's positions: 2048
constexpr int kDigitBitsMax = 8;                // a pass sorts on at most 256 digit values
constexpr int kDigitsMax = 1 << kDigitBitsMax;
static_assert(kDigitsMax == kSortWarps * 32, "a thread a digit value");
constexpr int kBatch = 8;                       // entries a gather team has in flight

// The shape of one call as the ordered kernels index it.  An item is (b, q,
// g, l, p), numbered ((bq * G + g) * L + l) * P + p, which is also its
// location pair's index in loc; a row is (b, s, g), numbered (b * S + s) * G
// + g, and holds channels [g * C / G, (g + 1) * C / G) of token s.  Keys
// (4 an item) and rows stay below 2^31 (ordered_fits), so the kernels index
// them in 32-bit unsigned arithmetic: a 64-bit division is many times the
// instructions.  With one head a group (G = H, the decoder) an item's
// attention weight is its attn element `item`, and the entry kernel folds
// it into the entry's weight.
struct Dims {
  int64_t items, rows;
  int B, S, Q, C, H, G, L, P;
  bool fold;  // G == H
};

// The in-level corners of one item: its level's size and first token, the
// point's corners, and the row of its image and group at token 0.
struct ItemCorners {
  Bilinear pt;
  int lh, lw, ls;
  int64_t row0;  // the row of token s is row0 + s * G
};

__device__ __forceinline__ ItemCorners item_corners(const LevelTable& levels,
                                                    const float* __restrict__ loc, unsigned item,
                                                    const Dims& d) {
  const unsigned l = item / d.P % d.L;
  const unsigned bqg = item / (d.L * d.P);
  const unsigned g = bqg % d.G;
  const unsigned b = bqg / d.G / d.Q;
  const int lh = levels.h[l], lw = levels.w[l];
  const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + item);
  return {bilinear(xy, lh, lw), lh, lw, levels.start[l], (static_cast<int64_t>(b) * d.S) * d.G + g};
}

// 1. entries: a thread per key (item * 4 + corner).  The corner is an
// entry when it lies inside its level with a nonzero weight cw = wx * wy
// (attn * cw, folded at G = H, nonzero); the key's row is written (-1 for
// no entry) and its weight (0 for none).
__global__ void __launch_bounds__(kItemThreads)
msda_entry_kernel(const LevelTable levels, const float* __restrict__ loc,
                  const float* __restrict__ attn, int* __restrict__ row_of,
                  float* __restrict__ wcoef, const Dims d) {
  const unsigned key = blockIdx.x * kItemThreads + threadIdx.x;
  if (key >= d.items * 4) return;
  const unsigned item = key >> 2;
  const int dy = (key >> 1) & 1, dx = key & 1;
  const ItemCorners it = item_corners(levels, loc, item, d);
  const int cy = it.pt.y0 + dy, cx = it.pt.x0 + dx;
  int row = -1;
  float cw = 0.f;
  if (cy >= 0 && cy < it.lh && cx >= 0 && cx < it.lw) {
    const float wy = dy ? it.pt.fy : 1.f - it.pt.fy;
    const float wx = dx ? it.pt.fx : 1.f - it.pt.fx;
    cw = wx * wy;                          // as the scatter design computes it
    if (d.fold) cw = __ldg(attn + item) * cw;  // the product the gather would form
    if (cw != 0.f) row = static_cast<int>(it.row0 + static_cast<int64_t>(it.ls + cy * it.lw + cx) * d.G);
  }
  row_of[key] = row;
  wcoef[key] = row < 0 ? 0.f : cw;
}

// One pass of the stable sort of the entries by row: the digit (row >>
// shift) & mask of the n positions of rows_in (n_dev's value when given; a
// row below 0 is no entry).  A tile is a block's kTile consecutive
// positions; warp w of the block takes the w-th eighth of the tile, 32
// positions a round in order, so the order of a digit value's entries in
// the tile (warps in order, then rounds, then lanes) is their positions'.
struct Digit {
  int shift, mask;
};

__device__ __forceinline__ int tile_count(const int* n_dev, int n_host) { return n_dev ? *n_dev : n_host; }

// The r-th position of this thread's warp in the tile.
__device__ __forceinline__ int tile_position(int tile, int r) {
  return tile * kTile + ((threadIdx.x >> 5) * kSortRounds + r) * 32 + (threadIdx.x & 31);
}

// The exclusive prefix of x over the block's kSortWarps * 32 threads
// (thread t holding digit value t); *total receives the sum.
__device__ __forceinline__ int digits_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kSortWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  *total = all;
  return before + incl - x;
}

// Each warp's count of each digit value among its positions, in
// cnt[warp][value]; the lanes of a round that share a value are counted by
// one of them.  Returns the warp's ranks in rank[] (its entry's rank among
// the warp's entries of its value, -1 for no entry) with their rows.
__device__ __forceinline__ void warp_digit_counts(const int* __restrict__ rows_in, int n, int tile, const Digit dg,
                                                  int (*cnt)[kDigitsMax], int (&row)[kSortRounds],
                                                  int (&rank)[kSortRounds]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const int pos = tile_position(tile, r);
    row[r] = pos < n ? __ldg(rows_in + pos) : -1;
    rank[r] = -1;
    const unsigned live = __ballot_sync(kFull, row[r] >= 0);
    unsigned peers = 0;
    int v = 0;
    if (row[r] >= 0) {
      v = (row[r] >> dg.shift) & dg.mask;
      peers = __match_any_sync(live, v);
      rank[r] = cnt[warp][v] + __popc(peers & ((1u << lane) - 1));
    }
    __syncwarp();  // every lane has read its value's count before the leaders move it on
    if (row[r] >= 0 && lane == __ffs(peers) - 1) cnt[warp][v] += __popc(peers);
    __syncwarp();
  }
}

// 2. count: each tile's entries of each digit value, at hist[value * tiles
// + tile] (so that the scan over hist ranks a value's entries tile by tile)
__global__ void __launch_bounds__(kSortWarps * 32)
msda_digit_count_kernel(const int* __restrict__ rows_in, const int* __restrict__ n_dev, int n_host,
                        const Digit dg, int tiles, int* __restrict__ hist) {
  __shared__ int cnt[kSortWarps][kDigitsMax];
  const int tile = blockIdx.x, t = threadIdx.x;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) cnt[w][t] = 0;
  __syncthreads();
  int row[kSortRounds], rank[kSortRounds];
  warp_digit_counts(rows_in, tile_count(n_dev, n_host), tile, dg, cnt, row, rank);
  __syncthreads();
  if (t <= dg.mask) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kSortWarps; ++w) sum += cnt[w][t];
    hist[static_cast<int64_t>(t) * tiles + tile] = sum;
  }
}

// 4. place: the tile's entries staged in shared memory in (value,
// position) order, then written out so that consecutive threads write a
// value's consecutive slots: entry i of value v in the tile goes to the
// scan's slot of (v, tile) plus i; keys_in null: the key is the position
// (the first pass)
__global__ void __launch_bounds__(kSortWarps * 32)
msda_digit_place_kernel(const int* __restrict__ rows_in, const int* __restrict__ keys_in,
                        const int* __restrict__ n_dev, int n_host, const Digit dg, int tiles,
                        const int* __restrict__ offs, int* __restrict__ rows_out,
                        int* __restrict__ keys_out) {
  __shared__ int cnt[kSortWarps][kDigitsMax];  // the warps' counts, then their first slots in the value's run
  __shared__ int run_start[kDigitsMax];        // each value's first slot in the staged tile
  __shared__ int out_start[kDigitsMax];        // each value's first slot in rows_out for this tile
  __shared__ int2 staged[kTile];
  const int tile = blockIdx.x, t = threadIdx.x, warp = t >> 5;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) cnt[w][t] = 0;
  out_start[t] = t <= dg.mask ? __ldg(offs + static_cast<int64_t>(t) * tiles + tile) : 0;
  __syncthreads();
  const int n = tile_count(n_dev, n_host);
  int row[kSortRounds], rank[kSortRounds];
  warp_digit_counts(rows_in, n, tile, dg, cnt, row, rank);
  __syncthreads();
  int total = 0;  // the value's entries in the tile
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int c = cnt[w][t];
    cnt[w][t] = total;
    total += c;
  }
  int entries;
  run_start[t] = digits_exclusive_scan(total, &entries);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    if (rank[r] >= 0) {
      const int v = (row[r] >> dg.shift) & dg.mask;
      const int pos = tile_position(tile, r);
      staged[run_start[v] + cnt[warp][v] + rank[r]] = make_int2(row[r], keys_in ? __ldg(keys_in + pos) : pos);
    }
  }
  __syncthreads();
  for (int i = t; i < entries; i += kSortWarps * 32) {
    const int2 e = staged[i];
    const int v = (e.x >> dg.shift) & dg.mask;
    const int slot = out_start[v] + i - run_start[v];
    rows_out[slot] = e.x;
    keys_out[slot] = e.y;
  }
}

// 5. bounds: row r's entries are sorted[first[r], end[r]) (both zeroed
// before: a row with no entry keeps an empty range)
__global__ void __launch_bounds__(kItemThreads)
msda_row_bounds_kernel(const int* __restrict__ rows, const int* __restrict__ n_dev,
                       int* __restrict__ first, int* __restrict__ end) {
  const int i = blockIdx.x * kItemThreads + threadIdx.x;
  const int n = *n_dev;
  if (i >= n) return;
  const int row = rows[i];
  if (i == 0 || rows[i - 1] != row) first[row] = i;
  if (i == n - 1 || rows[i + 1] != row) end[row] = i + 1;
}

// The token of slot t when the tokens are taken coarsest level first, then
// by image, then in the level's order: the long lists of the coarse levels
// start first.
__device__ __forceinline__ void token_of(const LevelTable& levels, int B, unsigned t, unsigned& b,
                                         unsigned& s) {
  b = s = 0;
  for (int l = levels.num_levels - 1; l >= 0; --l) {
    const unsigned hw = static_cast<unsigned>(levels.h[l] * levels.w[l]);
    if (t < B * hw) {
      b = t / hw;
      s = levels.start[l] + t % hw;
      return;
    }
    t -= B * hw;
  }
}

// 6. gather: a team of LPR = C / G / CPL lanes per row, CPL channels a lane
// (inside one head), 32 / LPR rows a warp (one token's groups, or
// consecutive tokens); a team sums attn * cw * d_out[b, q, its channels]
// over its row's entries in key order, kBatch rows of d_out in flight, and
// writes the row once in the value's dtype (zeros for a row with none).
template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_gather_kernel(const LevelTable levels, const T* __restrict__ d_out,
                   const float* __restrict__ attn, const int* __restrict__ first,
                   const int* __restrict__ end, const int* __restrict__ keys,
                   const float* __restrict__ wcoef, T* __restrict__ d_value, int lpr_log2,
                   const Dims d) {
  const int lane = threadIdx.x & 31;
  const unsigned slot = (blockIdx.x * kWarpsPerBlock + threadIdx.x / 32) * (32u >> lpr_log2) +
                        (lane >> lpr_log2);
  if (slot >= d.rows) return;
  unsigned b, s;
  token_of(levels, d.B, slot / d.G, b, s);
  const unsigned g = slot % d.G;
  const unsigned row = (b * d.S + s) * d.G + g;
  const int c0 = static_cast<int>(g) * (d.C / d.G) + (lane & ((1 << lpr_log2) - 1)) * CPL;
  const int h = c0 / (d.C / d.H);
  const unsigned LP = d.L * d.P, bq_items = d.G * LP;
  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
  const int n = __ldg(end + row);
  for (int t = __ldg(first + row); t < n; t += kBatch) {
    float go[kBatch][CPL], aw[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      aw[e] = 0.f;
      if (t + e < n) {
        const int key = __ldg(keys + t + e);
        const unsigned item = static_cast<unsigned>(key) >> 2;
        const unsigned bq = item / bq_items;
        const float w = __ldg(wcoef + key);
        aw[e] = d.fold ? w : __ldg(attn + (static_cast<int64_t>(bq) * d.H + h) * LP + item % LP) * w;
        load_chunk<T, CPL>(d_out + static_cast<int64_t>(bq) * d.C + c0, go[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      if (aw[e] != 0.f) {  // an entry whose attn * cw is 0 adds nothing, as in the scatter design
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[i] = fmaf(aw[e], go[e][i], acc[i]);
      }
    }
  }
  store_chunk<T, CPL>(d_value + (static_cast<int64_t>(b) * d.S + s) * d.C + c0, acc);
}

// The ordered design's scratch, carved from one workspace in this order,
// each part 16-byte aligned: the sort's two buffers of (row, key) pairs (an
// int each a key; the first pass reads each key's row from rows_b), the
// keys' weights, the digit counts and their scan (an int a digit value and
// tile), the scan's block sums, then the rows' first and end slots and the
// count of entries, contiguous for one memset.
struct Workspace {
  int *rows_a, *keys_a, *rows_b, *keys_b, *hist, *offs, *sums, *first, *end, *nvalid;
  float* wcoef;
  int64_t nkeys, bytes;
  int tiles, nscan, passes;
  Digit digit;  // the width of every pass's digit (shift 0)
};

inline int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

inline Workspace plan_workspace(void* base, const Dims& d) {
  Workspace w{};
  w.nkeys = d.items * 4;
  w.tiles = static_cast<int>((w.nkeys + kTile - 1) / kTile);
  int bits = 1;
  while (bits < 31 && (int64_t{1} << bits) < d.rows) ++bits;
  w.passes = (bits + kDigitBitsMax - 1) / kDigitBitsMax;
  const int width = (bits + w.passes - 1) / w.passes;
  w.digit = {0, (1 << width) - 1};
  const int64_t counts = static_cast<int64_t>(w.tiles) << width;
  w.nscan = static_cast<int>((counts + kScanTile - 1) / kScanTile);
  char* p = static_cast<char*>(base);
  int64_t at = 0;
  auto take = [&](int64_t bytes) {
    char* q = p == nullptr ? nullptr : p + at;
    at += align16(bytes);
    return reinterpret_cast<int*>(q);
  };
  w.rows_a = take(4 * w.nkeys);
  w.keys_a = take(4 * w.nkeys);
  w.rows_b = take(4 * w.nkeys);
  w.keys_b = take(4 * w.nkeys);
  w.wcoef = reinterpret_cast<float*>(take(4 * w.nkeys));
  w.hist = take(4 * counts);
  w.offs = take(4 * counts);
  w.sums = take(4 * static_cast<int64_t>(w.nscan));
  w.first = take(4 * d.rows);
  w.end = take(4 * d.rows);
  w.nvalid = take(4);
  w.bytes = at;
  return w;
}

inline Dims make_dims(const LevelTable& levels, int B, int S, int Q, int C, int H, int G, int P) {
  const int L = levels.num_levels;
  return {static_cast<int64_t>(B) * Q * G * L * P, static_cast<int64_t>(B) * S * G, B, S, Q, C, H, G,
          L, P, G == H};
}

// keys, rows and slots are int32
inline bool ordered_fits(const Dims& d) { return d.items * 4 < INT_MAX && d.rows < INT_MAX; }

// the passes of the sort (LSD: the lowest digit first, each pass stable);
// returns the buffer holding the sorted rows and keys
int sort_entries(const Workspace& w, cudaStream_t s, int** rows, int** keys) {
  const unsigned blocks = static_cast<unsigned>(w.tiles);
  const int64_t counts = static_cast<int64_t>(w.tiles) * (w.digit.mask + 1);
  int *in_rows = w.rows_b, *in_keys = nullptr, *out_rows = w.rows_a, *out_keys = w.keys_a;
  const int width = __builtin_popcount(static_cast<unsigned>(w.digit.mask));
  for (int p = 0; p < w.passes; ++p) {
    const Digit dg{p * width, w.digit.mask};
    const int* n_dev = p == 0 ? nullptr : w.nvalid;
    const int n_host = static_cast<int>(w.nkeys);
    msda_digit_count_kernel<<<blocks, kSortWarps * 32, 0, s>>>(in_rows, n_dev, n_host, dg, w.tiles, w.hist);
    scan_sums_kernel<<<w.nscan, kScanThreads, 0, s>>>(w.hist, counts, w.sums);
    scan_offsets_kernel<<<w.nscan, kScanThreads, 0, s>>>(w.hist, counts, w.sums, w.offs,
                                                         p == 0 ? w.nvalid : nullptr);
    msda_digit_place_kernel<<<blocks, kSortWarps * 32, 0, s>>>(in_rows, in_keys, n_dev, n_host, dg, w.tiles,
                                                               w.offs, out_rows, out_keys);
    in_rows = out_rows;
    in_keys = out_keys;
    out_rows = in_rows == w.rows_a ? w.rows_b : w.rows_a;
    out_keys = in_keys == w.keys_a ? w.keys_b : w.keys_a;
  }
  *rows = in_rows;
  *keys = in_keys;
  return static_cast<int>(cudaGetLastError());
}

// the gather's lanes: CPL channels a lane inside one head, LPR = C / G /
// CPL lanes a row (at most 32: C / G <= 256)
template <typename T>
int dispatch_gather(const LevelTable& levels, const Workspace& w, const int* keys, const Dims& d,
                    const void* d_out, const float* attn, void* d_value, cudaStream_t s) {
  const int D = d.C / d.H, CG = d.C / d.G;
  const int cpl = D >= 8 ? 8 : D;
  int lpr_log2 = 0;
  while ((cpl << lpr_log2) < CG) ++lpr_log2;
  if ((cpl << lpr_log2) != CG || lpr_log2 > 5) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = (d.rows + (32 >> lpr_log2) - 1) / (32 >> lpr_log2);
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  auto run = [&](auto kernel) {
    kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(levels, static_cast<const T*>(d_out), attn, w.first, w.end,
                                                  keys, w.wcoef, static_cast<T*>(d_value), lpr_log2, d);
  };
  switch (cpl) {
    case 1: run(msda_gather_kernel<T, 1>); break;
    case 2: run(msda_gather_kernel<T, 2>); break;
    case 4: run(msda_gather_kernel<T, 4>); break;
    case 8: run(msda_gather_kernel<T, 8>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take (the Python wrapper rejects those first).
extern "C" int msda_backward(const void* value, int value_is_bf16, LevelTable levels,
                             const void* loc, const void* attn, const void* d_out,
                             void* d_value, void* d_loc, void* d_attn, int B, int S, int Q,
                             int C, int H, int G, int P, void* stream) {
  if (!shapes_ok(levels, S, C, H, G)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16) {
    return dispatch<__nv_bfloat16, true>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B,
                                   S, Q, C, H, G, P, s);
  }
  return dispatch<float, true>(value, levels, loc, attn, d_out, d_value, d_loc, d_attn, B, S, Q, C,
                         H, G, P, s);
}

// Bytes of the workspace msda_backward_ordered needs at this shape, or -1
// for a shape it does not take.
extern "C" int64_t msda_backward_workspace(LevelTable levels, int B, int S, int Q, int C, int H,
                                           int G, int P) {
  if (!shapes_ok(levels, S, C, H, G) || B < 0 || Q < 0 || P <= 0) return -1;
  const Dims d = make_dims(levels, B, S, Q, C, H, G, P);
  if (!ordered_fits(d)) return -1;
  return plan_workspace(nullptr, d).bytes;
}

// The ordered design: as msda_backward, but d_value (B, S, C) is in the
// value's dtype and every element is written here (no zeroing needed);
// workspace: msda_backward_workspace bytes, 16-byte aligned, any contents.
// On the stream: a memset of the row bounds, the entry kernel, four
// operations a sort pass (count, two scan passes, place), the bounds, the
// gather, and the d_locations / d_weights kernel.
extern "C" int msda_backward_ordered(const void* value, int value_is_bf16, LevelTable levels,
                                     const void* loc, const void* attn, const void* d_out,
                                     void* d_value, void* d_loc, void* d_attn, void* workspace,
                                     int B, int S, int Q, int C, int H, int G, int P,
                                     void* stream) {
  if (!shapes_ok(levels, S, C, H, G) || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(levels, B, S, Q, C, H, G, P);
  if (!ordered_fits(d)) return static_cast<int>(cudaErrorInvalidValue);
  if (d.rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Workspace w = plan_workspace(workspace, d);
  const float* attnf = static_cast<const float*>(attn);
  // first, end and nvalid are contiguous: zero them all
  cudaError_t err = cudaMemsetAsync(w.first, 0, reinterpret_cast<char*>(w.nvalid + 1) -
                                                    reinterpret_cast<char*>(w.first), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int *rows = nullptr, *keys = nullptr;
  if (d.items > 0) {
    const unsigned key_blocks = static_cast<unsigned>((w.nkeys + kItemThreads - 1) / kItemThreads);
    msda_entry_kernel<<<key_blocks, kItemThreads, 0, s>>>(levels, static_cast<const float*>(loc), attnf,
                                                          w.rows_b, w.wcoef, d);
    const int sorted = sort_entries(w, s, &rows, &keys);
    if (sorted != 0) return sorted;
    msda_row_bounds_kernel<<<key_blocks, kItemThreads, 0, s>>>(rows, w.nvalid, w.first, w.end);
  }
  const int gathered = value_is_bf16
                           ? dispatch_gather<__nv_bfloat16>(levels, w, keys, d, d_out, attnf, d_value, s)
                           : dispatch_gather<float>(levels, w, keys, d, d_out, attnf, d_value, s);
  if (gathered != 0) return gathered;
  if (static_cast<int64_t>(B) * Q == 0) return static_cast<int>(cudaSuccess);
  if (value_is_bf16) {
    return dispatch<__nv_bfloat16, false>(value, levels, loc, attn, d_out, nullptr, d_loc, d_attn,
                                          B, S, Q, C, H, G, P, s);
  }
  return dispatch<float, false>(value, levels, loc, attn, d_out, nullptr, d_loc, d_attn, B, S, Q,
                                C, H, G, P, s);
}
