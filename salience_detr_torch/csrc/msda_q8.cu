// Head-shared multi-scale deformable attention over an int8 value table
// (inference only): the quantisation and the sampling.
//
// Replaces salience_detr_tpu/ops/deform_attn.py::ms_deform_attn_core_shared_q8
// (the JAX package's MSDA_GATHER_QUANT=int8 path of the encoder, G = 1).
//
// Semantics (q8_quantize_plain and q8_sample_plain in ops/deform_attn.py are
// the spec):
//   * quantise: per channel c, scale[c] = max(absmax over all B * S rows of
//     |value[:, c]| / 127, 1e-20) and q = clip(round_half_even(value /
//     scale), -127, 127) as int8, with IEEE division (bit-exact with the
//     plain version; no reciprocal multiply, no fast math);
//   * sample: for each (b, q), level l and point p, the 4 bilinear corners of
//     x = loc_x * w - 0.5, y = loc_y * h - 0.5 (grid_sample, align_corners
//     False, zero padding: a corner outside its level is never read); the
//     corner weight wx * wy is rounded to the output dtype T, the corner sum
//     s = sum w * q is taken in f32 and rounded to T, then the head's
//     attention weight (rounded to T) times s is added to an f32 sum over (l,
//     p); out = sum * scale[c], stored as T.  The roundings to T are the JAX
//     core's einsum operands in the compute dtype; every product and sum is
//     one IEEE operation in the plain version's order, so the two agree bit
//     for bit.
//
// What bounds it on an H100: bytes.  The sampler's gathers, as in K1
// (msda.cu): at the flagship's first encoder layer (B=4, Q=11403, L=P=4, C=256)
// each query reads 64 corner rows of 256 B (int8), half K1's bytes, from a
// 22.9 MB table that fits the 50 MB L2.  The quantisation must read the 45.7
// MB bf16 value once and write the 22.9 MB table (0.0205 ms at 3.35 TB/s),
// but its scale needs every row before the first table entry.
//
// What the sampler's design does about it (the second design; the first,
// one warp per (b, q) with an 8-byte load of 8 channels a lane, spent as many
// load instructions per corner as K1 for half the bytes, and four
// instructions per corner channel): a half-warp per (b, q) at C = 256, 16
// int8 channels a lane in one 16-byte load, so each corner row is one 256 B
// request serving all heads and a warp serves two queries (narrower heads
// take 8, 4, 2 or 1 channels a lane, so that a lane stays in one head); a
// point's four corner loads are issued without branches; in bf16 output a
// corner channel costs a byte permute, a subtraction and one fused
// multiply-add (exact: see corner_add).  The int8 -> f32 conversion is the
// permute and the subtraction.
//
// What the quantisation's design does about it (the second design; the
// first made two launches over 128-row tiles, the absmax and the table, and
// read the value twice from device memory): one cooperative launch of a
// persistent grid, a block an SM owning a contiguous slice of rows, which
// TMA bulk copies stream through a ring of tiles filling its shared memory.
// Pass 1 reduces the slice's absmax (registers, shared memory, one global
// atomicMax per channel and block); after a grid barrier pass 2 takes the
// slice again in reverse order, so that the ring's last tiles (two thirds
// of a bf16 slice at the flagship's encoder shape) are still in shared
// memory and only the rest is read again, from L2 where the evict-last
// policy kept it.  The IEEE division of every element (a long sequence and a
// branch each) is replaced by a fused multiply with the scale's reciprocal
// and a magic-number rounding, no conversion instruction, which gives the
// quotient's integer except within a few ulps of a half-integer step; there
// (0.6% of the captured encoder's bf16 elements) the sign of one fused
// residual decides it, still without a division.  The table goes out in
// streaming stores.  A thread holds 16-byte words (8 channels in bf16, 4 in
// f32).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"
#include "msda_common.cuh"

namespace {

constexpr int kQuantThreads = 1024;
constexpr int kTileBytes = 32768;  // the most a tile of whole rows holds
constexpr int kTileWords = kTileBytes / 16;  // a tile's 16-byte words, kTileWords / kQuantThreads a thread
constexpr int kMaxSlots = 64;      // bound on the ring's tiles (their barriers are reserved)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float channel_scale(unsigned absmax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(absmax_bits), 127.f), 1e-20f);
}

// 1.5 * 2^23: a sum kRoundMagic + p rounds p to an integer, half to even,
// for |p| < 2^22 (the sum's unit in the last place is 1), and the sum's
// bits are kRoundBits + that integer, whose low byte is the integer's
constexpr float kRoundMagic = 12582912.f;
constexpr int kRoundBits = 0x4B400000;

// q = clip(rint(v / s), -127, 127) with v / s the IEEE quotient, given r =
// 1 / s rounded: four FMA-unit operations and no conversion.  The exact
// product p = v * r is within 2^-24 |v / s| of v / s, and the quotient's
// rounding moves that by at most 2^-24 |v / s| more, so the quotient lies
// within 2^-23 (|n| + 0.51) of p, n = rint(p) (|v / s| < 128: |v| <= absmax,
// s >= absmax / 127 rounded down, so |n| <= 127 and no clip is needed).
// y = fma(v, r, magic) holds n, d = fma(v, r, -n) is p - n to 2^-26, and
// the bound 1/2 - 2^-23 (|n| + 2) to 2^-26.  Where |d| is below it (p
// farther than 2^-23 (|n| + 1.75) from every half-integer) the quotient
// rounds to n too: this gives y's bits and true; else (p near a
// half-integer, or NaN: v or s not finite) false, with n and d for
// quantize_near_half.
__device__ __forceinline__ bool quantize_by_reciprocal(float v, float r, unsigned& bits, float& n,
                                                       float& d) {
  const float y = __fmaf_rn(v, r, kRoundMagic);
  n = __fsub_rn(y, kRoundMagic);
  d = __fmaf_rn(v, r, -n);
  bits = __float_as_uint(y);
  return fabsf(d) < __fmaf_rn(fabsf(n), -0x1p-23f, 0.5f - 0x1p-22f);
}

// the plain version's q, by the IEEE quotient (NaN clips to -127), as the
// bits of kRoundMagic + q
__device__ __forceinline__ unsigned quantize_exact(float v, float s) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f), kRoundMagic));
}

// The same where p = v * r lies near the half-integer h = n + sign(d) / 2,
// without a division: the quotient's rint is h -+ 1/2 as fl(v / s) falls
// below or above h, and rint(h) (half to even) where fl(v / s) = h.  For 1
// < |h| < 128, h's neighbours are ulp(h) away on both sides and h's
// mantissa is even, so fl(v / s) = h exactly where |v - h s| <= T = s ulp(h)
// / 2 (exact: s times a power of two).  v and h s are multiples of ulp(s) /
// 2, which ulp(T) = ulp(s) ulp(h) / 2 divides, so v - h s is a multiple of
// ulp(T), and rem = fma(-h, s, v), v - h s rounded once, keeps its sign and
// its side of T.  |h| = 1/2 (a power of two) and NaN take the division.
__device__ __forceinline__ unsigned quantize_near_half(float v, float s, float n, float d) {
  const float h = __fadd_rn(n, copysignf(0.5f, d));
  if (!(fabsf(h) > 1.f && fabsf(h) < 128.f)) return quantize_exact(v, s);
  const float half_ulp = __int_as_float((__float_as_int(fabsf(h)) & 0x7f800000) - (24 << 23));
  const float rem = __fmaf_rn(-h, s, v);
  const float q = fabsf(rem) <= __fmul_rn(s, half_ulp) ? rintf(h)
                  : rem < 0.f                           ? __fsub_rn(h, 0.5f)
                                                        : __fadd_rn(h, 0.5f);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), kRoundMagic));
}

// the low bytes of four words, in order, as one word
__device__ __forceinline__ unsigned pack_bytes(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// one TMA bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, completing on the barrier, which expects them
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar,
                                          uint64_t policy) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint [%0], [%1], %2, "
      "[%3], %4;" ::"r"(d), "l"(src), "r"(bytes), "r"(b), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void barrier_wait(uint64_t* bar, unsigned phase) {
  const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(b), "r"(phase)
        : "memory");
  } while (!done);
}

// The quantisation's shared memory: the slots' barriers, the block's absmax
// (then its scales; C words), then the slots' tiles, 128-byte aligned.
struct QuantSmem {
  static constexpr int kBarrierBytes = 8 * kMaxSlots;
  static __host__ __device__ int tile_offset(int C) {
    return (kBarrierBytes + C * 4 + 127) / 128 * 128;
  }
};

// Rows of a tile: as many whole rows as fit kTileBytes (at least one).
__host__ __device__ inline int tile_rows(int row_bytes) {
  return kTileBytes / row_bytes > 0 ? kTileBytes / row_bytes : 1;
}

// One launch of a persistent grid (a cooperative launch, one block an SM:
// every block resident, which the runtime checks against the occupancy the
// launcher reads) over contiguous slices of rows, block i's slice rows * i /
// grid to rows * (i + 1) / grid, cut into tiles of whole rows.  The tiles
// stream through a ring of `slots` tiles that fills the block's shared
// memory (tile i in slot i % slots), each a TMA bulk copy completing on its
// slot's barrier; a slot is refilled once every thread has read it.  Thread
// t owns 16-byte words t, t + 1024, ... of every tile (VEC = 16 / sizeof(T)
// channels a word; C / VEC divides 1024, so they are the same channels in
// every tile):
//   pass 1, tiles in order: per-thread absmax in registers, the block's in
//     shared memory (atomicMax of the f32 bits: non-negative floats order as
//     their bit patterns), then one global atomicMax per channel the block
//     saw nonzero.  Tiles that pass 2 reads again are copied with an L2
//     evict-last policy, the last `slots` (which stay in shared memory)
//     evict-first;
//   grid barrier (cooperative_groups: release and acquire at device scope);
//   pass 2, tiles in reverse order: the block reads the absmax once into
//     shared memory and derives the scales (block 0 writes them), each
//     thread its channels' reciprocals; the last `slots` tiles
//     are still in shared memory, and each slot they free takes an earlier
//     tile again (the most recently read first, most likely still in L2),
//     so its copy overlaps the work on the resident tiles; the table goes
//     out in streaming stores.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads, 1)
q8_table_kernel(const T* __restrict__ value, unsigned* __restrict__ absmax,
                int8_t* __restrict__ table, float* __restrict__ scale, int64_t rows, int C,
                int slots) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned* block_max = reinterpret_cast<unsigned*>(smem + QuantSmem::kBarrierBytes);
  unsigned char* tiles = smem + QuantSmem::tile_offset(C);
  const int row_bytes = C * static_cast<int>(sizeof(T));
  const int per_tile = tile_rows(row_bytes);
  const int tile_bytes = per_tile * row_bytes;
  const int64_t r0 = rows * blockIdx.x / gridDim.x, r1 = rows * (blockIdx.x + 1) / gridDim.x;
  const int ntiles = static_cast<int>((r1 - r0 + per_tile - 1) / per_tile);
  const int reread = ntiles - slots;  // tiles 0 .. reread - 1 are read again in pass 2
  const int c0 = (threadIdx.x % (C / VEC)) * VEC;
  const int word = threadIdx.x;  // this thread's 16-byte word of each tile

  auto tile_words = [&](int i) {  // 16-byte words of slice tile i
    const int64_t n = r1 - r0 - static_cast<int64_t>(i) * per_tile;
    return static_cast<int>((n < per_tile ? n : per_tile) * row_bytes / 16);
  };
  auto slot = [&](int i) { return tiles + static_cast<int64_t>(i % slots) * tile_bytes; };
  // the copy of tile i into its slot (thread 0 only)
  auto load = [&](int i, uint64_t policy) {
    bulk_load(slot(i), value + (r0 + static_cast<int64_t>(i) * per_tile) * C, tile_words(i) * 16,
              bars + i % slots, policy);
  };
  uint64_t parity = 0;  // bit k: the parity of slot k's next completed copy
  auto wait = [&](int i) {
    const int k = i % slots;
    barrier_wait(bars + k, static_cast<unsigned>(parity >> k) & 1u);
    parity ^= uint64_t{1} << k;
  };

  for (int c = threadIdx.x; c < C; c += kQuantThreads) block_max[c] = 0u;
  if (threadIdx.x == 0) {
    for (int k = 0; k < slots; ++k) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(bars + k)))
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const uint64_t keep_policy = l2_policy_evict_last(), last_policy = l2_policy_evict_first();
  if (threadIdx.x == 0) {
    for (int i = 0; i < ntiles && i < slots; ++i) load(i, i < reread ? keep_policy : last_policy);
  }

  // pass 1
  float m[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) m[k] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    wait(i);
#pragma unroll
    for (int w = word; w < kTileWords; w += kQuantThreads) {
      if (w < tile_words(i)) {
        const uint4 raw = reinterpret_cast<const uint4*>(slot(i))[w];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < VEC; ++k) m[k] = fmaxf(m[k], fabsf(to_float(e[k])));
      }
    }
    if (i + slots < ntiles) {
      __syncthreads();  // the slot is read: refill it
      if (threadIdx.x == 0) load(i + slots, i + slots < reread ? keep_policy : last_policy);
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (m[k] > 0.f) atomicMax(block_max + c0 + k, __float_as_uint(m[k]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kQuantThreads) {
    if (block_max[c]) atomicMax(absmax + c, block_max[c]);
  }

  cooperative_groups::this_grid().sync();

  // pass 2: the scales, read from L2 once per block (every thread reading
  // the same C words there would queue on a few L2 slices)
  float* block_scale = reinterpret_cast<float*>(block_max);
  for (int c = threadIdx.x; c < C; c += kQuantThreads) {
    const float sc = channel_scale(__ldcg(absmax + c));
    block_scale[c] = sc;
    if (blockIdx.x == 0) scale[c] = sc;
  }
  __syncthreads();
  float r[VEC];  // the reciprocals of this thread's channels' scales
#pragma unroll
  for (int k = 0; k < VEC; ++k) r[k] = __frcp_rn(block_scale[c0 + k]);
  auto store = [&](int i, int w, uint2 packed) {  // word w of tile i's table rows
    int8_t* out = table + (r0 + static_cast<int64_t>(i) * per_tile) * C + static_cast<int64_t>(w) * VEC;
    if constexpr (VEC == 8) {
      __stcs(reinterpret_cast<uint2*>(out), packed);
    } else {
      __stcs(reinterpret_cast<unsigned*>(out), packed.x);
    }
  };
  auto put_word = [&](int i, int w) {  // word w of tile i, quantised into the table
    if (w >= tile_words(i)) return;
    const uint4 raw = reinterpret_cast<const uint4*>(slot(i))[w];
    const T* e = reinterpret_cast<const T*>(&raw);
    unsigned q[8] = {};
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float x = to_float(e[k]);
      float n, d;
      if (!quantize_by_reciprocal(x, r[k], q[k], n, d)) {
        q[k] = quantize_near_half(x, block_scale[c0 + k], n, d);
      }
    }
    store(i, w, make_uint2(pack_bytes(q[0], q[1], q[2], q[3]), pack_bytes(q[4], q[5], q[6], q[7])));
  };
  auto put = [&](int i) {  // this thread's words of tile i
#pragma unroll
    for (int w = word; w < kTileWords; w += kQuantThreads) put_word(i, w);
  };
  for (int i = ntiles - 1; i >= 0; --i) {
    if (i < reread) wait(i);
    put(i);
    if (i - slots >= 0) {
      __syncthreads();  // the slot is read: give it the tile `slots` earlier
      if (threadIdx.x == 0) load(i - slots, last_policy);
    }
  }
}

// The 4 int8 of a word -> f32 without int-to-float conversions (a quarter
// of the FP32 rate on this card): byte b ^ 0x80 = q + 128 is placed in the
// mantissa of 2^23 by one byte permute, and 2^23 + 128 is subtracted, exactly.
__device__ __forceinline__ void bytes_to_float(unsigned word, float* v) {
  const unsigned biased = word ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  }
}

// CPL consecutive int8 at p (aligned to CPL bytes) -> f32
template <int CPL>
__device__ __forceinline__ void load_q8(const int8_t* __restrict__ p, float (&v)[CPL]) {
  if constexpr (CPL == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    bytes_to_float(raw.x, v);
    bytes_to_float(raw.y, v + 4);
    bytes_to_float(raw.z, v + 8);
    bytes_to_float(raw.w, v + 12);
  } else if constexpr (CPL == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    bytes_to_float(raw.x, v);
    bytes_to_float(raw.y, v + 4);
  } else if constexpr (CPL == 4) {
    bytes_to_float(__ldg(reinterpret_cast<const unsigned*>(p)), v);
  } else {
    static_assert(CPL == 2 || CPL == 1, "a lane holds 16, 8, 4, 2 or 1 int8 channels");
#pragma unroll
    for (int i = 0; i < CPL; ++i) v[i] = static_cast<float>(__ldg(p + i));
  }
}

// a float rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// s + w * v for a corner weight w (rounded to T) and an int8 value v.  In
// bf16 w has 8 significant bits and v 7, so w * v is exact in f32 (also
// below the normal range: it is a multiple of 2^-133) and one fused
// multiply-add rounds exactly as the plain version's multiply, then add
// (tests/test_torch_port_msda_q8_fma.py checks every such product).  An
// f32 w is not short enough: there the multiply and the add stay apart.
template <typename T>
__device__ __forceinline__ float corner_add(float s, float w, float v) {
  if constexpr (sizeof(T) == 2) {
    return fmaf(w, v, s);
  } else {
    return __fadd_rn(s, __fmul_rn(w, v));
  }
}

// LPQ lanes serve one (b, q), each CPL = C / LPQ channels inside one head
// (one load of CPL bytes per corner); a warp serves 32 / LPQ queries.  A
// point's 4 corners are taken without branches: a corner outside its level
// reads the level's clamped row with weight 0, which adds +-0 to the sum and
// changes nothing (the sum is never -0, and the table holds no NaN or inf),
// so the loads of a point are in flight together.  The head's attention
// weight times the bf16-rounded corner sum stays a separate multiply and add:
// that product of two bf16 values can fall below the f32 normal range,
// where a fused multiply-add would round otherwise.
template <typename T, int CPL, int LPQ>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_q8_sample_kernel(const int8_t* __restrict__ table, const float* __restrict__ scale,
                      const LevelTable levels, const float* __restrict__ loc,
                      const float* __restrict__ attn, T* __restrict__ out, int B, int S, int Q,
                      int H, int P) {
  constexpr int kQueriesPerWarp = 32 / LPQ;
  constexpr int C = CPL * LPQ;
  const int lane = threadIdx.x & 31;
  const int64_t bq = (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32) *
                         kQueriesPerWarp + lane / LPQ;
  if (bq >= static_cast<int64_t>(B) * Q) return;
  const int L = levels.num_levels;
  const int b = static_cast<int>(bq / Q);
  const int c0 = (lane % LPQ) * CPL;
  const int h = c0 / (C / H);
  const float* loc_q = loc + bq * L * P * 2;
  const float* attn_q = attn + (bq * H + h) * L * P;
  const int8_t* table_b = table + static_cast<int64_t>(b) * S * C + c0;

  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
  for (int l = 0; l < L; ++l) {
    const int lh = levels.h[l], lw = levels.w[l], ls = levels.start[l];
#pragma unroll 4
    for (int p = 0; p < P; ++p) {
      const float2 xy = __ldg(reinterpret_cast<const float2*>(loc_q) + l * P + p);
      const float a = round_to<T>(__ldg(attn_q + l * P + p));
      // clamping to [-2, size + 1] changes no corner's validity
      const float x = fminf(fmaxf(pixel_coord(xy.x, lw), -2.f), lw + 1.f);
      const float y = fminf(fmaxf(pixel_coord(xy.y, lh), -2.f), lh + 1.f);
      const float x0f = floorf(x), y0f = floorf(y);
      const float fx = __fsub_rn(x, x0f), fy = __fsub_rn(y, y0f);
      const int x0 = static_cast<int>(x0f), y0 = static_cast<int>(y0f);
      float w[4], v[4][CPL];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        const float wy = dy ? fy : __fsub_rn(1.f, fy);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          const bool valid = cy >= 0 && cy < lh && cx >= 0 && cx < lw;
          const float wc = round_to<T>(__fmul_rn(dx ? fx : __fsub_rn(1.f, fx), wy));
          w[2 * dy + dx] = valid ? wc : 0.f;
          const int row = ls + min(max(cy, 0), lh - 1) * lw + min(max(cx, 0), lw - 1);
          load_q8<CPL>(table_b + static_cast<int64_t>(row) * C, v[2 * dy + dx]);
        }
      }
      float s[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) s[i] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) s[i] = corner_add<T>(s[i], w[c], v[c][i]);
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(a, round_to<T>(s[i])));
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = __fmul_rn(acc[i], __ldg(scale + c0 + i));
  store_chunk<T, CPL>(out + bq * C + c0, acc);
}

// The persistent grid: one block an SM (all the grid resident at the
// largest shared memory a block may take, by the occupancy API), each with
// as many ring slots as its shared memory holds, launched
// cooperatively, so that the runtime refuses the launch rather than let the
// grid barrier wait on a block that never runs.  The device's figures and
// the kernel's attribute are read once per device and dtype.
template <typename T>
int quantize(const void* value, void* absmax, void* table, void* scale, int64_t rows, int C,
             cudaStream_t s) {
  static int grid_of[kMaxDevices], smem_of[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (grid_of[device] == 0) {
    // residency at the most shared memory a block may take, so at any less
    int sms = 0, smem = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(q8_table_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q8_table_kernel<T>, kQuantThreads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    smem_of[device] = smem;
    grid_of[device] = sms * per_sm;
  }
  const int row_bytes = C * static_cast<int>(sizeof(T));
  const int tile_bytes = tile_rows(row_bytes) * row_bytes;
  int slots = (smem_of[device] - QuantSmem::tile_offset(C)) / tile_bytes;
  if (slots > kMaxSlots) slots = kMaxSlots;
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = QuantSmem::tile_offset(C) + static_cast<size_t>(slots) * tile_bytes;
  const T* v = static_cast<const T*>(value);
  unsigned* m = static_cast<unsigned*>(absmax);
  int8_t* q = static_cast<int8_t*>(table);
  float* sc = static_cast<float*>(scale);
  void* args[] = {&v, &m, &q, &sc, &rows, &C, &slots};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(q8_table_kernel<T>), dim3(grid_of[device]),
                                    dim3(kQuantThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPL, int LPQ>
void launch_sample(const void* table, const void* scale, const LevelTable& levels, const void* loc,
                   const void* attn, void* out, int B, int S, int Q, int H, int P,
                   cudaStream_t s) {
  const int64_t per_block = static_cast<int64_t>(kWarpsPerBlock) * (32 / LPQ);
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(B) * Q + per_block - 1) / per_block);
  msda_q8_sample_kernel<T, CPL, LPQ><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int8_t*>(table), static_cast<const float*>(scale), levels,
      static_cast<const float*>(loc), static_cast<const float*>(attn), static_cast<T*>(out), B, S,
      Q, H, P);
}

template <typename T, int CPL>
int dispatch_lanes(const void* table, const void* scale, const LevelTable& levels, const void* loc,
                   const void* attn, void* out, int B, int S, int Q, int C, int H, int P,
                   cudaStream_t s) {
  switch (C / CPL) {
    case 1: launch_sample<T, CPL, 1>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 2: launch_sample<T, CPL, 2>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 4: launch_sample<T, CPL, 4>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 8: launch_sample<T, CPL, 8>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 16: launch_sample<T, CPL, 16>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 32: launch_sample<T, CPL, 32>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// channels a lane holds: the largest of 16, 8, 4, 2, 1 that divides a
// head's slice C / H; 0 where the layout does not fit (C / CPL lanes must
// divide 32)
inline int sample_lane_channels(int C, int H) {
  if (C <= 0 || H <= 0 || C % H) return 0;
  int cpl = 16;
  while ((C / H) % cpl) cpl /= 2;
  if (C / cpl > 32 || 32 % (C / cpl)) return 0;
  return cpl;
}

template <typename T>
int dispatch_sample(const void* table, const void* scale, const LevelTable& levels,
                    const void* loc, const void* attn, void* out, int B, int S, int Q, int C,
                    int H, int P, cudaStream_t s) {
  switch (sample_lane_channels(C, H)) {
    case 16: return dispatch_lanes<T, 16>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
    case 8: return dispatch_lanes<T, 8>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
    case 4: return dispatch_lanes<T, 4>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
    case 2: return dispatch_lanes<T, 2>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
    case 1: return dispatch_lanes<T, 1>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// value (rows, C) f32 or bf16; absmax a zeroed (C,) u32 scratch (left
// holding the absmax bits); table (rows, C) int8 and scale (C,) f32 are
// written.  One cooperative launch.
extern "C" int msda_q8_quantize(const void* value, int value_is_bf16, void* absmax, void* table,
                                void* scale, int64_t rows, int C, void* stream) {
  if (C <= 0 || C % 8 || 256 % (C / 8) || rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16) return quantize<__nv_bfloat16>(value, absmax, table, scale, rows, C, s);
  return quantize<float>(value, absmax, table, scale, rows, C, s);
}

// table (B, S, C) int8, scale (C,) f32, loc (B, Q, L, P, 2) f32, attn (B, Q,
// H, L, P) f32 -> out (B, Q, C) in bf16 (out_is_bf16) or f32.
extern "C" int msda_q8_sample(const void* table, const void* scale, LevelTable levels,
                              const void* loc, const void* attn, void* out, int out_is_bf16,
                              int B, int S, int Q, int C, int H, int P, void* stream) {
  if (sample_lane_channels(C, H) == 0 || levels.num_levels <= 0 || levels.num_levels > kLevelsMax ||
      level_table_tokens(levels) != S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<int64_t>(B) * Q == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16) {
    return dispatch_sample<__nv_bfloat16>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
  }
  return dispatch_sample<float>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
}
