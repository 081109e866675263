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
// What bounds it on an H100: the sampler's gathers, as in K1 (msda.cu): at
// the flagship's first encoder layer (B=4, Q=11403, L=P=4, C=256) each query
// reads 64 corner rows of 256 B (int8), half K1's bytes, from a 22.9 MB table
// that fits the 50 MB L2.  The quantisation reads the value once for the
// absmax and once for the table.
//
// What this simple design does about it: K1's G = 1 layout, one warp per (b,
// q) with the lanes over channels (8 int8 channels, one 8-byte load, per lane
// at C = 256), each corner row one coalesced 256 B request serving all
// heads; the int8 -> f32 conversion is a byte permute and a subtraction.
// Both quantisation passes run blocks over tiles of rows with a thread per 8
// channels (16 B loads in bf16, 8 B int8 stores; the channels' scales in
// registers): the absmax pass reduces its tile in shared memory and ends in
// one atomicMax of the f32 bits per channel (non-negative floats order as
// their bit patterns), the table pass derives the scales from the absmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"
#include "msda_common.cuh"

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kQuantThreads = 256;
constexpr int kQuantChannels = 8;  // channels of a thread: 16 B of bf16, one 8 B int8 store

__device__ __forceinline__ float channel_scale(unsigned absmax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(absmax_bits), 127.f), 1e-20f);
}

// Both passes: a block takes kRowsPerBlock rows; thread t owns the 8
// channels of chunk t % (C / 8) and walks the rows t / (C / 8), + 256 / (C /
// 8), ...  (C / 8 divides 256, so a thread keeps its chunk).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
q8_absmax_kernel(const T* __restrict__ value, unsigned* __restrict__ absmax, int64_t rows, int C) {
  extern __shared__ unsigned block_max[];  // (C,)
  const int chunks = C / kQuantChannels;
  for (int c = threadIdx.x; c < C; c += blockDim.x) block_max[c] = 0u;
  __syncthreads();
  const int c0 = (threadIdx.x % chunks) * kQuantChannels;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t r1 = r0 + kRowsPerBlock < rows ? r0 + kRowsPerBlock : rows;
  float m[kQuantChannels];
#pragma unroll
  for (int i = 0; i < kQuantChannels; ++i) m[i] = 0.f;
#pragma unroll 4
  for (int64_t r = r0 + threadIdx.x / chunks; r < r1; r += blockDim.x / chunks) {
    float v[kQuantChannels];
    load_chunk<T, kQuantChannels>(value + r * C + c0, v);
#pragma unroll
    for (int i = 0; i < kQuantChannels; ++i) m[i] = fmaxf(m[i], fabsf(v[i]));
  }
#pragma unroll
  for (int i = 0; i < kQuantChannels; ++i) atomicMax(block_max + c0 + i, __float_as_uint(m[i]));
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) atomicMax(absmax + c, block_max[c]);
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
q8_table_kernel(const T* __restrict__ value, const unsigned* __restrict__ absmax,
                int8_t* __restrict__ table, float* __restrict__ scale, int64_t rows, int C) {
  const int chunks = C / kQuantChannels;
  const int c0 = (threadIdx.x % chunks) * kQuantChannels;
  float s[kQuantChannels];
#pragma unroll
  for (int i = 0; i < kQuantChannels; ++i) s[i] = channel_scale(__ldg(absmax + c0 + i));
  if (blockIdx.x == 0 && threadIdx.x < chunks) {
#pragma unroll
    for (int i = 0; i < kQuantChannels; ++i) scale[c0 + i] = s[i];
  }
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t r1 = r0 + kRowsPerBlock < rows ? r0 + kRowsPerBlock : rows;
#pragma unroll 4
  for (int64_t r = r0 + threadIdx.x / chunks; r < r1; r += blockDim.x / chunks) {
    float v[kQuantChannels];
    load_chunk<T, kQuantChannels>(value + r * C + c0, v);
    int8_t q[kQuantChannels];
#pragma unroll
    for (int i = 0; i < kQuantChannels; ++i) {
      q[i] = static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(v[i], s[i])), -127.f), 127.f));
    }
    *reinterpret_cast<uint2*>(table + r * C + c0) = *reinterpret_cast<const uint2*>(q);
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
  if constexpr (CPL == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    bytes_to_float(raw.x, v);
    bytes_to_float(raw.y, v + 4);
  } else if constexpr (CPL == 4) {
    bytes_to_float(__ldg(reinterpret_cast<const unsigned*>(p)), v);
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) v[i] = static_cast<float>(p[i]);
  }
}

// a float rounded to T and back
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_q8_sample_kernel(const int8_t* __restrict__ table, const float* __restrict__ scale,
                      const LevelTable levels, const float* __restrict__ loc,
                      const float* __restrict__ attn, T* __restrict__ out, int B, int S, int Q,
                      int H, int P) {
  const int64_t bq = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (bq >= static_cast<int64_t>(B) * Q) return;
  const int lane = threadIdx.x & 31;
  const int C = 32 * CPL;
  const int L = levels.num_levels;
  const int b = static_cast<int>(bq / Q);
  const int c0 = lane * CPL;
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
      float s[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) s[i] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int cy = y0 + dy;
        if (cy < 0 || cy >= lh) continue;
        const float wy = dy ? fy : __fsub_rn(1.f, fy);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int cx = x0 + dx;
          if (cx < 0 || cx >= lw) continue;
          const float w = round_to<T>(__fmul_rn(dx ? fx : __fsub_rn(1.f, fx), wy));
          float v[CPL];
          load_q8<CPL>(table_b + static_cast<int64_t>(ls + cy * lw + cx) * C, v);
#pragma unroll
          for (int i = 0; i < CPL; ++i) s[i] = __fadd_rn(s[i], __fmul_rn(w, v[i]));
        }
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(a, round_to<T>(s[i])));
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = __fmul_rn(acc[i], __ldg(scale + c0 + i));
  store_chunk<T, CPL>(out + bq * C + c0, acc);
}

template <typename T>
int quantize(const void* value, void* absmax, void* table, void* scale, int64_t rows, int C,
             cudaStream_t s) {
  const T* v = static_cast<const T*>(value);
  unsigned* m = static_cast<unsigned*>(absmax);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  q8_absmax_kernel<T><<<blocks, kQuantThreads, C * sizeof(unsigned), s>>>(v, m, rows, C);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  q8_table_kernel<T><<<blocks, kQuantThreads, 0, s>>>(v, m, static_cast<int8_t*>(table),
                                                       static_cast<float*>(scale), rows, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int CPL>
void launch_sample(const void* table, const void* scale, const LevelTable& levels, const void* loc,
                   const void* attn, void* out, int B, int S, int Q, int H, int P,
                   cudaStream_t s) {
  const int64_t warps = static_cast<int64_t>(B) * Q;
  const unsigned blocks = static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_q8_sample_kernel<T, CPL><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const int8_t*>(table), static_cast<const float*>(scale), levels,
      static_cast<const float*>(loc), static_cast<const float*>(attn), static_cast<T*>(out), B, S,
      Q, H, P);
}

template <typename T>
int dispatch_sample(const void* table, const void* scale, const LevelTable& levels,
                    const void* loc, const void* attn, void* out, int B, int S, int Q, int C,
                    int H, int P, cudaStream_t s) {
  switch (C / 32) {
    case 1: launch_sample<T, 1>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 2: launch_sample<T, 2>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 4: launch_sample<T, 4>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    case 8: launch_sample<T, 8>(table, scale, levels, loc, attn, out, B, S, Q, H, P, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value (rows, C) f32 or bf16; absmax a zeroed (C,) u32 scratch; table (rows,
// C) int8 and scale (C,) f32 are written.  Two launches: the absmax, then the
// table.
extern "C" int msda_q8_quantize(const void* value, int value_is_bf16, void* absmax, void* table,
                                void* scale, int64_t rows, int C, void* stream) {
  if (C <= 0 || C % kQuantChannels || kQuantThreads % (C / kQuantChannels) || rows <= 0) {
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
  if (!shapes_ok(levels, S, C, H, 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(B) * Q == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_is_bf16) {
    return dispatch_sample<__nv_bfloat16>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
  }
  return dispatch_sample<float>(table, scale, levels, loc, attn, out, B, S, Q, C, H, P, s);
}
