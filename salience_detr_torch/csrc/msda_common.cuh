// Shared by the MSDA forward (msda.cu) and backward (msda_backward.cu)
// kernels, the stage kernels and the DCN kernels: the pixel coordinate, the
// shape contract and the f32 <-> storage conversions (f32, bf16, f16) of one
// lane's channel chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "levels.cuh"

// internal linkage: each including source gets its own copy
namespace {

constexpr int kWarpsPerBlock = 8;

// the element-type code of the DCN entry points (deform_conv.cu,
// deform_conv_gemm.cu): x and the tensors in its dtype
constexpr int kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// CPL consecutive elements at p -> f32 registers, in loads as wide as the
// chunk (16 B when CPL * sizeof(T) is a multiple of 16, else one 8 or 4 B
// load; p aligned to that width).
template <typename T, int CPL>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, float (&v)[CPL]) {
  constexpr int kBytes = CPL * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPerVec; ++j) v[i * kPerVec + j] = to_float(e[j]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = to_float(e[j]);
  } else if constexpr (kBytes == 4) {
    const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < CPL; ++j) v[j] = to_float(e[j]);
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) v[i] = to_float(p[i]);
  }
}

template <typename T, int CPL>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, const float (&v)[CPL]) {
  constexpr int kBytes = CPL * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPerVec = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPerVec; ++j) e[j] = from_float<T>(v[i * kPerVec + j]);
      reinterpret_cast<uint4*>(p)[i] = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPL; ++i) p[i] = from_float<T>(v[i]);
  }
}

// loc * size - 0.5 rounded twice, as the plain PyTorch version computes it:
// a contracted fma rounds once, and where a point lies on a pixel centre (the
// encoder's initial sampling grid) the two can fall on either side of an
// integer, which changes floor() and the one-sided derivative the backward
// takes there
__device__ __forceinline__ float pixel_coord(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, static_cast<float>(size)), 0.5f);
}

// the C entry points' shape contract: 32 lanes of CPL = C / 32 channels,
// each lane inside one head (H divides 32), G location groups dividing H
inline bool shapes_ok(const LevelTable& levels, int S, int C, int H, int G) {
  return C > 0 && C % 32 == 0 && H > 0 && C % H == 0 && (C / H) % (C / 32) == 0 && G > 0 &&
         H % G == 0 && levels.num_levels > 0 && levels.num_levels <= kLevelsMax &&
         level_table_tokens(levels) == S;
}

}  // namespace
