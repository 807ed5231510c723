// Pieces shared by the flash-attention forward and backward kernels:
// tile sizes, the TPU kernel's constants, float32 <-> element-type
// conversion and the attention-dropout hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace fa {

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int NTHREADS = 256;      // 16 x 16
constexpr int P_STRIDE = BK + 16;  // row stride of a [64][64] score tile
constexpr float NEG_INF = -1e30f;  // the TPU kernel's finite mask value
constexpr float L_FLOOR = 1e-30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: what a product with T operands reads
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The attention-dropout keep mask of paddle_tpu/kernels/flash_attention.py
// (_hash_keep, dropout_keep_mask): murmur3's finalizer over
// (seed words, batch*H + head, absolute row, absolute column, Sk). It is a
// function of position only, so the forward and both backward kernels,
// whatever their tiles, drop the same weights.
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t head_seed(uint32_t s0, uint32_t s1,
                                              uint32_t bh) {
  return s0 ^ mix32(s1 ^ (bh * 0x9E3779B1u));
}

__device__ __forceinline__ bool keep(uint32_t hseed, int row, int col,
                                     int Sk, int t) {
  const uint32_t pos = static_cast<uint32_t>(row) *
                           static_cast<uint32_t>(Sk) +
                       static_cast<uint32_t>(col);
  return (mix32(pos ^ hseed) & 255u) < static_cast<uint32_t>(t);
}

}  // namespace fa
