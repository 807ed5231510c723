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
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// The staged width of a head dim padded to DPAD: the whole of it up to
// 128, else 128-column chunks (and above 256, 256-column groups of the
// output, one block each).
template <int DPAD>
__host__ __device__ constexpr int chunk() {
  return DPAD <= 128 ? DPAD : 128;
}

// Load rows [r0, r0 + 64) of one head's [S, D] slice into a float32
// [64][ST] tile, columns 0 .. W - 1, zero past S and D (D <= 0: all zero).
// Eight loads a thread are in flight before their stores: the compiler
// cannot move a global load past a store through a generic pointer.
template <typename T, int W, int ST = W + 4>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int r0, int S,
                                          int D) {
  constexpr int PER = 64 * W / NTHREADS;  // elements a thread
  constexpr int BATCH = PER < 8 ? PER : 8;
  static_assert(PER * NTHREADS == 64 * W && PER % BATCH == 0,
                "tile width");
#pragma unroll 1
  for (int i0 = 0; i0 < PER; i0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = (i0 + u) * NTHREADS + threadIdx.x;
      const int r = i / W, d = i % W;
      x[u] = r0 + r < S && d < D ? to_f(src[(r0 + r) * row_stride + d])
                                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = (i0 + u) * NTHREADS + threadIdx.x;
      dst[(i / W) * ST + i % W] = x[u];
    }
  }
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

// head_seed from the two seed words on the card (int64 [2], each holding
// a uint32; null: no dropout, and no mask is drawn). The kernels read the
// words here, so a CUDA graph that captured them draws the masks of the
// words written before each replay.
__device__ __forceinline__ uint32_t head_seed_dev(const int64_t* seed,
                                                  uint32_t bh) {
  return seed == nullptr
             ? 0u
             : head_seed(static_cast<uint32_t>(seed[0]),
                         static_cast<uint32_t>(seed[1]), bh);
}

// pos = row * Sk + col (mod 2^32)
__device__ __forceinline__ bool keep_pos(uint32_t hseed, uint32_t pos,
                                         int t) {
  return (mix32(pos ^ hseed) & 255u) < static_cast<uint32_t>(t);
}

__device__ __forceinline__ bool keep(uint32_t hseed, int row, int col,
                                     int Sk, int t) {
  return keep_pos(hseed,
                  static_cast<uint32_t>(row) * static_cast<uint32_t>(Sk) +
                      static_cast<uint32_t>(col),
                  t);
}

}  // namespace fa
