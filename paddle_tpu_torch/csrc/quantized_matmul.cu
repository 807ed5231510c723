// Quantized matrix product for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/quantized_matmul.py _qmm_block (line 64),
// reached through quantized_matmul (line 91) and its pl.pallas_call.
// C = A.B for A [M, K], B [K, N] (float32 or bf16, M, N, K multiples of
// 128), float32 out, in one of two modes:
//   int8: every 128x128 tile of A and of B gets one scale
//         s = max(max|tile|, 1e-30) / 127 and is rounded to
//         q = clamp(rint(v / s), -127, 127) (half to even, as jnp.round).
//         Each 128-deep K tile is an exact int32 sum of q products; it is
//         folded into a float32 accumulator as
//         acc = acc + isum * (sx * sy), each operation rounded once, in
//         K order: the TPU kernel's grouping. An int32 tile sum is exact
//         (|sum| <= 128 * 127^2 < 2^24), so this kernel equals its plain
//         version (kernels/quantized_matmul.py) bit for bit.
//   bf16: A and B rounded to bf16 (__float2bfloat16_rn), products summed
//         in float32.
//
// Design. The TPU kernel quantizes each tile inside its sequential
// (M/128, N/128, K/128) grid. Here a pre-pass does it once per tile
// (pack_tile: one block of 1024 threads per 128x128 tile, 16 values a
// thread held in registers: block max, scale, rounding),
// writing A as int8 [M, K] and B transposed as int8 [N, K], so that the
// product reads both operands with K contiguous, as mma.sync wants them.
// The GEMM blocks own 64x64 of C and loop over K inside the block; four
// warps each own 32x32 and issue mma.sync m16n8k32 (s8 x s8 -> s32) or
// m16n8k16 (bf16 x bf16 -> f32) from tiles staged in shared memory. In
// bf16 mode the same pre-pass rounds A (unless it already is bf16) and
// B to bf16.
//
// What bounds it on this card: bytes. At the serving shapes the float32
// output dominates: [8192, 512] x [512, 32000] writes 1.05 GB of C and
// moves 1.13 GB in all, 0.338 ms at 3.35 TB/s, against 0.271 ms of its
// 268 GFLOP at the bf16 tensor-core peak (0.135 ms at the int8 peak).
// This first version is simple: no TMA, no wgmma, no pipelining of the
// shared-memory tiles; each C element is written once, as float2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;          // the quantization tile
constexpr int PACK_THREADS = 1024; // a tile a block, 16 values a thread
constexpr int GBM = 64;            // C rows of a GEMM block
constexpr int GBN = 64;            // C columns of a GEMM block
constexpr int GTHREADS = 128;      // four warps, 2 x 2 of 32 x 32
constexpr int KT8 = TILE;          // int8: one quantization tile of K
constexpr int LD8 = KT8 + 16;      // bytes per staged row (bank spread)
constexpr int KT16 = 64;           // bf16: K per stage
constexpr int LD16 = KT16 + 8;     // bf16 elements per staged row

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One block per 128x128 tile of src [R, C] (row-major). kInt8: scale and
// round to int8 (scale of the tile to scales[tile row * C/128 + tile
// col]); else round to bf16. kTranspose: dst is [C, R], else [R, C].
template <typename Tin, typename Tout, bool kInt8, bool kTranspose>
__global__ void __launch_bounds__(PACK_THREADS)
    pack_tile(const Tin* __restrict__ src, int R, int C,
              Tout* __restrict__ dst, float* __restrict__ scales) {
  constexpr int PER = TILE * TILE / PACK_THREADS;
  constexpr int PAD = 4 / static_cast<int>(sizeof(Tout));
  __shared__ Tout tile[TILE][TILE + PAD];
  __shared__ float red[PACK_THREADS / 32];
  const int tr = blockIdx.y, tc = blockIdx.x, tid = threadIdx.x;
  const Tin* s0 = src + static_cast<size_t>(tr) * TILE * C +
                  static_cast<size_t>(tc) * TILE;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = i * PACK_THREADS + tid;
    v[i] = to_f32(s0[static_cast<size_t>(e / TILE) * C + e % TILE]);
    amax = fmaxf(amax, fabsf(v[i]));
  }
  float s = 1.f;
  if (kInt8) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if ((tid & 31) == 0) red[tid >> 5] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < PACK_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
    s = __fdiv_rn(fmaxf(amax, 1e-30f), 127.f);
    if (tid == 0) scales[tr * gridDim.x + tc] = s;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = i * PACK_THREADS + tid;
    const int r = e / TILE, c = e % TILE;
    Tout q;
    if constexpr (kInt8) {
      const float t = rintf(__fdiv_rn(v[i], s));
      q = static_cast<Tout>(fminf(fmaxf(t, -127.f), 127.f));
    } else {
      q = __float2bfloat16_rn(v[i]);
    }
    if (kTranspose)
      tile[c][r] = q;
    else
      tile[r][c] = q;
  }
  __syncthreads();
  const int ld = kTranspose ? R : C;
  Tout* d0 = dst + (kTranspose ? static_cast<size_t>(tc) * TILE * R +
                                     static_cast<size_t>(tr) * TILE
                               : static_cast<size_t>(tr) * TILE * C +
                                     static_cast<size_t>(tc) * TILE);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = i * PACK_THREADS + tid;
    d0[static_cast<size_t>(e / TILE) * ld + e % TILE] =
        tile[e / TILE][e % TILE];
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [r0, r0 + 64) x cols [k0, k0 + bytes) of a row-major matrix
// with `ld` bytes a row into a staged tile, 16 bytes a thread.
template <int BYTES, int LDS>
__device__ __forceinline__ void stage(const char* __restrict__ src,
                                      size_t ld, int r0, size_t k0,
                                      char* tile) {
  constexpr int CHUNKS = BYTES / 16;
  for (int i = threadIdx.x; i < GBM * CHUNKS; i += GTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 16;
    *reinterpret_cast<int4*>(tile + r * LDS + c) =
        *reinterpret_cast<const int4*>(src + (r0 + r) * ld + k0 + c);
  }
}

// C [M, N] float32 = sum over K tiles of (qa.qbt^T) * (sa * sb).
// qa int8 [M, K]; qbt int8 [N, K]; sa [M/128, K/128]; sb [K/128, N/128].
__global__ void __launch_bounds__(GTHREADS)
    int8_gemm(const int8_t* __restrict__ qa, const int8_t* __restrict__ qbt,
              const float* __restrict__ sa, const float* __restrict__ sb,
              float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t As[GBM * LD8];
  __shared__ __align__(16) int8_t Bs[GBN * LD8];
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  const int nkt = K / KT8;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    stage<KT8, LD8>(reinterpret_cast<const char*>(qa), K, m0,
                    static_cast<size_t>(kt) * KT8,
                    reinterpret_cast<char*>(As));
    stage<KT8, LD8>(reinterpret_cast<const char*>(qbt), K, n0,
                    static_cast<size_t>(kt) * KT8,
                    reinterpret_cast<char*>(Bs));
    __syncthreads();
    int isum[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) isum[i][j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < KT8; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r = As + (wm + mi * 16 + g) * LD8 + kk + t * 4;
        a[mi][0] = ld32(r);
        a[mi][1] = ld32(r + 8 * LD8);
        a[mi][2] = ld32(r + 16);
        a[mi][3] = ld32(r + 8 * LD8 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c = Bs + (wn + ni * 8 + g) * LD8 + kk + t * 4;
        b[ni][0] = ld32(c);
        b[ni][1] = ld32(c + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(isum[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    // a 64x64 block lies inside one 128x128 scale tile of A and of B
    const float s = __fmul_rn(sa[(m0 / TILE) * nkt + kt],
                              sb[kt * (N / TILE) + n0 / TILE]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(
              acc[i][j][e],
              __fmul_rn(static_cast<float>(isum[i][j][e]), s));
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const size_t row = m0 + wm + mi * 16 + g;
      const int col = n0 + wn + ni * 8 + t * 2;
      *reinterpret_cast<float2*>(out + row * N + col) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (row + 8) * N + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// C [M, N] float32 = a.bt^T; a bf16 [M, K], bt bf16 [N, K].
__global__ void __launch_bounds__(GTHREADS)
    bf16_gemm(const __nv_bfloat16* __restrict__ a16,
              const __nv_bfloat16* __restrict__ bt16,
              float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) __nv_bfloat16 As[GBM * LD16];
  __shared__ __align__(16) __nv_bfloat16 Bs[GBN * LD16];
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KT16) {
    stage<KT16 * 2, LD16 * 2>(reinterpret_cast<const char*>(a16),
                              static_cast<size_t>(K) * 2, m0,
                              static_cast<size_t>(k0) * 2,
                              reinterpret_cast<char*>(As));
    stage<KT16 * 2, LD16 * 2>(reinterpret_cast<const char*>(bt16),
                              static_cast<size_t>(K) * 2, n0,
                              static_cast<size_t>(k0) * 2,
                              reinterpret_cast<char*>(Bs));
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT16; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* r = As + (wm + mi * 16 + g) * LD16 + kk + t * 2;
        a[mi][0] = ld32(r);
        a[mi][1] = ld32(r + 8 * LD16);
        a[mi][2] = ld32(r + 8);
        a[mi][3] = ld32(r + 8 * LD16 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* c = Bs + (wn + ni * 8 + g) * LD16 + kk + t * 2;
        b[ni][0] = ld32(c);
        b[ni][1] = ld32(c + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const size_t row = m0 + wm + mi * 16 + g;
      const int col = n0 + wn + ni * 8 + t * 2;
      *reinterpret_cast<float2*>(out + row * N + col) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (row + 8) * N + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

template <typename Tout, bool kInt8, bool kTranspose>
int pack(const void* src, int src_dtype, int R, int C, void* dst,
         float* scales, cudaStream_t stream) {
  const dim3 grid(C / TILE, R / TILE);
  if (src_dtype == 0)
    pack_tile<float, Tout, kInt8, kTranspose>
        <<<grid, PACK_THREADS, 0, stream>>>(static_cast<const float*>(src),
                                            R, C, static_cast<Tout*>(dst),
                                            scales);
  else
    pack_tile<__nv_bfloat16, Tout, kInt8, kTranspose>
        <<<grid, PACK_THREADS, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(src), R, C,
            static_cast<Tout*>(dst), scales);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [M, N] float32 = x [M, K] . y [K, N]; x_dtype / y_dtype: 0 float32,
// 1 bf16; mode: 0 int8, 1 bf16. Workspace from the caller:
//   int8: wa int8 [M, K], wb int8 [N, K], sa float [M/128, K/128],
//         sb float [K/128, N/128] (the scales, kept for inspection);
//   bf16: wa bf16 [M, K] (NULL: x is bf16 and used as it is, 16-byte
//         aligned), wb bf16 [N, K]; sa, sb unused.
// Returns the first cudaError_t of the launches.
extern "C" int pt_quantized_matmul(const void* x, int x_dtype, const void* y,
                                   int y_dtype, int M, int N, int K,
                                   int mode, void* wa, void* wb, void* sa,
                                   void* sb, void* out, void* stream_ptr) {
  if (M <= 0 || N <= 0 || K <= 0 || M % TILE || N % TILE || K % TILE ||
      x_dtype < 0 || x_dtype > 1 || y_dtype < 0 || y_dtype > 1 ||
      M / GBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(N / GBN, M / GBM);
  int err;
  if (mode == 0) {
    if ((err = pack<int8_t, true, false>(x, x_dtype, M, K, wa,
                                         static_cast<float*>(sa), stream)))
      return err;
    if ((err = pack<int8_t, true, true>(y, y_dtype, K, N, wb,
                                        static_cast<float*>(sb), stream)))
      return err;
    int8_gemm<<<grid, GTHREADS, 0, stream>>>(
        static_cast<const int8_t*>(wa), static_cast<const int8_t*>(wb),
        static_cast<const float*>(sa), static_cast<const float*>(sb),
        static_cast<float*>(out), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  const void* a = x;
  if (wa != nullptr) {
    if ((err = pack<__nv_bfloat16, false, false>(x, x_dtype, M, K, wa,
                                                 nullptr, stream)))
      return err;
    a = wa;
  } else if (x_dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((err = pack<__nv_bfloat16, false, true>(y, y_dtype, K, N, wb, nullptr,
                                              stream)))
    return err;
  bf16_gemm<<<grid, GTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(wb), static_cast<float*>(out), M, N,
      K);
  return static_cast<int>(cudaGetLastError());
}
