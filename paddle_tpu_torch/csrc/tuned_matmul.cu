// Float32 GEMM variants for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/tuning/variants.py _mm_block (line 70),
// _mm_ln_block (line 88) and _mm_dr_block (line 110), reached through
// tuned_matmul (line 129) and its pl.pallas_call. C = epilogue(A.B) for
// A [M, K], B [K, N] float32, C float32, with one of three epilogues:
//   none:             C = acc
//   layer_norm:       each row of acc normalized (mean, then the mean of
//                     squared deviations, rsqrt(var + 1e-5)), times
//                     gamma [N], plus beta [N]; the block owns whole
//                     rows, so BN == N
//   dropout_residual: C = acc * mask * (1 / 0.9) + residual, mask and
//                     residual float32 [M, N]
// Float32 stays float32: SIMT fused multiply-adds, no TF32, no tensor
// cores (the port keeps float32 products in full float32).
//
// Design. The TPU kernel's blocking (bm, bn, bk) is its search space;
// here a variant is a CUDA block tile (BM, BN, BK) with a per-thread
// register tile (TM, TN) and 256 threads. Each block stages a BM x BK
// slice of A (transposed, so a thread reads its TM rows contiguously)
// and a BK x BN slice of B in shared memory per K step, loops over K
// inside the block (the TPU's sequential K axis), and applies the
// epilogue to its registers before the one write of C. A thread's TN
// columns are TN/4 groups of 4, the groups BN/(TN/4) apart, so that a
// warp's float4 reads of B and writes of C touch neighbouring addresses.
// The layer_norm epilogue reduces each row across the threads that hold
// it through a small shared table (BM x BN/TN partial sums), so the
// BM x N tile never leaves registers: small BM (16 or 32) keeps a whole
// 512-wide row in one block.
//
// The variants, each instantiated below (kernel name, epilogues):
//   GEMM tiles, epilogues none and dropout_residual:
//     64x64x16 (4x4), 128x64x16 (8x4), 128x128x8 (8x8)
//   row tiles, epilogue layer_norm (BN == N):
//     16x256x16 (2x8), 32x256x8 (4x8), 16x512x8 (4x8), 32x512x8 (8x8)
//
// What bounds it on this card: operations. One serving forward's 97
// GEMMs are 989 GFLOP: 14.8 ms at 67 TFLOP/s, the float32 peak outside
// the tensor cores; their operands and outputs move ~2 GB (0.6 ms). This
// first version has no double buffering of the shared tiles.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr float LN_EPS = 1e-5f;
constexpr float INV_KEEP = 1.0f / 0.9f;   // dropout keep probability 0.9

enum Epilogue { EPI_NONE = 0, EPI_LN = 1, EPI_DR = 2 };

template <int BM, int BN, int BK, int TM, int TN, int EPI>
__global__ void __launch_bounds__(NTHREADS)
    mm_kernel(const float* __restrict__ A, const float* __restrict__ B,
              float* __restrict__ C, int M, int N, int K,
              const float* __restrict__ p0, const float* __restrict__ p1) {
  constexpr int NTX = BN / TN;              // threads along a row of C
  constexpr int NG = TN / 4;                // column groups of a thread
  constexpr int GSTRIDE = BN / NG;          // distance between the groups
  static_assert(NTX * (BM / TM) == NTHREADS, "256 threads a block");
  static_assert(TN % 4 == 0 && BK % 4 == 0, "float4 staging");
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK / 4; i += NTHREADS) {
      const int r = i / (BK / 4), c = (i % (BK / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(
          A + static_cast<size_t>(m0 + r) * K + k0 + c);
      As[c][r] = v.x;
      As[c + 1][r] = v.y;
      As[c + 2][r] = v.z;
      As[c + 3][r] = v.w;
    }
    for (int i = tid; i < BK * BN / 4; i += NTHREADS) {
      const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[r][c]) =
          *reinterpret_cast<const float4*>(
              B + static_cast<size_t>(k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int q = 0; q < NG; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[kk][q * GSTRIDE + tx * 4]);
        b[q * 4] = v.x;
        b[q * 4 + 1] = v.y;
        b[q * 4 + 2] = v.z;
        b[q * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float mu[TM], rstd[TM];   // row statistics (layer_norm only)
  if constexpr (EPI == EPI_LN) {
    // over the block's full rows (BN == N)
    __shared__ float part[BM][NTX + 1];
    __shared__ float stat[BM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) s += acc[i][j];
      part[ty * TM + i][tx] = s;
    }
    __syncthreads();
    if (tid < BM) {
      float s = 0.f;
      for (int x = 0; x < NTX; ++x) s += part[tid][x];
      stat[tid] = s / BN;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      mu[i] = stat[ty * TM + i];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float d = acc[i][j] - mu[i];
        s += d * d;
      }
      part[ty * TM + i][tx] = s;
    }
    __syncthreads();
    if (tid < BM) {
      float s = 0.f;
      for (int x = 0; x < NTX; ++x) s += part[tid][x];
      stat[tid] = rsqrtf(s / BN + LN_EPS);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i) rstd[i] = stat[ty * TM + i];
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int col = n0 + q * GSTRIDE + tx * 4;
      const size_t at = static_cast<size_t>(row) * N + col;
      float o[4] = {acc[i][q * 4], acc[i][q * 4 + 1], acc[i][q * 4 + 2],
                    acc[i][q * 4 + 3]};
      if constexpr (EPI == EPI_LN) {
        const float4 g = *reinterpret_cast<const float4*>(p0 + col);
        const float4 b = *reinterpret_cast<const float4*>(p1 + col);
        const float gg[4] = {g.x, g.y, g.z, g.w};
        const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = (o[e] - mu[i]) * rstd[i] * gg[e] + bb[e];
      } else if constexpr (EPI == EPI_DR) {
        const float4 mk = *reinterpret_cast<const float4*>(p0 + at);
        const float4 rs = *reinterpret_cast<const float4*>(p1 + at);
        const float mm[4] = {mk.x, mk.y, mk.z, mk.w};
        const float rr[4] = {rs.x, rs.y, rs.z, rs.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = __fadd_rn(__fmul_rn(__fmul_rn(o[e], mm[e]), INV_KEEP),
                           rr[e]);
      }
      *reinterpret_cast<float4*>(C + at) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN, int EPI>
int launch(const float* A, const float* B, float* C, int M, int N, int K,
           const float* p0, const float* p1, cudaStream_t stream) {
  if (M % BM || N % BN || K % BK || M / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (EPI == EPI_LN && N != BN) return static_cast<int>(cudaErrorInvalidValue);
  if (EPI != EPI_NONE && (p0 == nullptr || p1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  mm_kernel<BM, BN, BK, TM, TN, EPI>
      <<<dim3(N / BN, M / BM), NTHREADS, 0, stream>>>(A, B, C, M, N, K, p0,
                                                        p1);
  return static_cast<int>(cudaGetLastError());
}

// (BM, BN, BK, TM, TN, epilogue) of every instantiated variant
#define PT_TUNED_VARIANTS(X)      \
  X(64, 64, 16, 4, 4, EPI_NONE)   \
  X(128, 64, 16, 8, 4, EPI_NONE)  \
  X(128, 128, 8, 8, 8, EPI_NONE)  \
  X(64, 64, 16, 4, 4, EPI_DR)     \
  X(128, 64, 16, 8, 4, EPI_DR)    \
  X(128, 128, 8, 8, 8, EPI_DR)    \
  X(16, 256, 16, 2, 8, EPI_LN)    \
  X(32, 256, 8, 4, 8, EPI_LN)     \
  X(16, 512, 8, 4, 8, EPI_LN)     \
  X(32, 512, 8, 8, 8, EPI_LN)

}  // namespace

// C [M, N] = epilogue(A [M, K] . B [K, N]) under variant (bm, bn, bk);
// epilogue 0 none, 1 layer_norm (p0 gamma [N], p1 beta [N]), 2
// dropout_residual (p0 mask [M, N], p1 residual [M, N]). All float32,
// 16-byte aligned. Returns cudaErrorInvalidValue for a variant that is
// not instantiated or dims it does not divide, else the launch's
// cudaError_t.
extern "C" int pt_tuned_matmul(const void* A, const void* B, void* C, int M,
                               int N, int K, int bm, int bn, int bk,
                               int epilogue, const void* p0, const void* p1,
                               void* stream) {
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* c = static_cast<float*>(C);
  const float* q0 = static_cast<const float*>(p0);
  const float* q1 = static_cast<const float*>(p1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_DISPATCH(BM, BN, BK, TM, TN, EPI)                          \
  if (bm == BM && bn == BN && bk == BK && epilogue == EPI)            \
    return launch<BM, BN, BK, TM, TN, EPI>(a, b, c, M, N, K, q0, q1, s);
  PT_TUNED_VARIANTS(PT_DISPATCH)
#undef PT_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Writes (bm, bn, bk, epilogue) of up to `cap` instantiated variants to
// out (4 ints each); returns how many there are.
extern "C" int pt_tuned_matmul_variants(int* out, int cap) {
  int n = 0;
#define PT_LIST(BM, BN, BK, TM, TN, EPI) \
  if (n < cap) {                         \
    out[4 * n] = BM;                     \
    out[4 * n + 1] = BN;                 \
    out[4 * n + 2] = BK;                 \
    out[4 * n + 3] = EPI;                \
  }                                      \
  ++n;
  PT_TUNED_VARIANTS(PT_LIST)
#undef PT_LIST
  return n;
}
