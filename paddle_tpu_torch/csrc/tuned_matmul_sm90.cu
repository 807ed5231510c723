// Float32 GEMM for Hopper's tensor cores (sm_90a) in 3xTF32, plain C
// interface: wgmma.mma_async and TMA.
//
// Replaces: paddle_tpu/tuning/variants.py _mm_block (line 70),
// _mm_ln_block (line 88) and _mm_dr_block (line 110), reached through
// tuned_matmul (line 129) and their pl.pallas_call (lines 172, 178, 185).
// C = epilogue(A.B) for A [M, K], B [K, N] float32, C float32, with one
// of three epilogues:
//   none:             C = acc
//   layer_norm:       each row of acc normalized (the mean, then the
//                     mean of squared deviations about it,
//                     rsqrt(var + 1e-5)), times gamma [N], plus beta [N];
//                     the block owns whole rows (BN == N)
//   dropout_residual: C = acc * mask * (1/0.9) + residual, mask and
//                     residual float32 [M, N]
//
// What bounds it on this card: operations. Float32 on the CUDA cores caps
// at 67 TFLOP/s (the earlier design, tuned_matmul.cu, reached 59 % of it
// at 8192x512x512). TF32 alone keeps 11 bits and misses float32's
// tolerance; 3xTF32 keeps float32's: each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi), and a product is lo.hi + hi.lo +
// hi.hi (lo.lo, about 2^-22 of it, is dropped; the small terms first, as
// CUTLASS's OpMultiplyAddFastF32). At 8192x512x512 that is 12.9 GFLOP of
// TF32, 26 us at 495 TFLOP/s, against 34.6 MB of A, B and C (10 us;
// dropout_residual reads 33.5 MB more, mask and residual: 10 us).
//
// What the design does about that:
//   * one pre-pass launch writes B^T split, as hi rows [0, N) and lo rows
//     [N, 2N) of bt [2N, K] (tf32 wgmma takes 32-bit shared-memory
//     operands only K-major, and B [K, N] is MN-major): 32x32 tiles
//     through shared memory, read and written a warp row at a time. No
//     copy is kept across calls (a weight may change in place);
//   * the GEMM: one block an SM, each looping over tiles of C in M-fastest
//     order (the blocks at work share B's columns; A, up to 16 MB at the
//     serving shapes, stays in L2). A producer warpgroup (one thread of
//     it at work, its registers handed to the consumers by setmaxnreg)
//     loads A and B^T hi/lo tiles by TMA into a ring of stages (full and
//     empty mbarriers), and runs on into the next tile while the
//     consumers store this one. Two consumer warpgroups (232 registers a
//     thread) issue wgmma m64nNk8 tf32 with A from registers:
//     each splits its A fragment (read as TMA left it, swizzled) into hi
//     and lo, and B hi and lo come from shared memory;
//   * the tensor cores add into their float32 accumulator rounding toward
//     zero (round_probe_kernel below reads it), a bias that over K = 2048
//     grows beyond the float32 tolerance (tests/test_torch_gemm.py models
//     it). So each stage's products (BK deep)
//     start a fresh partial accumulator, added to the running sum by the
//     CUDA cores (round to nearest), as exact as a float32 sum;
//   * a stage is BK = 32 columns of K (one 128-byte swizzled row) or 16
//     (64-byte rows, where BN = 512 leaves room for no second 32-deep
//     stage); tiles: none 128 x BN (a warpgroup 64 rows), layer_norm 64 x
//     N (a warpgroup N/2 columns). A warpgroup's partial covers 128
//     columns, or 64 where it owns 256 (registers: 128 sums, 32 partial,
//     the A fragments);
//   * layer_norm: row sums within a quad by shuffles, then across the two
//     warpgroups through a small shared table; two passes over the
//     registers, the mean and then the squared deviations, as the
//     reference does;
//   * C leaves the registers as 16-byte stores (a lane pair swaps halves
//     of its rows with one shuffle);
//   * dropout_residual: the tiles of none; in the store loop each lane
//     reads one float4 of the mask and one of the residual at the address
//     it stores (streaming loads: read once, kept out of the way of A and
//     B^T in L2), the next store's two loads issued before this one's
//     arithmetic, each operation rounded on its own as in the plain
//     version. The producer runs on into the next tile's TMA loads
//     meanwhile, so those reads overlap the next main loop.
//
// The variants, each instantiated below (BM, BN, BK, epilogue):
//   none, dropout_residual: 128x128x32, 128x256x32, 128x256x16
//   layer_norm:             64x256x32, 64x512x16

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"  // mbarrier, TMA, wgmma, descriptors

namespace {

constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and one producer warpgroup
// registers a thread after setmaxnreg: the producer gives up what the
// consumers take (128 x 40 + 256 x 232 <= 65536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr uint32_t SMEM_MAX = 232448;     // a block's dynamic shared memory
constexpr uint32_t TABLES = 1024;         // layer_norm: [2][2 wg][64] floats
constexpr float LN_EPS = 1e-5f;
constexpr float INV_KEEP = 1.0f / 0.9f;   // dropout keep probability 0.9

enum Epilogue { EPI_NONE = 0, EPI_LN = 1, EPI_DR = 2 };

template <int BM, int BN, int BK, int EPI>
struct Cfg {
  static_assert(BK == 32 || BK == 16, "a stage row is 128 or 64 bytes");
  static_assert(EPI == EPI_LN ? BM == 64 : BM == 128, "tile rows");
  static constexpr int RB = 4 * BK;      // bytes of a tile row (swizzle span)
  static constexpr int KS = BK / 8;      // k8 steps a stage
  // columns a warpgroup owns (layer_norm: the warpgroups split the
  // columns of 64 rows; none: the rows, 64 each, of all BN columns)
  static constexpr int WN = EPI == EPI_LN ? BN / 2 : BN;
  static constexpr int PN = WN > 128 ? 64 : WN;   // columns of a partial
  static constexpr int NP = WN / PN;              // partials a stage
  static constexpr int BOX = BN < 256 ? BN : 256; // rows of a B box
  static constexpr uint32_t A_BYTES = BM * RB;
  static constexpr uint32_t B_BYTES = BN * RB;    // hi; lo follows
  static constexpr uint32_t STAGE = A_BYTES + 2 * B_BYTES;
  static constexpr int FIT = (SMEM_MAX - 1024 - TABLES - 64) / STAGE;
  static constexpr int STAGES = FIT > 4 ? 4 : FIT;
  static_assert(STAGES >= 2, "two stages at least");
  static constexpr uint32_t SMEM = 1024 + STAGES * STAGE + TABLES +
                                   16 * STAGES;
};

struct Params {
  CUtensorMap ta, tb;     // A [M, K]; bt [2N, K] (B^T hi, then lo)
  float* out;
  const float* gamma;     // layer_norm: [N]
  const float* beta;
  const float* mask;      // dropout_residual: [M, N]
  const float* residual;
  int M, N, K;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// part (+)= A . B^T over one k8 step, PN columns of B
template <int PN>
__device__ __forceinline__ void wgmma_tf32(float (&part)[PN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  if constexpr (PN == 128)
    sm90::wgmma_rs_tf32_n128(part, a, db, accumulate);
  else
    sm90::wgmma_rs_tf32(part, a, db, accumulate);
}

template <int BM, int BN, int BK, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    tmm_sm90_kernel(const __grid_constant__ Params p) {
  using C = Cfg<BM, BN, BK, EPI>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (sbase - raw);
  float* const table = reinterpret_cast<float*>(gbase + C::STAGES * C::STAGE);
  const uint32_t bar0 = sbase + C::STAGES * C::STAGE + TABLES;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (C::STAGES + s); };

  const int tid = threadIdx.x;
  const int nk = p.K / BK;
  const int tiles_m = p.M / BM;
  const int n_mine =
      (tiles_m * (p.N / BN) - static_cast<int>(blockIdx.x) +
       static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    // the producer: load g = (i-th tile) * nk + kt into stage g % STAGES
    // once the consumers have released that stage's previous load
    if (tid == CONSUMERS) {
      const int n_loads = n_mine * nk;
      for (int g = 0; g < n_loads; ++g) {
        const int s = g % C::STAGES;
        if (g >= C::STAGES)
          sm90::mbar_wait(empty(s), ((g / C::STAGES) + 1) & 1);
        const int tile = blockIdx.x + (g / nk) * gridDim.x;
        const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
        const int k0 = (g % nk) * BK;
        const uint32_t at = sbase + s * C::STAGE;
        sm90::mbar_expect_tx(full(s), C::STAGE);
        sm90::tma_load_2d(at, &p.ta, full(s), k0, m0);
#pragma unroll
        for (int r = 0; r < BN; r += C::BOX) {
          const uint32_t b = at + C::A_BYTES + r * C::RB;
          sm90::tma_load_2d(b, &p.tb, full(s), k0, n0 + r);
          sm90::tma_load_2d(b + C::B_BYTES, &p.tb, full(s), k0,
                            p.N + n0 + r);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));

  const int wg = tid >> 7;            // consumer warpgroup
  const int warp = (tid >> 5) & 3;    // warp within it
  const int lane = tid & 31;
  const int g8 = lane >> 2, c4 = lane & 3;
  // this thread's rows of the tile: r0 and r0 + 8; its warpgroup's
  // first column of the tile
  const int r0 = (EPI == EPI_LN ? 0 : 64 * wg) + 16 * warp + g8;
  const int wcol = EPI == EPI_LN ? wg * C::WN : 0;

  for (int i = 0; i < n_mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
    // acc[4j + 2h + e]: row r0 + 8h, column wcol + 8j + 2 c4 + e
    float acc[C::WN / 2];
#pragma unroll
    for (int e = 0; e < C::WN / 2; ++e) acc[e] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int g = i * nk + kt;
      const int s = g % C::STAGES;
      sm90::mbar_wait(full(s), (g / C::STAGES) & 1);
      const uint8_t* a_s = gbase + s * C::STAGE;
      const uint32_t b_hi = sbase + s * C::STAGE + C::A_BYTES +
                            wcol * C::RB;
      const uint32_t b_lo = b_hi + C::B_BYTES;
      // the A fragments of the stage's k8 steps, split: a[0] (r0, c4),
      // a[1] (r0 + 8, c4), a[2] (r0, c4 + 4), a[3] (r0 + 8, c4 + 4)
      uint32_t ah[C::KS][4], al[C::KS][4];
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t off = (r0 + 8 * (q & 1)) * C::RB +
                               4 * (8 * kk + c4 + 4 * (q >> 1));
          const float x = *reinterpret_cast<const float*>(
              a_s + sm90::swizzled<C::RB>(off));
          sm90::split_tf32(x, ah[kk][q], al[kk][q]);
        }
#pragma unroll
      for (int pc = 0; pc < C::NP; ++pc) {
        float part[C::PN / 2];
#pragma unroll
        for (int e = 0; e < C::PN / 2; ++e) part[e] = 0.f;
        sm90::fence_regs(part);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::KS; ++kk) {
          const uint32_t off = pc * C::PN * C::RB + kk * 32;
          wgmma_tf32<C::PN>(part, al[kk],
                            sm90::desc_kmajor_rows<C::RB>(b_hi + off), kk);
          wgmma_tf32<C::PN>(part, ah[kk],
                            sm90::desc_kmajor_rows<C::RB>(b_lo + off), 1);
          wgmma_tf32<C::PN>(part, ah[kk],
                            sm90::desc_kmajor_rows<C::RB>(b_hi + off), 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(part);
#pragma unroll
        for (int e = 0; e < C::PN / 2; ++e)
          acc[pc * (C::PN / 2) + e] += part[e];
      }
      sm90::mbar_arrive(empty(s));
    }

    if constexpr (EPI == EPI_LN) {
      // row statistics over the tile's N = BN columns: this thread's
      // sums, its quad's (shuffles), then both warpgroups' (the table)
      float mu[2], rstd[2];
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < C::WN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = acc[4 * j + 2 * h + e];
              if (pass == 0) {
                sum[h] += x;
              } else {
                const float d = x - mu[h];
                sum[h] += d * d;
              }
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
          sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        }
        float* t = table + pass * 128;
        if (c4 == 0) {
          t[wg * 64 + r0] = sum[0];
          t[wg * 64 + r0 + 8] = sum[1];
        }
        consumers_sync();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float tot = t[r0 + 8 * h] + t[64 + r0 + 8 * h];
          if (pass == 0)
            mu[h] = tot / BN;
          else
            rstd[h] = rsqrtf(tot / BN + LN_EPS);
        }
      }
#pragma unroll
      for (int j = 0; j < C::WN / 8; ++j) {
        const int col = n0 + wcol + 8 * j + 2 * c4;
        const float2 gm = *reinterpret_cast<const float2*>(p.gamma + col);
        const float2 bt = *reinterpret_cast<const float2*>(p.beta + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* a = acc + 4 * j + 2 * h;
          a[0] = (a[0] - mu[h]) * rstd[h] * gm.x + bt.x;
          a[1] = (a[1] - mu[h]) * rstd[h] * gm.y + bt.y;
        }
      }
    }

    // Lanes c and c ^ 1 swap: an even lane stores 4 columns of row r0,
    // an odd one 4 of row r0 + 8, as one 16-byte store each.
    const bool odd = lane & 1;
    const size_t at = static_cast<size_t>(m0 + r0 + (odd ? 8 : 0)) * p.N +
                      n0 + wcol + ((2 * c4) & ~3);
    float* orow = p.out + at;
    // dropout_residual: this store's mask and residual, loaded one store
    // ahead
    [[maybe_unused]] float4 mk, rs;
    if constexpr (EPI == EPI_DR) {
      mk = __ldcs(reinterpret_cast<const float4*>(p.mask + at));
      rs = __ldcs(reinterpret_cast<const float4*>(p.residual + at));
    }
#pragma unroll
    for (int j = 0; j < C::WN / 8; ++j) {
      const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
      const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
      const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      float4 v = odd ? make_float4(g0, g1, acc[4 * j + 2], acc[4 * j + 3])
                     : make_float4(acc[4 * j], acc[4 * j + 1], g0, g1);
      if constexpr (EPI == EPI_DR) {
        float4 mk_next = mk, rs_next = rs;
        if (j + 1 < C::WN / 8) {
          mk_next = __ldcs(
              reinterpret_cast<const float4*>(p.mask + at + 8 * (j + 1)));
          rs_next = __ldcs(reinterpret_cast<const float4*>(
              p.residual + at + 8 * (j + 1)));
        }
        v.x = __fadd_rn(__fmul_rn(__fmul_rn(v.x, mk.x), INV_KEEP), rs.x);
        v.y = __fadd_rn(__fmul_rn(__fmul_rn(v.y, mk.y), INV_KEEP), rs.y);
        v.z = __fadd_rn(__fmul_rn(__fmul_rn(v.z, mk.z), INV_KEEP), rs.z);
        v.w = __fadd_rn(__fmul_rn(__fmul_rn(v.w, mk.w), INV_KEEP), rs.w);
        mk = mk_next;
        rs = rs_next;
      }
      *reinterpret_cast<float4*>(orow + 8 * j) = v;
    }
  }
}

// B [K, N] -> bt [2N, K]: row n holds tf32(B[:, n]) (hi), row N + n the
// rest, tf32(B[:, n] - hi) (lo). A block a 32x32 tile, through shared
// memory; K may end inside a tile (N is a multiple of BN).
__global__ void __launch_bounds__(256)
    split_transpose(const float* __restrict__ b, float* __restrict__ bt,
                    int K, int N) {
  __shared__ float t[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int r = ty; r < 32; r += 8)
    if (k0 + r < K) t[r][tx] = b[static_cast<size_t>(k0 + r) * N + n0 + tx];
  __syncthreads();
  if (k0 + tx >= K) return;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    uint32_t hi, lo;
    sm90::split_tf32(t[tx][r], hi, lo);
    const size_t at = static_cast<size_t>(n0 + r) * K + k0 + tx;
    bt[at] = __uint_as_float(hi);
    bt[at + static_cast<size_t>(N) * K] = __uint_as_float(lo);
  }
}

template <int BM, int BN, int BK, int EPI>
int gemm(Params& p, const float* B, float* bt, cudaStream_t stream) {
  using C = Cfg<BM, BN, BK, EPI>;
  if (p.M % BM || p.N % BN || p.K % BK ||
      (EPI == EPI_LN && (p.N != BN || p.gamma == nullptr ||
                         p.beta == nullptr)) ||
      (EPI == EPI_DR &&
       (p.mask == nullptr || p.residual == nullptr ||
        reinterpret_cast<uintptr_t>(p.mask) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(p.residual) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  split_transpose<<<dim3(p.N / 32, (p.K + 31) / 32), 256, 0, stream>>>(
      B, bt, p.K, p.N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr CUtensorMapSwizzle swz =
      BK == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (!sm90::encode_2d(&p.tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, bt,
                       2 * p.N, p.K, BK, C::BOX, swz))
    return static_cast<int>(cudaErrorInvalidValue);
  // A is read by TMA as it lies
  err = cudaFuncSetAttribute(tmm_sm90_kernel<BM, BN, BK, EPI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = (p.M / BM) * (p.N / BN);
  tmm_sm90_kernel<BM, BN, BK, EPI>
      <<<tiles < sms ? tiles : sms, THREADS, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// How the tensor cores round a float32 sum: one wgmma m64n64k8 tf32 onto
// an accumulator of +-1, column n adding (-1)^n 1.25 2^-24 (a[:, 0] =
// 1.25 2^-12, b[n, 0] = (-1)^n 2^-12, the rest 0) to (-1)^n. Rounded to
// nearest every sum is +-(1 + 2^-23); rounded toward zero, +-1.
__global__ void __launch_bounds__(128) round_probe_kernel(float* out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t tile = (raw + 1023) & ~1023u;
  uint8_t* const gen = smem_raw + (tile - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < 64 * 32; i += 128) {
    const int n = i / 32, k = i % 32;
    const float v = k == 0 ? ((n & 1) ? -0x1p-12f : 0x1p-12f) : 0.f;
    *reinterpret_cast<float*>(gen + sm90::swizzled<128>(n * 128 + 4 * k)) =
        v;
  }
  sm90::fence_proxy_async();
  __syncthreads();
  const int g8 = lane >> 2, c4 = lane & 3;
  const uint32_t a0 = c4 == 0 ? __float_as_uint(1.25f * 0x1p-12f) : 0u;
  const uint32_t a[4] = {a0, a0, 0u, 0u};
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = (i & 1) ? -1.f : 1.f;  // column parity
  sm90::fence_regs(d);
  sm90::wgmma_fence();
  sm90::wgmma_rs_tf32(d, a, sm90::desc_kmajor(tile), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + g8 + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * c4 + (i & 1);
    out[row * 64 + col] = d[i];
  }
}

// (BM, BN, BK, epilogue) of every instantiated variant
#define PT_TUNED_SM90_VARIANTS(X) \
  X(128, 128, 32, EPI_NONE)       \
  X(128, 256, 32, EPI_NONE)       \
  X(128, 256, 16, EPI_NONE)       \
  X(128, 128, 32, EPI_DR)         \
  X(128, 256, 32, EPI_DR)         \
  X(128, 256, 16, EPI_DR)         \
  X(64, 256, 32, EPI_LN)          \
  X(64, 512, 16, EPI_LN)

}  // namespace

// C [M, N] = epilogue(A [M, K] . B [K, N]) under variant (bm, bn, bk):
// epilogue 0 none, 1 layer_norm (p0 gamma [N], p1 beta [N]), 2
// dropout_residual (p0 mask [M, N], p1 residual [M, N], 16-byte
// aligned). bt is the
// caller's workspace, float32 [2N, K]. A, C and bt 16-byte aligned, K a
// multiple of 4 (TMA's row pitch). Two launches: the B^T pre-pass, then
// the GEMM. Returns cudaErrorInvalidValue for a variant that is not
// instantiated or shapes and pointers it does not take, else the first
// cudaError_t of the launches.
extern "C" int pt_tuned_matmul_sm90(const void* A, const void* B, void* C,
                                    int M, int N, int K, int bm, int bn,
                                    int bk, int epilogue, const void* p0,
                                    const void* p1, void* bt, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 != 0 || bt == nullptr ||
      reinterpret_cast<uintptr_t>(C) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(B) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = static_cast<float*>(C);
  p.gamma = p.mask = static_cast<const float*>(p0);
  p.beta = p.residual = static_cast<const float*>(p1);
  p.M = M;
  p.N = N;
  p.K = K;
  const float* b = static_cast<const float*>(B);
  float* w = static_cast<float*>(bt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PT_DISPATCH(BM, BN, BK, EPI)                                         \
  if (bm == BM && bn == BN && bk == BK && epilogue == EPI) {                 \
    if (!sm90::encode_2d(&p.ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, A, M, K, \
                         BK, BM,                                             \
                         BK == 32 ? CU_TENSOR_MAP_SWIZZLE_128B               \
                                  : CU_TENSOR_MAP_SWIZZLE_64B))              \
      return static_cast<int>(cudaErrorInvalidValue);                        \
    return gemm<BM, BN, BK, EPI>(p, b, w, s);                                \
  }
  PT_TUNED_SM90_VARIANTS(PT_DISPATCH)
#undef PT_DISPATCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Writes (bm, bn, bk, epilogue) of up to `cap` instantiated variants to
// out (4 ints each); returns how many there are.
extern "C" int pt_tuned_matmul_sm90_variants(int* out, int cap) {
  int n = 0;
#define PT_LIST(BM, BN, BK, EPI) \
  if (n < cap) {                \
    out[4 * n] = BM;            \
    out[4 * n + 1] = BN;        \
    out[4 * n + 2] = BK;        \
    out[4 * n + 3] = EPI;       \
  }                             \
  ++n;
  PT_TUNED_SM90_VARIANTS(PT_LIST)
#undef PT_LIST
  return n;
}

// out: [64, 64] float32 (see round_probe_kernel).
extern "C" int pt_tuned_matmul_sm90_round_probe(void* out, void* stream) {
  const uint32_t smem = 1024 + 64 * 128;
  cudaError_t err = cudaFuncSetAttribute(
      round_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  round_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
