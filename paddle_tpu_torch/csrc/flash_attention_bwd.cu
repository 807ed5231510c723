// Flash-attention backward for Hopper (sm_90a), plain C interface: the
// dq kernel (with its di pre-pass) and the dk/dv kernel.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fa_bwd_dq_kernel
// (line 426) and _fa_bwd_dkv_kernel (line 502), reached through
// _fa_backward (line 714) and its two pl.pallas_call. Same function, from
// the forward's out and lse:
//   di = rowsum(dO * O) - g_lse              (pre-pass, [B, H, Sq] f32)
//   p  = exp(s - lse), s = q.k^T*scale + bias, causal -1e30 (the forward's)
//   dp = dO.v^T, dropped as keep ? dp*256/t : 0
//   ds = p * (dp - di)
//   dq = scale * ds.k                         (dq kernel)
//   dv = p_drop^T.dO,  dk = scale * ds^T.q    (dk/dv kernel)
// with p_drop = keep ? p*256/t : 0, the dropout mask of the forward (the
// hash of flash_attention_common.cuh). ds and p_drop are rounded to the
// input type before their products, as the TPU kernels cast them. On
// request the dq kernel also writes ds in float32 ([B, H, Sq, Sk]), the
// per-element bias gradient; the caller sums it over broadcast dims.
//
// What bounds it on this card: at the Transformer-base training shape
// (B=96, S=128, H=8, D=64) dq does 6*B*H*S*S*D = 4.8 GFLOP and dk/dv
// 8*B*H*S*S*D = 6.4 GFLOP (half of each with causal), against some
// 25-50 MB of q, k, v, out, dO and gradients: well above the float32
// ridge, so bound by float32 FMA issue on the CUDA cores, as the forward.
//
// What the design does about that (the forward's scheme, twice):
//   * dq: one block per (batch, head, 64 query rows), looping over 64-key
//     tiles; dk/dv: one block per (batch, head, 64 keys), looping over
//     64-row query tiles. The reduction of each gradient stays inside one
//     block, so no atomics and no second pass, as in the TPU split.
//   * q, dO, k, v tiles are staged in shared memory in float32; 256
//     threads as 16 x 16 each compute a 4 x 4 tile of s and dp (16-byte
//     loads, bank-skewed strides), then a 4 x D/16 slice of the gradient
//     from the ds (and p_drop) tile in shared memory.
//   * causal: dq stops at the diagonal key tile, dk/dv starts at the
//     diagonal query tile;
//   * head dims up to 128 stage whole [64][D] tiles (q and dO, or k and v,
//     once a block); above that the products run over 128-column chunks
//     of every operand, reloaded for each tile, and each block
//     accumulates one 256-column group of its gradient (one group up to
//     D = 256; the grid's x dimension is tiles x groups, and each group's
//     block recomputes the same s and dp), so every D from 1 up runs.
//   * rows past Sq read lse = +inf (p = 0) and keys past Sk give p = 0,
//     so any S works; rows whose keys are all padded by a large negative
//     bias stay finite, as in the plain version.
// bf16 calls that meet TMA's rules take the tensor-core designs
// (flash_attention_bwd_dq_sm90.cu, flash_attention_bwd_dkv_sm90.cu); these
// kernels take float32 and every other call.

#include "flash_attention_common.cuh"

namespace {

using fa::BK;
using fa::chunk;
using fa::load_tile;
using fa::BQ;
using fa::from_f;
using fa::NEG_INF;
using fa::NTHREADS;
using fa::P_STRIDE;
using fa::to_f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* bias;
  const float* lse;  // [B, H, Sq]
  float* di;         // [B, H, Sq], written by the pre-pass
  const float* g_lse;  // [B, H, Sq] or null: subtracted from di
  void* dq;
  void* dk;
  void* dv;
  float* ds;  // [B, H, Sq, Sk] or null
  int B, H, Sq, Sk, D;
  // element strides of (batch, sequence, head); head dim stride is 1
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  // bias [B|1, H|1, Sq|1, Sk]: strides of (batch, head, query)
  int64_t bias_sb, bias_sh, bias_sq;
  float scale;
  int causal;
  const int64_t* seed;  // [2] on the card; null: no dropout
  int drop_t;
  float drop_scale;
};

// a[i][j] += A[ra + 16i] . B[rb + 16j] over the staged width CH, for two
// pairs of tiles at once (s += A1.B1, dp += A2.B2).
template <int CH>
__device__ __forceinline__ void two_products(const float* A1,
                                             const float* B1,
                                             const float* A2,
                                             const float* B2, int ra,
                                             int rb, float (&s)[4][4],
                                             float (&dp)[4][4]) {
  constexpr int ST = CH + 4;
#pragma unroll 2
  for (int d = 0; d < CH; d += 4) {
    float4 a1[4], b1[4], a2[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a1[i] = *reinterpret_cast<const float4*>(&A1[(ra + 16 * i) * ST + d]);
      a2[i] = *reinterpret_cast<const float4*>(&A2[(ra + 16 * i) * ST + d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b1[j] = *reinterpret_cast<const float4*>(&B1[(rb + 16 * j) * ST + d]);
      b2[j] = *reinterpret_cast<const float4*>(&B2[(rb + 16 * j) * ST + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a1[i].x, b1[j].x, s[i][j]);
        s[i][j] = fmaf(a1[i].y, b1[j].y, s[i][j]);
        s[i][j] = fmaf(a1[i].z, b1[j].z, s[i][j]);
        s[i][j] = fmaf(a1[i].w, b1[j].w, s[i][j]);
        dp[i][j] = fmaf(a2[i].x, b2[j].x, dp[i][j]);
        dp[i][j] = fmaf(a2[i].y, b2[j].y, dp[i][j]);
        dp[i][j] = fmaf(a2[i].z, b2[j].z, dp[i][j]);
        dp[i][j] = fmaf(a2[i].w, b2[j].w, dp[i][j]);
      }
  }
}

// acc[i][4(g0 + g) + c] += sum_j P[(ty + 16i)][j] * X[j][64g + 4tx + c]:
// rows ty + 16i of a [64][64] tile P times a [64][CH + 4] tile X, the
// columns of chunk g0 / (CH / 64) of a gradient of width DPAD.
template <int CH, int DPAD>
__device__ __forceinline__ void tile_times(const float* P, const float* X,
                                           int ty, int tx, int g0,
                                           float (&acc)[4][4 * (DPAD / 64)]) {
  constexpr int ST = CH + 4;
  constexpr int G = CH / 64;
#pragma unroll 2
  for (int j = 0; j < 64; j += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(&P[(ty + 16 * i) * P_STRIDE + j]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 xb = *reinterpret_cast<const float4*>(
            &X[(j + jj) * ST + 64 * g + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pij = jj == 0   ? pa[i].x
                            : jj == 1 ? pa[i].y
                            : jj == 2 ? pa[i].z
                                      : pa[i].w;
          float* a = &acc[i][4 * (g0 + g)];
          a[0] = fmaf(pij, xb.x, a[0]);
          a[1] = fmaf(pij, xb.y, a[1]);
          a[2] = fmaf(pij, xb.z, a[2]);
          a[3] = fmaf(pij, xb.w, a[3]);
        }
      }
    }
  }
}

// di[b, h, row] = sum_d dO * O in float32: one warp per row.
template <typename T>
__global__ void __launch_bounds__(NTHREADS) di_kernel(const Params p) {
  const int64_t n_rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (NTHREADS / 32) +
                    threadIdx.x / 32;
  if (r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int row = static_cast<int>(r % p.Sq);
  const int h = static_cast<int>((r / p.Sq) % p.H);
  const int b = static_cast<int>(r / (static_cast<int64_t>(p.Sq) * p.H));
  const T* o = static_cast<const T*>(p.out) + b * p.o_sb + h * p.o_sh +
               row * p.o_ss;
  const T* g = static_cast<const T*>(p.dout) + b * p.do_sb +
               h * p.do_sh + row * p.do_ss;
  float acc = 0.f;
  for (int d = lane; d < p.D; d += 32) acc = fmaf(to_f(o[d]), to_f(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.di[r] = p.g_lse ? acc - p.g_lse[r] : acc;
}

// The column groups of a gradient and the blocks of one tile: one group
// up to D = 256, else ceil(D / 256).
template <int DPAD>
__host__ __device__ __forceinline__ int n_groups(int D) {
  return (D + DPAD - 1) / DPAD;
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Params p) {
  constexpr int CH = chunk<DPAD>();
  constexpr int NC = DPAD / CH;  // chunks of a column group
  constexpr int ST = CH + 4;
  constexpr int G = DPAD / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][ST]
  float* sO = sQ + BQ * ST;                     // dO [BQ][ST]
  float* sK = sO + BQ * ST;                     // [BK][ST]
  float* sV = sK + BK * ST;                     // [BK][ST]
  float* sS = sV + BK * ST;                     // ds [BQ][P_STRIDE]
  float* sL = sS + BQ * P_STRIDE;               // lse [BQ]
  float* sD = sL + BQ;                          // di [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int groups = n_groups<DPAD>(p.D);
  const int q0 = (blockIdx.x / groups) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int d0 = (blockIdx.x % groups) * DPAD;  // this block's dq columns
  const int c0 = d0 / CH;                       // its first chunk
  // chunks of the operands s and dp sum over
  const int n_in = NC == 1 ? 1 : (p.D + CH - 1) / CH;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bg =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint32_t hseed = fa::head_seed_dev(p.seed, static_cast<uint32_t>(bh));

  if constexpr (NC == 1) {  // q and dO stay for the whole block
    load_tile<T, CH>(sQ, qg, p.q_ss, q0, p.Sq, p.D);
    load_tile<T, CH>(sO, og, p.do_ss, q0, p.Sq, p.D);
  }
  for (int r = tid; r < BQ; r += NTHREADS) {
    const bool in = q0 + r < p.Sq;
    sL[r] = in ? p.lse[bh * p.Sq + q0 + r] : CUDART_INF_F;  // p = 0
    sD[r] = in ? p.di[bh * p.Sq + q0 + r] : 0.f;
  }

  float acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;

  const int kv_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < n_in; ++c) {
      __syncthreads();  // the last reads of the staged tiles are done
      if constexpr (NC > 1) {
        load_tile<T, CH>(sQ, qg + c * CH, p.q_ss, q0, p.Sq, p.D - c * CH);
        load_tile<T, CH>(sO, og + c * CH, p.do_ss, q0, p.Sq, p.D - c * CH);
      }
      load_tile<T, CH>(sK, kg + c * CH, p.k_ss, k0, p.Sk, p.D - c * CH);
      load_tile<T, CH>(sV, vg + c * CH, p.v_ss, k0, p.Sk, p.D - c * CH);
      __syncthreads();
      two_products<CH>(sQ, sK, sO, sV, ty, tx, s, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (col < p.Sk && row < p.Sq) {
          float x = s[i][j] * p.scale;
          if (bg != nullptr) x += bg[row * p.bias_sq + col];
          if (p.causal && col > row) x = NEG_INF;
          const float pr = expf(x - sL[r]);
          float d = dp[i][j];
          if (p.drop_t > 0)
            d = fa::keep(hseed, row, col, p.Sk, p.drop_t) ? d * p.drop_scale
                                                         : 0.f;
          ds = pr * (d - sD[r]);
          if (p.ds != nullptr && d0 == 0)
            p.ds[(bh * p.Sq + row) * p.Sk + col] = ds;
        }
        sS[r * P_STRIDE + tx + 16 * j] = fa::round_to<T>(ds);
      }
    }
    __syncthreads();
    // the group's chunks of k: the last of D is staged, the others are
    // loaded again; chunks past D add nothing
#pragma unroll
    for (int c = NC - 1; c >= 0; --c) {
      const int gc = c0 + c;
      if (gc >= n_in) continue;
      if (gc != n_in - 1) {
        __syncthreads();
        load_tile<T, CH>(sK, kg + gc * CH, p.k_ss, k0, p.Sk, p.D - gc * CH);
        __syncthreads();
      }
      tile_times<CH, DPAD>(sS, sK, ty, tx, c * (CH / 64), acc);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = d0 + 64 * g + 4 * tx + c;
        if (d < p.D)
          dqg[row * p.dq_ss + d] = from_f<T>(acc[i][4 * g + c] * p.scale);
      }
  }
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(NTHREADS) dkv_kernel(const Params p) {
  constexpr int CH = chunk<DPAD>();
  constexpr int NC = DPAD / CH;
  constexpr int ST = CH + 4;
  constexpr int G = DPAD / 64;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [BK][ST]
  float* sV = sK + BK * ST;                     // [BK][ST]
  float* sQ = sV + BK * ST;                     // [BQ][ST]
  float* sO = sQ + BQ * ST;                     // dO [BQ][ST]
  float* sP = sO + BQ * ST;                     // p_drop^T [BK][P_STRIDE]
  float* sS = sP + BK * P_STRIDE;               // ds^T [BK][P_STRIDE]
  float* sL = sS + BK * P_STRIDE;               // lse [BQ]
  float* sD = sL + BQ;                          // di [BQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int groups = n_groups<DPAD>(p.D);
  const int k0 = (blockIdx.x / groups) * BK, h = blockIdx.y, b = blockIdx.z;
  const int d0 = (blockIdx.x % groups) * DPAD;  // this block's dk/dv columns
  const int c0 = d0 / CH;                       // its first chunk
  const int n_in = NC == 1 ? 1 : (p.D + CH - 1) / CH;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* og = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bg =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint32_t hseed = fa::head_seed_dev(p.seed, static_cast<uint32_t>(bh));

  if constexpr (NC == 1) {  // k and v stay for the whole block
    load_tile<T, CH>(sK, kg, p.k_ss, k0, p.Sk, p.D);
    load_tile<T, CH>(sV, vg, p.v_ss, k0, p.Sk, p.D);
  }

  float acc_k[4][4 * G], acc_v[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // causal: rows above the key tile see none of its keys
  const int t0 = p.causal ? k0 / BQ : 0;
  const int n_tiles = (p.Sq + BQ - 1) / BQ;
  for (int t = t0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    // transposed tiles: keys ty + 16i, rows tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < n_in; ++c) {
      __syncthreads();  // the last reads of the staged tiles are done
      if constexpr (NC > 1) {
        load_tile<T, CH>(sK, kg + c * CH, p.k_ss, k0, p.Sk, p.D - c * CH);
        load_tile<T, CH>(sV, vg + c * CH, p.v_ss, k0, p.Sk, p.D - c * CH);
      }
      load_tile<T, CH>(sQ, qg + c * CH, p.q_ss, q0, p.Sq, p.D - c * CH);
      load_tile<T, CH>(sO, og + c * CH, p.do_ss, q0, p.Sq, p.D - c * CH);
      if (c == 0) {
        for (int r = tid; r < BQ; r += NTHREADS) {
          const bool in = q0 + r < p.Sq;
          sL[r] = in ? p.lse[bh * p.Sq + q0 + r] : CUDART_INF_F;
          sD[r] = in ? p.di[bh * p.Sq + q0 + r] : 0.f;
        }
      }
      __syncthreads();
      two_products<CH>(sK, sQ, sV, sO, ty, tx, s, dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        float pd = 0.f, ds = 0.f;
        if (key < p.Sk && row < p.Sq) {
          float x = s[i][j] * p.scale;
          if (bg != nullptr) x += bg[row * p.bias_sq + key];
          if (p.causal && key > row) x = NEG_INF;
          const float pr = expf(x - sL[r]);
          float d = dp[i][j];
          pd = pr;
          if (p.drop_t > 0) {
            const bool kp = fa::keep(hseed, row, key, p.Sk, p.drop_t);
            pd = kp ? pr * p.drop_scale : 0.f;
            d = kp ? d * p.drop_scale : 0.f;
          }
          ds = pr * (d - sD[r]);
        }
        sP[(ty + 16 * i) * P_STRIDE + r] = fa::round_to<T>(pd);
        sS[(ty + 16 * i) * P_STRIDE + r] = fa::round_to<T>(ds);
      }
    }
    __syncthreads();
    // the group's chunks of q and dO: the last of D is staged, the
    // others are loaded again; chunks past D add nothing
#pragma unroll
    for (int c = NC - 1; c >= 0; --c) {
      const int gc = c0 + c;
      if (gc >= n_in) continue;
      if (gc != n_in - 1) {
        __syncthreads();
        load_tile<T, CH>(sQ, qg + gc * CH, p.q_ss, q0, p.Sq, p.D - gc * CH);
        load_tile<T, CH>(sO, og + gc * CH, p.do_ss, q0, p.Sq,
                         p.D - gc * CH);
        __syncthreads();
      }
      tile_times<CH, DPAD>(sP, sO, ty, tx, c * (CH / 64), acc_v);
      tile_times<CH, DPAD>(sS, sQ, ty, tx, c * (CH / 64), acc_k);
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = d0 + 64 * g + 4 * tx + c;
        if (d < p.D) {
          dkg[key * p.dk_ss + d] = from_f<T>(acc_k[i][4 * g + c] * p.scale);
          dvg[key * p.dv_ss + d] = from_f<T>(acc_v[i][4 * g + c]);
        }
      }
  }
}

template <typename T, int DPAD>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  const int64_t n_rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  const int rows_per_block = NTHREADS / 32;
  di_kernel<T><<<static_cast<int>((n_rows + rows_per_block - 1) /
                                  rows_per_block),
                 NTHREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(
      sizeof(float) *
      (4 * 64 * (chunk<DPAD>() + 4) + BQ * P_STRIDE + 2 * BQ));
  err = cudaFuncSetAttribute(dq_kernel<T, DPAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ * n_groups<DPAD>(p.D), p.H, p.B);
  dq_kernel<T, DPAD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DPAD>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(
      sizeof(float) *
      (4 * 64 * (chunk<DPAD>() + 4) + 2 * BK * P_STRIDE + 2 * BQ));
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BK - 1) / BK * n_groups<DPAD>(p.D), p.H, p.B);
  dkv_kernel<T, DPAD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int fill(Params& p, const void* q, const void* k, const void* v,
         const void* out, const void* dout, const void* bias,
         const void* lse, void* di, void* dq, void* dk, void* dv, void* ds,
         const void* g_lse, int B, int H, int Sq, int Sk, int D,
         const int64_t* st, float scale, int causal, const void* seed,
         int drop_t) {
  if (D < 1 || B < 1 || H < 1 || Sq < 1 || Sk < 1 || drop_t < 0 ||
      drop_t > 255 || (drop_t > 0 && seed == nullptr))
    return 0;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<float*>(di);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.ds = static_cast<float*>(ds);
  p.g_lse = static_cast<const float*>(g_lse);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  int64_t* dst[] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,
                    &p.k_sh,  &p.v_sb,  &p.v_ss,  &p.v_sh,  &p.o_sb,
                    &p.o_ss,  &p.o_sh,  &p.do_sb, &p.do_ss, &p.do_sh,
                    &p.dq_sb, &p.dq_ss, &p.dq_sh, &p.dk_sb, &p.dk_ss,
                    &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh, &p.bias_sb,
                    &p.bias_sh, &p.bias_sq};
  for (int i = 0; i < 27; ++i) *dst[i] = st[i];
  p.scale = scale;
  p.causal = causal;
  p.seed = drop_t > 0 ? static_cast<const int64_t*>(seed) : nullptr;
  p.drop_t = drop_t;
  p.drop_scale = drop_t > 0 ? static_cast<float>(256.0 / drop_t) : 1.f;
  return 1;
}

}  // namespace

// Both entry points take the same arguments. dtype: 0 float32,
// 1 bfloat16. strides: 27 element strides, in order q, k, v, out, dout,
// dq, dk, dv (each batch, sequence, head) and bias (batch, head, query).
// lse, di and g_lse are [B, H, Sq] float32; bias, ds, g_lse and the
// outputs the entry point does not write may be null. drop_t: 0 for no
// dropout, else the keep threshold 1..255, with seed pointing at the two
// seed words on the card (int64 [2]). Returns the cudaError_t.
//
// pt_flash_attention_bwd_dq: writes di (pre-pass, less g_lse), dq and, if
// ds is not null, ds (which the caller zeroes: causal-skipped tiles are not
// written).
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* bias, const void* lse, void* di, void* dq,
    void* dk, void* dv, void* ds, const void* g_lse, int dtype, int B, int H,
    int Sq, int Sk, int D, const int64_t* strides, float scale, int causal,
    const void* seed, int drop_t, void* stream) {
  Params p;
  if (!fill(p, q, k, v, out, dout, bias, lse, di, dq, dk, dv, ds, g_lse, B,
            H, Sq, Sk, D, strides, scale, causal, seed, drop_t))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D <= 64    ? launch_dq<float, 64>(p, s)
          : D <= 128 ? launch_dq<float, 128>(p, s)
                     : launch_dq<float, 256>(p, s);
  else if (dtype == 1)
    err = D <= 64    ? launch_dq<__nv_bfloat16, 64>(p, s)
          : D <= 128 ? launch_dq<__nv_bfloat16, 128>(p, s)
                     : launch_dq<__nv_bfloat16, 256>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// pt_flash_attention_bwd_dkv: reads di (from the dq entry point), writes
// dk and dv.
extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* bias, const void* lse, void* di, void* dq,
    void* dk, void* dv, void* ds, const void* g_lse, int dtype, int B, int H,
    int Sq, int Sk, int D, const int64_t* strides, float scale, int causal,
    const void* seed, int drop_t, void* stream) {
  Params p;
  if (!fill(p, q, k, v, out, dout, bias, lse, di, dq, dk, dv, ds, g_lse, B,
            H, Sq, Sk, D, strides, scale, causal, seed, drop_t))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D <= 64    ? launch_dkv<float, 64>(p, s)
          : D <= 128 ? launch_dkv<float, 128>(p, s)
                     : launch_dkv<float, 256>(p, s);
  else if (dtype == 1)
    err = D <= 64    ? launch_dkv<__nv_bfloat16, 64>(p, s)
          : D <= 128 ? launch_dkv<__nv_bfloat16, 128>(p, s)
                     : launch_dkv<__nv_bfloat16, 256>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
