// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fa_kernel (line 353),
// reached through _fa_forward (line 593) and its pl.pallas_call. Same
// function: s = q.k^T * scale + bias, causal mask (absolute col > row)
// with -1e30, running max and sum in float32, optional attention-weights
// dropout, out = acc / max(l, 1e-30) in q's dtype, optional
// lse = m + log(max(l, 1e-30)) as a narrow [B, H, Sq] float32 tensor.
//
// Dropout (drop_t in 1..255): a weight is kept when the position hash
// of flash_attention_common.cuh is below drop_t, and kept weights scale
// by 256/drop_t. As on the TPU, the denominator l sums the undropped
// weights: out = dropout(softmax(s)) . v.
//
// What bounds it on this card: at the Transformer-base serving shape
// (B=32, S=256, H=8, D=64) one call does 4*B*H*S*S*D = 4.3 GFLOP and must
// move q, k, v and out once (67 MB in float32): 64 FLOP per byte, above
// the H100's float32 ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/B). Without
// tensor cores it is bound by float32 FMA issue, and next by shared-memory
// bandwidth feeding the FMAs.
//
// What the design does about that:
//   * one block per (batch, head, 64 query rows); it loops over 64-key
//     tiles staged in shared memory, so the [Sq, Sk] score matrix never
//     reaches device memory (online softmax, as on the TPU);
//   * 256 threads as 16 x 16; each thread keeps a 4 x 4 tile of scores and
//     a 4 x (D/16) tile of the output in registers, fed by 16-byte
//     shared-memory loads (8 FMAs per load), with strides padded so the
//     loads of a warp hit distinct banks;
//   * row max and row sum are reduced across the 16 threads of a row with
//     warp shuffles;
//   * causal blocks stop at the last key tile that touches the diagonal;
//   * the ragged edges (Sq, Sk not multiples of 64, D < the padded width)
//     are masked in the kernel, so any S works;
//   * the dropout mask is recomputed from the hash (about a dozen integer
//     operations per weight) instead of being read from memory.
// float32 FMA on CUDA cores is the first, simple design; wgmma and TMA
// come later.
//
// Layouts bshd ([B, S, H, D]) and bhsd ([B, H, S, D]) both arrive as
// strides; the head dimension must be contiguous. bf16 inputs are a
// template parameter: products and sums stay float32, p is rounded to
// bf16 before the p.V product as the TPU kernel casts p to v's dtype.

#include "flash_attention_common.cuh"

namespace {

using fa::BK;
using fa::BQ;
using fa::from_f;
using fa::L_FLOOR;
using fa::NEG_INF;
using fa::NTHREADS;
using fa::P_STRIDE;
using fa::to_f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  float* lse;
  int B, H, Sq, Sk, D;
  // element strides of (batch, sequence, head); head dim stride is 1
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  // bias [B|1, H|1, Sq|1, Sk]: strides of (batch, head, query), 0 where
  // the dim broadcasts; key stride is 1
  int64_t bias_sb, bias_sh, bias_sq;
  float scale;
  int causal;
  // dropout: drop_t in 1..255 (0: off), seed words, 256 / drop_t
  uint32_t s0, s1;
  int drop_t;
  float drop_scale;
};

template <typename T, int DPAD>
__global__ void __launch_bounds__(NTHREADS)
    fa_fwd_kernel(const Params p) {
  constexpr int QK_STRIDE = DPAD + 4;  // 16-byte aligned, bank-skewed
  constexpr int G = DPAD / 64;         // float4 output columns per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][QK_STRIDE]
  float* sK = sQ + BQ * QK_STRIDE;              // [BK][QK_STRIDE]
  float* sV = sK + BK * QK_STRIDE;              // [BK][DPAD]
  float* sP = sV + BK * DPAD;                   // [BQ][P_STRIDE]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh;
  const float* bg =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint32_t hseed = fa::head_seed(p.s0, p.s1, b * p.H + h);

  // q tile, zero beyond Sq and D
  for (int i = tid; i < BQ * DPAD; i += NTHREADS) {
    const int r = i / DPAD, d = i % DPAD;
    float x = 0.f;
    if (q0 + r < p.Sq && d < p.D) x = to_f(qg[(q0 + r) * p.q_ss + d]);
    sQ[r * QK_STRIDE + d] = x;
  }

  float m[4], l[4], acc[4][4 * G];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the block's last row are masked for every row
  const int kv_end = p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's sK/sV/sP reads are done
    for (int i = tid; i < BK * DPAD; i += NTHREADS) {
      const int r = i / DPAD, d = i % DPAD;
      float kx = 0.f, vx = 0.f;  // zero rows keep 0 * p finite
      if (k0 + r < p.Sk && d < p.D) {
        kx = to_f(kg[(k0 + r) * p.k_ss + d]);
        vx = to_f(vg[(k0 + r) * p.v_ss + d]);
      }
      sK[r * QK_STRIDE + d] = kx;
      sV[r * DPAD + d] = vx;
    }
    __syncthreads();

    // scores for rows ty + 16i, keys tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DPAD; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            &sQ[(ty + 16 * i) * QK_STRIDE + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(
            &sK[(tx + 16 * j) * QK_STRIDE + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // scale, bias, masks, then the online-softmax update per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x;
        if (col >= p.Sk) {
          x = -CUDART_INF_F;  // past the ragged edge: weight exactly 0
        } else {
          x = s[i][j] * p.scale;
          if (bg != nullptr && row < p.Sq) x += bg[row * p.bias_sq + col];
          if (p.causal && col > row) x = NEG_INF;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;  // l sums the undropped weights
        float w = e;
        if (p.drop_t > 0)
          w = fa::keep(hseed, row, k0 + tx + 16 * j, p.Sk, p.drop_t)
                  ? e * p.drop_scale
                  : 0.f;
        sP[(ty + 16 * i) * P_STRIDE + tx + 16 * j] = to_f(from_f<T>(w));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // out rows ty + 16i, columns 64g + 4tx .. +3:  acc += p . v
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(
            &sP[(ty + 16 * i) * P_STRIDE + j]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 vb = *reinterpret_cast<const float4*>(
              &sV[(j + jj) * DPAD + 64 * g + 4 * tx]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pij = jj == 0   ? pa[i].x
                              : jj == 1 ? pa[i].y
                              : jj == 2 ? pa[i].z
                                        : pa[i].w;
            acc[i][4 * g + 0] = fmaf(pij, vb.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(pij, vb.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(pij, vb.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(pij, vb.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], L_FLOOR);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 64 * g + 4 * tx + c;
        if (d < p.D) og[row * p.o_ss + d] = from_f<T>(acc[i][4 * g + c] / denom);
      }
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
          m[i] + logf(denom);
  }
}

template <typename T, int DPAD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(
      sizeof(float) * ((BQ + BK) * (DPAD + 4) + BK * DPAD + BQ * P_STRIDE));
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, DPAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  fa_fwd_kernel<T, DPAD><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. strides: 15 element strides, in order
// q (b, s, h), k (b, s, h), v (b, s, h), out (b, s, h), bias (b, h, q).
// bias and lse may be null. drop_t: 0 for no dropout, else the keep
// threshold 1..255 with seed words s0, s1. Returns the cudaError_t of the
// launch.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, void* lse, int dtype,
                                      int B, int H, int Sq, int Sk, int D,
                                      const int64_t* strides, float scale,
                                      int causal, uint32_t s0, uint32_t s1,
                                      int drop_t, void* stream) {
  if (D < 1 || D > 128 || B < 1 || H < 1 || Sq < 1 || Sk < 1 ||
      drop_t < 0 || drop_t > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.bias_sb = strides[12];
  p.bias_sh = strides[13];
  p.bias_sq = strides[14];
  p.scale = scale;
  p.causal = causal;
  p.s0 = s0;
  p.s1 = s1;
  p.drop_t = drop_t;
  p.drop_scale = drop_t > 0 ? static_cast<float>(256.0 / drop_t) : 1.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D <= 64 ? launch<float, 64>(p, s) : launch<float, 128>(p, s);
  else if (dtype == 1)
    err = D <= 64 ? launch<__nv_bfloat16, 64>(p, s)
                  : launch<__nv_bfloat16, 128>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
