// Flash-attention forward for Hopper's tensor cores (sm_90a), bf16, plain
// C interface: wgmma.mma_async for both products, TMA for the loads.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fa_kernel (line 353),
// reached through _fa_forward (line 593) and its pl.pallas_call (line
// 663), for bf16 inputs; float32 calls keep the CUDA-core kernel of
// flash_attention_fwd.cu. Same function as that kernel:
// s = q.k^T * scale + bias (bias [B|1, H|1, Sq|1, Sk] float32, read by
// strides), causal mask (absolute col > row) with the finite -1e30, keys
// past Sk at -inf, online softmax in float32, attention dropout by the
// position hash of flash_attention_common.cuh (kept weights scale by
// 256/t; l sums the undropped weights), p rounded to bf16 before p.v,
// out = acc / max(l, 1e-30) in bf16, optional lse = m + log(max(l, 1e-30))
// [B, H, Sq] float32.
//
// What bounds it on this card: at the Transformer-base training shape
// (B=96, S=128, H=8, D=64) one call does 4*B*H*S*S*D = 3.2 GFLOP in bf16
// products (3.3 us at 989 TFLOP/s) and must move q, k, v, out (bf16), the
// bias and lse, 51 MB (15 us at 3.35 TB/s): bytes bound. The CUDA-core
// kernel ran the products as float32 FMA (6 % of this bound, PR 4). With
// the products on the tensor cores, what is left is the per-score work
// on the CUDA cores (scale, bias, masks, exp2, the dropout hash) and the
// latency of each block's loads: a block sees only S/64 key tiles.
//
// What the design does about that:
//   * one block of one warpgroup (128 threads) per (batch, head, 64 query
//     rows): at most 128 registers a thread at D = 64, so four blocks an
//     SM keep one block's loads under the others' compute (faster on the
//     H100 at the training shape than two warpgroups on 128 rows sharing
//     each key tile). Thread 0 issues every TMA load:
//     Q once, K and V through a 2-stage ring of 64-key tiles with
//     full/empty mbarriers, so the next tile's loads overlap this one's
//     compute;
//   * S = Q.K^T by wgmma m64n64k16 (A = Q, B = K, both K-major as they
//     lie), O += P.V by wgmma with A = P from registers: the f32 score
//     accumulator is rounded to bf16 in place (its layout is the A
//     fragment's), B = V MN-major (transpose bit); no score tile touches
//     shared memory;
//   * scores are kept in log2 units, so each weight is one exp2; bias,
//     masks and the dropout hash are applied in the accumulator's layout,
//     each thread knowing its (row, col) pairs, and each mask only in the
//     tiles that need it (uniform branches: the diagonal tile, the ragged
//     last tile). The hash is a function of position only, so the mask is
//     bit-equal to dropout_keep_mask. Row max and row sum reduce over the
//     4 threads of a quad; l stays a per-thread partial sum until the end;
//   * ragged Sq/Sk and D < 64 per chunk come from TMA's zero fill; keys
//     past Sk are masked to -inf (a zero-filled key gives s = 0, not a
//     masked score); causal blocks stop at the diagonal key tile.
//
// Layouts bshd ([B, S, H, D]) and bhsd ([B, H, S, D]) arrive as strides
// (the TMA map orders its dims as they lie). TMA's rules: D a multiple of
// 8 and at most 128, 16-byte-aligned bases, strides multiples of 16 bytes
// (the wrapper's _sm90_eligible); the entry point refuses anything else.

#include "flash_attention_sm90.cuh"

namespace {

using fa::L_FLOOR;
using sm90::TILE_BYTES;
// the finite mask value -1e30 in log2 units (scores are kept in them)
constexpr float NEG2 = fa::NEG_INF * fa::LOG2E;

struct Params {
  sm90::SeqMap tq, tk, tv;
  const float* bias;
  __nv_bfloat16* out;
  float* lse;
  int B, H, Sq, Sk, D;
  int64_t o_sb, o_ss, o_sh;
  int64_t bias_sb, bias_sh, bias_sq;
  float scale;
  int causal;
  const int64_t* seed;  // [2] on the card; null: no dropout
  int drop_t;
  float drop_scale;
};

// shared memory: Q [DCH] tiles, K and V [2 stages][DCH] tiles, then the
// barriers (q, full[2], empty[2])
template <int DCH>
constexpr uint32_t smem_bytes() {
  return 1024 + 5 * DCH * TILE_BYTES + 64;
}

// DCH: 64-column chunks of the head dim (1: D <= 64, 2: D <= 128)
template <int DCH>
__global__ void __launch_bounds__(128, DCH == 1 ? 4 : 1)
    fa_fwd_sm90_kernel(const __grid_constant__ Params p) {
  constexpr uint32_t KV_STAGE = DCH * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + DCH * TILE_BYTES;
  const uint32_t sV = sK + 2 * KV_STAGE;
  const uint32_t bar_q = sV + 2 * KV_STAGE;
  const uint32_t full0 = bar_q + 8, empty0 = bar_q + 24;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  // causal: keys past the block's last row are masked for every row
  const int kv_end = p.causal ? min(p.Sk, q0 + 64) : p.Sk;
  const int n_tiles = (kv_end + 63) / 64;

  // tile t of K and V into ring stage t & 1
  auto load_kv = [&](int t) {
    const uint32_t bar = full0 + 8 * (t & 1);
    const uint32_t at = (t & 1) * KV_STAGE;
    sm90::mbar_expect_tx(bar, 2 * KV_STAGE);
    for (int c = 0; c < DCH; ++c) {
      sm90::tma_load_rows(sK + at + c * TILE_BYTES, p.tk, bar, c, 64 * t, h,
                          b);
      sm90::tma_load_rows(sV + at + c * TILE_BYTES, p.tv, bar, c, 64 * t, h,
                          b);
    }
  };
  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar_q, DCH * TILE_BYTES);
    for (int c = 0; c < DCH; ++c)
      sm90::tma_load_rows(sQ + c * TILE_BYTES, p.tq, bar_q, c, q0, h, b);
    for (int t = 0; t < 2 && t < n_tiles; ++t) load_kv(t);
  }
  __syncwarp();

  // this thread's rows: r_lo (d[4j + e]) and r_lo + 8 (d[4j + 2 + e]);
  // columns 8j + cq + e of each key tile
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  // each row's bias row, null past Sq or without a bias
  const float* brow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
    brow[h2] = p.bias != nullptr && r_lo + 8 * h2 < p.Sq
                   ? p.bias + b * p.bias_sb + h * p.bias_sh +
                         (r_lo + 8 * h2) * p.bias_sq
                   : nullptr;
  const uint32_t hseed = fa::head_seed_dev(p.seed, b * p.H + h);
  const float scale2 = p.scale * fa::LOG2E;

  float o[DCH][32];
#pragma unroll
  for (int c = 0; c < DCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};

  sm90::mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t parity = (t >> 1) & 1;
    const int k0 = 64 * t;
    const bool edge = k0 + 64 > p.Sk;
    const uint32_t k_s = sK + (t & 1) * KV_STAGE;
    const uint32_t v_s = sV + (t & 1) * KV_STAGE;
    sm90::mbar_wait(full0 + 8 * (t & 1), parity);

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DCH; ++kk) {
      // chunk kk / 4, k16 step kk % 4 within it
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(s, sm90::desc_kmajor(sQ + off),
                     sm90::desc_kmajor(k_s + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);

    // scores in log2 units, x = (s * scale + bias) * log2(e); each mask
    // only in the tiles that need it
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale2;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (brow[h2] == nullptr) continue;
      const float* bk = brow[h2] + k0 + cq;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!edge || k0 + 8 * j + cq + e < p.Sk)
            s[4 * j + 2 * h2 + e] =
                fmaf(bk[8 * j + e], fa::LOG2E, s[4 * j + 2 * h2 + e]);
    }
    if (p.causal && k0 + 63 > q0) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i >> 2) + cq + (i & 1) > r_lo + 8 * ((i >> 1) & 1))
          s[i] = NEG2;
    }
    if (edge) {  // past the ragged edge: weight exactly 0
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i >> 2) + cq + (i & 1) >= p.Sk) s[i] = -CUDART_INF_F;
    }

    // online softmax per row (h2 = 0: r_lo, 1: r_lo + 8)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = NEG2;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h2], s[4 * j + 2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h2], mx);
      const float corr = exp2f(m[h2] - m_new);
      m[h2] = m_new;
      // dropout positions: row * Sk + col
      const uint32_t pos = static_cast<uint32_t>(r_lo + 8 * h2) *
                               static_cast<uint32_t>(p.Sk) +
                           static_cast<uint32_t>(k0 + cq);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h2 + e;
          const float ex = exp2f(s[i] - m_new);
          sum += ex;  // l sums the undropped weights
          s[i] = p.drop_t > 0
                     ? (fa::keep_pos(hseed, pos + 8 * j + e, p.drop_t)
                            ? ex * p.drop_scale
                            : 0.f)
                     : ex;
        }
      l[h2] = l[h2] * corr + sum;
#pragma unroll
      for (int c = 0; c < DCH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 2 * h2] *= corr;
          o[c][4 * j + 2 * h2 + 1] *= corr;
        }
    }

    // O += P.V: P from registers (bf16), V MN-major
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::a_frag(s, kk, a[kk]);
#pragma unroll
    for (int c = 0; c < DCH; ++c) sm90::fence_regs(o[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs(o[c], a[kk],
                       sm90::desc_mnmajor(v_s + c * TILE_BYTES + kk * 2048),
                       1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DCH; ++c) sm90::fence_regs(o[c]);

    sm90::mbar_arrive(empty0 + 8 * (t & 1));
    // refill this stage with tile t + 2 once every thread is done with it
    if (tid == 0 && t + 2 < n_tiles) {
      sm90::mbar_wait(empty0 + 8 * (t & 1), parity);
      load_kv(t + 2);
    }
    __syncwarp();
  }

  // out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
  __nv_bfloat16* og = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = r_lo + 8 * h2;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(lt, L_FLOOR);
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + cq;
        if (d < p.D)
          *reinterpret_cast<__nv_bfloat162*>(og + row * p.o_ss + d) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * h2] / denom,
                                    o[c][4 * j + 2 * h2 + 1] / denom);
      }
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
          m[h2] * fa::LN2 + logf(denom);
  }
}

template <int DCH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<DCH>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_sm90_kernel<DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + 63) / 64, p.H, p.B);
  fa_fwd_sm90_kernel<DCH><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

// one m64n64k16 product of each kind, for the card test: C = A.B^T by
// wgmma from shared memory (K-major), then R = bf16(C).B with the bf16
// C as a register A fragment and B MN-major, as the attention kernels
// use them. A, B [64, 64] bf16 row-major through 4-D maps (B=1, H=1).
struct ProbeParams {
  sm90::SeqMap ta, tb;
  float* c;
  float* r;
};

__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const __grid_constant__ ProbeParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sA = (raw + 1023) & ~1023u;
  const uint32_t sB = sA + TILE_BYTES;
  const uint32_t bar = sB + TILE_BYTES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar, 2 * TILE_BYTES);
    sm90::tma_load_rows(sA, p.ta, bar, 0, 0, 0, 0);
    sm90::tma_load_rows(sB, p.tb, bar, 0, 0, 0, 0);
  }
  __syncwarp();
  sm90::mbar_wait(bar, 0);

  float c[32], r[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = r[i] = 0.f;
  sm90::fence_regs(c);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_ss(c, sm90::desc_kmajor(sA + kk * 32),
                   sm90::desc_kmajor(sB + kk * 32), kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(c);

  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::a_frag(c, kk, a[kk]);
  sm90::fence_regs(r);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_rs(r, a[kk], sm90::desc_mnmajor(sB + kk * 2048), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(r);

  const int row0 = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h2 + e;
        const int at = (row0 + 8 * h2) * 64 + 8 * j + cq + e;
        p.c[at] = c[i];
        p.r[at] = r[i];
      }
}

}  // namespace

// Same arguments as pt_flash_attention_fwd (flash_attention_fwd.cu);
// dtype must be 1 (bfloat16). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue when the call breaks TMA's rules (see the top).
extern "C" int pt_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    void* out, void* lse, int dtype, int B, int H, int Sq, int Sk, int D,
    const int64_t* strides, float scale, int causal, const void* seed,
    int drop_t, void* stream) {
  if (dtype != 1 || D < 8 || D > 128 || D % 8 != 0 || B < 1 || H < 1 ||
      Sq < 1 || Sk < 1 || drop_t < 0 ||
      (drop_t > 0 && seed == nullptr) || drop_t > 255 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || strides[9] % 8 != 0 ||
      strides[10] % 8 != 0 || strides[11] % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  if (!sm90::encode_seq(&p.tq, q, B, H, Sq, D, strides[0], strides[1],
                        strides[2], 64) ||
      !sm90::encode_seq(&p.tk, k, B, H, Sk, D, strides[3], strides[4],
                        strides[5], 64) ||
      !sm90::encode_seq(&p.tv, v, B, H, Sk, D, strides[6], strides[7],
                        strides[8], 64))
    return static_cast<int>(cudaErrorInvalidValue);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.bias_sb = strides[12];
  p.bias_sh = strides[13];
  p.bias_sq = strides[14];
  p.scale = scale;
  p.causal = causal;
  p.seed = drop_t > 0 ? static_cast<const int64_t*>(seed) : nullptr;
  p.drop_t = drop_t;
  p.drop_scale = drop_t > 0 ? static_cast<float>(256.0 / drop_t) : 1.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? launch<1>(p, s) : launch<2>(p, s);
  return static_cast<int>(err);
}

// a, b: [64, 64] bf16, row-major, 16-byte aligned; c, r: [64, 64] float32
// (see wgmma_probe_kernel).
extern "C" int pt_fa_sm90_wgmma_probe(const void* a, const void* b, void* c,
                                      void* r, void* stream) {
  ProbeParams p;
  if (!sm90::encode_seq(&p.ta, a, 1, 1, 64, 64, 4096, 64, 64, 64) ||
      !sm90::encode_seq(&p.tb, b, 1, 1, 64, 64, 4096, 64, 64, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  p.c = static_cast<float*>(c);
  p.r = static_cast<float*>(r);
  const uint32_t smem = 1024 + 2 * TILE_BYTES + 16;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
