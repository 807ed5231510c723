// Flash-attention backward dq for Hopper's tensor cores (sm_90a), bf16,
// plain C interface: wgmma.mma_async for all three products, TMA for the
// loads, and the di pre-pass fused in.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fa_bwd_dq_kernel
// (line 426), reached through _fa_backward (line 714) and its
// pl.pallas_call (line 822), for bf16 inputs; float32 calls, and calls
// that break TMA's rules, keep the CUDA-core dq_kernel and di_kernel of
// flash_attention_bwd.cu. Same function as those two, from the forward's
// out and lse:
//   di = rowsum(dO * O) - g_lse             (written for the dk/dv kernel)
//   p  = exp(s - lse), s = q.k^T*scale + bias, causal -1e30 (the forward's)
//   dp = dO.v^T, dropped as keep ? dp*256/t : 0
//   ds = p * (dp - di)
//   dq = scale * ds.k
// ds is rounded to bf16 before its product, as the TPU kernel casts it.
// On request the kernel also writes ds in float32 ([B, H, Sq, Sk]), the
// per-element bias gradient.
//
// What bounds it on this card: at the Transformer-base training shape
// (B=96, S=128, H=8, D=64) one call does 6*B*H*S*S*D = 4.8 GFLOP in bf16
// products (4.9 us at 989 TFLOP/s) and must move q, k, v, O, dO, dq
// (bf16), the bias, lse and di, 76 MB (23 us at 3.35 TB/s): bytes bound.
// The CUDA-core pair ran the products as float32 FMA through shared-
// memory score tiles, after a separate launch that read dO and O for di.
//
// What the design does about that:
//   * one block of one warpgroup (128 threads) per (batch, head, 64 query
//     rows). Thread 0 loads Q, dO and O once by TMA, and K and V of each
//     64-key tile through a 2-stage ring with full/empty mbarriers;
//   * di is computed in the block from its O and dO tiles before the key
//     loop (each block owns its rows) and written for the dk/dv kernel:
//     no pre-pass launch, no second read of dO;
//   * S = Q.K^T and dP = dO.V^T by wgmma m64n64k16, both operands K-major
//     as they lie; dS is rounded to bf16 in registers and is the register
//     A operand of dQ += dS.K, K read MN-major (the transpose bit). No
//     score tile touches shared memory; lse and di are per-row values, two
//     rows a thread, held in registers;
//   * scores are kept in log2 units (lse too), so each p is one exp2; each
//     mask only in the tiles that need it (uniform branches: the diagonal
//     tile, ragged edges). Rows past Sq read lse = +inf (p = 0) and keys
//     past Sk are masked to p = 0 (TMA zero-fills them: a zero-filled key
//     is not a masked one);
//   * causal blocks stop at the diagonal key tile.
// lse and di are flat [B*H*Sq] arrays read and written with ordinary loads
// and stores: a TMA box starting at bh*Sq + q0 is not 16-byte aligned for
// every Sq.
//
// Layouts and TMA's rules as flash_attention_fwd_sm90.cu.

#include "flash_attention_sm90.cuh"

namespace {

using sm90::TILE_BYTES;
// the finite mask value -1e30 in log2 units (scores are kept in them)
constexpr float NEG2 = fa::NEG_INF * fa::LOG2E;

struct Params {
  sm90::SeqMap tq, tdo, to, tk, tv;
  const float* lse;  // [B, H, Sq]
  float* di;         // [B, H, Sq], written here
  const float* g_lse;  // [B, H, Sq] or null: the lse cotangent, from di
  const float* bias;
  __nv_bfloat16* dq;
  float* ds;  // [B, H, Sq, Sk] or null
  int B, H, Sq, Sk, D;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t bias_sb, bias_sh, bias_sq;
  float scale;
  int causal;
  const int64_t* seed;  // [2] on the card; null: no dropout
  int drop_t;
  float drop_scale;
};

// shared memory: Q, dO, O [DCH] tiles; K, V [2 stages][DCH] tiles; di of
// the block's 64 rows; then the barriers (q, full[2], empty[2])
template <int DCH>
constexpr uint32_t smem_bytes() {
  return 1024 + 7 * DCH * TILE_BYTES + 256 + 64;
}

// DCH: 64-column chunks of the head dim (1: D <= 64, 2: D <= 128)
template <int DCH>
__global__ void __launch_bounds__(128, DCH == 1 ? 3 : 2)
    dq_sm90_kernel(const __grid_constant__ Params p) {
  constexpr uint32_t KV_STAGE = DCH * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sO = sQ + DCH * TILE_BYTES;   // dO
  const uint32_t sOut = sO + DCH * TILE_BYTES;  // O
  const uint32_t sK = sOut + DCH * TILE_BYTES;
  const uint32_t sV = sK + 2 * KV_STAGE;
  const uint32_t sDi = sV + 2 * KV_STAGE;
  const uint32_t bar_q = sDi + 256;
  const uint32_t full0 = bar_q + 8, empty0 = bar_q + 24;
  const uint8_t* base = smem_raw + (sQ - raw);  // generic address of sQ
  float* di_s = reinterpret_cast<float*>(smem_raw + (sDi - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;

  // causal: keys past the block's last row are masked for every row
  const int kv_end = p.causal ? min(p.Sk, q0 + 64) : p.Sk;
  const int n_tiles = (kv_end + 63) / 64;

  // key tile t of K and V into ring stage t & 1
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
    sm90::mbar_expect_tx(bar_q, 3 * DCH * TILE_BYTES);
    for (int c = 0; c < DCH; ++c) {
      sm90::tma_load_rows(sQ + c * TILE_BYTES, p.tq, bar_q, c, q0, h, b);
      sm90::tma_load_rows(sO + c * TILE_BYTES, p.tdo, bar_q, c, q0, h, b);
      sm90::tma_load_rows(sOut + c * TILE_BYTES, p.to, bar_q, c, q0, h, b);
    }
    for (int t = 0; t < 2 && t < n_tiles; ++t) load_kv(t);
  }
  __syncwarp();

  // this thread's rows: r_lo (d[4j + e]) and r_lo + 8 (d[4j + 2 + e]) of
  // the block; keys 8j + cq + e of each tile
  const int r_lo = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  float lse2[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + r_lo + 8 * h2;
    lse2[h2] = row < p.Sq ? p.lse[bh * p.Sq + row] * fa::LOG2E
                          : CUDART_INF_F;  // p = 0
  }

  sm90::mbar_wait(bar_q, 0);
  {
    // di of row tid / 2 over columns [32 (tid & 1), + 32) of each chunk:
    // four 16-byte pieces of the swizzled dO and O tiles
    const int rr = tid >> 1, half = tid & 1;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int j = 4 * half; j < 4 * half + 4; ++j) {
        const uint32_t off = c * TILE_BYTES + rr * 128 + ((j ^ (rr & 7)) << 4);
        const uint4 g = *reinterpret_cast<const uint4*>(base + (sO - sQ) + off);
        const uint4 o =
            *reinterpret_cast<const uint4*>(base + (sOut - sQ) + off);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 gf = __bfloat1622float2(g2[e]);
          const float2 of = __bfloat1622float2(o2[e]);
          acc = fmaf(gf.x, of.x, acc);
          acc = fmaf(gf.y, of.y, acc);
        }
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (p.g_lse && q0 + rr < p.Sq) acc -= p.g_lse[bh * p.Sq + q0 + rr];
    if (half == 0) {
      di_s[rr] = acc;  // rows past Sq: zero-filled tiles, di = 0
      if (q0 + rr < p.Sq) p.di[bh * p.Sq + q0 + rr] = acc;
    }
  }
  __syncthreads();
  const float di_r[2] = {di_s[r_lo], di_s[r_lo + 8]};

  const float* bg =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint32_t hseed = fa::head_seed_dev(p.seed, static_cast<uint32_t>(bh));
  const float scale2 = p.scale * fa::LOG2E;
  const bool q_edge = q0 + 64 > p.Sq;

  float dq[DCH][32];
#pragma unroll
  for (int c = 0; c < DCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    const int k0 = 64 * t;
    const bool k_edge = k0 + 64 > p.Sk;
    const uint32_t k_s = sK + stage * KV_STAGE;
    const uint32_t v_s = sV + stage * KV_STAGE;
    sm90::mbar_wait(full0 + 8 * stage, parity);

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DCH; ++kk) {
      // chunk kk / 4, k16 step kk % 4 within it
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(s, sm90::desc_kmajor(sQ + off),
                     sm90::desc_kmajor(k_s + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * DCH; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(dp, sm90::desc_kmajor(sO + off),
                     sm90::desc_kmajor(v_s + off), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // scores in log2 units, x = (s * scale + bias) * log2(e); each mask
    // only in the tiles that need it. Element i is (row r_lo +
    // 8 ((i >> 1) & 1), key k0 + 8 (i >> 2) + cq + (i & 1)).
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale2;
    if (bg != nullptr) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = q0 + r_lo + 8 * h2;
        if (row >= p.Sq) continue;
        const float* br = bg + row * p.bias_sq + k0 + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!k_edge || k0 + 8 * j + cq + e < p.Sk)
              s[4 * j + 2 * h2 + e] =
                  fmaf(br[8 * j + e], fa::LOG2E, s[4 * j + 2 * h2 + e]);
      }
    }
    if (p.causal && k0 + 63 > q0) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i >> 2) + cq + (i & 1) > q0 + r_lo + 8 * ((i >> 1) & 1))
          s[i] = NEG2;
    }
    if (q_edge || k_edge) {  // rows past Sq, keys past Sk: p = 0
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i >> 2) + cq + (i & 1) >= p.Sk ||
            q0 + r_lo + 8 * ((i >> 1) & 1) >= p.Sq)
          s[i] = -CUDART_INF_F;
    }

    // ds into dp (float32; written out on request)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = q0 + r_lo + 8 * h2;
      // dropout positions: row * Sk + key
      const uint32_t pos = static_cast<uint32_t>(row) *
                               static_cast<uint32_t>(p.Sk) +
                           static_cast<uint32_t>(k0 + cq);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h2 + e;
          const float pr = exp2f(s[i] - lse2[h2]);
          float d = dp[i];
          if (p.drop_t > 0)
            d = fa::keep_pos(hseed, pos + static_cast<uint32_t>(8 * j + e),
                             p.drop_t)
                    ? d * p.drop_scale
                    : 0.f;
          dp[i] = pr * (d - di_r[h2]);
        }
      if (p.ds != nullptr && row < p.Sq) {
        float* dsr = p.ds + (bh * p.Sq + row) * p.Sk + k0 + cq;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 8 * j + cq + e < p.Sk) dsr[8 * j + e] = dp[4 * j + 2 * h2 + e];
      }
    }

    // dQ += dS.K: A from registers (dS rounded to bf16), B = K MN-major
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::a_frag(dp, kk, a[kk]);
#pragma unroll
    for (int c = 0; c < DCH; ++c) sm90::fence_regs(dq[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_rs(dq[c], a[kk],
                       sm90::desc_mnmajor(k_s + c * TILE_BYTES + kk * 2048),
                       1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DCH; ++c) sm90::fence_regs(dq[c]);

    sm90::mbar_arrive(empty0 + 8 * stage);
    // refill this stage with tile t + 2 once every thread is done with it
    if (tid == 0 && t + 2 < n_tiles) {
      sm90::mbar_wait(empty0 + 8 * stage, parity);
      load_kv(t + 2);
    }
    __syncwarp();
  }

  __nv_bfloat16* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int row = q0 + r_lo + 8 * h2;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + cq;
        if (d < p.D) {
          const int i = 4 * j + 2 * h2;
          *reinterpret_cast<__nv_bfloat162*>(dqg + row * p.dq_ss + d) =
              __floats2bfloat162_rn(dq[c][i] * p.scale,
                                    dq[c][i + 1] * p.scale);
        }
      }
  }
}

template <int DCH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<DCH>();
  cudaError_t err = cudaFuncSetAttribute(
      dq_sm90_kernel<DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + 63) / 64, p.H, p.B);
  dq_sm90_kernel<DCH><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Same arguments as pt_flash_attention_bwd_dq (flash_attention_bwd.cu):
// reads q, k, v, out, dout, bias, lse and g_lse, writes di (less g_lse),
// dq and, if ds is not
// null, ds (which the caller zeroes: causal-skipped tiles are not
// written); dk and dv are not touched. dtype must be 1 (bfloat16).
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue when the
// call breaks TMA's rules (see the top).
extern "C" int pt_flash_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* bias, const void* lse, void* di, void* dq,
    void* dk, void* dv, void* ds, const void* g_lse, int dtype, int B, int H,
    int Sq, int Sk, int D, const int64_t* st, float scale, int causal,
    const void* seed, int drop_t, void* stream) {
  (void)dk, (void)dv;
  if (dtype != 1 || D < 8 || D > 128 || D % 8 != 0 || B < 1 || H < 1 ||
      Sq < 1 || Sk < 1 || drop_t < 0 ||
      (drop_t > 0 && seed == nullptr) || drop_t > 255 ||
      reinterpret_cast<uintptr_t>(dq) % 4 != 0 || st[15] % 2 != 0 ||
      st[16] % 2 != 0 || st[17] % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  if (!sm90::encode_seq(&p.tq, q, B, H, Sq, D, st[0], st[1], st[2], 64) ||
      !sm90::encode_seq(&p.tk, k, B, H, Sk, D, st[3], st[4], st[5], 64) ||
      !sm90::encode_seq(&p.tv, v, B, H, Sk, D, st[6], st[7], st[8], 64) ||
      !sm90::encode_seq(&p.to, out, B, H, Sq, D, st[9], st[10], st[11],
                        64) ||
      !sm90::encode_seq(&p.tdo, dout, B, H, Sq, D, st[12], st[13], st[14],
                        64))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<float*>(di);
  p.g_lse = static_cast<const float*>(g_lse);
  p.bias = static_cast<const float*>(bias);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.ds = static_cast<float*>(ds);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.dq_sb = st[15];
  p.dq_ss = st[16];
  p.dq_sh = st[17];
  p.bias_sb = st[24];
  p.bias_sh = st[25];
  p.bias_sq = st[26];
  p.scale = scale;
  p.causal = causal;
  p.seed = drop_t > 0 ? static_cast<const int64_t*>(seed) : nullptr;
  p.drop_t = drop_t;
  p.drop_scale = drop_t > 0 ? static_cast<float>(256.0 / drop_t) : 1.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? launch<1>(p, s) : launch<2>(p, s);
  return static_cast<int>(err);
}
