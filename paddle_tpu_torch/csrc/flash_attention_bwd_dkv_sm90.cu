// Flash-attention backward dk/dv for Hopper's tensor cores (sm_90a),
// bf16, plain C interface: wgmma.mma_async for all four products, TMA for
// the loads.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fa_bwd_dkv_kernel
// (line 502), reached through _fa_backward (line 714) and its
// pl.pallas_call (line 896), for bf16 inputs; float32 calls keep the
// CUDA-core dkv_kernel of flash_attention_bwd.cu. Same function as that
// kernel, from the forward's lse and the di = rowsum(dO * O) that the dq
// entry point's pre-pass writes:
//   p  = exp(s - lse), s = q.k^T*scale + bias, causal -1e30 (the forward's)
//   dp = dO.v^T, dropped as keep ? dp*256/t : 0
//   ds = p * (dp - di)
//   dv = p_drop^T.dO,  dk = scale * ds^T.q
// with p_drop = keep ? p*256/t : 0 (the hash of
// flash_attention_common.cuh); p_drop and ds are rounded to bf16 before
// their products, as the TPU kernel casts them.
//
// What bounds it on this card: at the Transformer-base training shape
// (B=96, S=128, H=8, D=64) one call does 8*B*H*S*S*D = 6.4 GFLOP in bf16
// products (6.5 us at 989 TFLOP/s) and must move q, k, v, dO, dk, dv
// (bf16), the bias, lse and di, 76 MB (23 us at 3.35 TB/s): bytes bound.
// The CUDA-core kernel ran the products as float32 FMA through shared-
// memory score tiles, at 174 registers a thread (3.5 % of this bound).
// With the products on the tensor cores, what is left is the per-score
// work on the CUDA cores (p, the masks, the dropout hash, ds) and the
// latency of each block's loads.
//
// What the design does about that:
//   * one block of one warpgroup (128 threads) per (batch, head, 64
//     keys), at most 168 registers a thread at D = 64 so that three
//     blocks share an SM (faster on the H100 at the training shape than
//     two warpgroups on 128 keys, and than 195 registers and two blocks,
//     despite a few spilled bytes). Thread 0 loads K and V once by TMA,
//     and Q and dO of each 64-row query tile through a 2-stage ring with
//     full/empty mbarriers;
//   * the transposes are computed directly: S^T = K.Q^T and dP^T = V.dO^T
//     by wgmma m64n64k16 (A = K or V, B = Q or dO, all K-major as they
//     lie), so P_drop^T and dS^T come out in registers in the layout of an
//     A fragment: dV += P_drop^T.dO and dK += dS^T.Q take A from
//     registers and B = dO or Q MN-major (transpose bit). No score tile
//     touches shared memory; the four 64 x 64 f32 accumulators (S^T, dP^T,
//     dK, dV) are 32 registers a thread each at D = 64;
//   * in the transposed tile lse and di are per-column values: the block
//     copies the tile's 64 + 64 values into a double-buffered shared
//     slice (one value a thread; a TMA box of the flat [B*H*Sq] arrays
//     would start at bh*Sq + q0, not 16-byte aligned for every Sq) and
//     every thread reads them there;
//   * scores are kept in log2 units (lse too), so each p is one exp2; each
//     mask only in the tiles that need it (uniform branches: the diagonal
//     tile, ragged edges). Rows past Sq and keys past Sk give p = 0 and
//     ds = 0 (TMA zero-fills them, and the mask says so: a zero-filled row
//     is not a masked one);
//   * causal blocks start at the diagonal query tile.
//
// Layouts and TMA's rules as flash_attention_fwd_sm90.cu.

#include "flash_attention_sm90.cuh"

namespace {

using sm90::TILE_BYTES;
// the finite mask value -1e30 in log2 units (scores are kept in them)
constexpr float NEG2 = fa::NEG_INF * fa::LOG2E;

struct Params {
  sm90::SeqMap tq, tk, tv, tdo;
  const float* lse;  // [B, H, Sq]
  const float* di;   // [B, H, Sq]
  const float* bias;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int B, H, Sq, Sk, D;
  int64_t dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int64_t bias_sb, bias_sh, bias_sq;
  float scale;
  int causal;
  const int64_t* seed;  // [2] on the card; null: no dropout
  int drop_t;
  float drop_scale;
};

// shared memory: K, V [DCH] tiles; Q, dO [2 stages][DCH] tiles; lse and di
// [2 buffers][64 + 64]; then the barriers (kv, full[2], empty[2])
template <int DCH>
constexpr uint32_t smem_bytes() {
  return 1024 + 6 * DCH * TILE_BYTES + 1024 + 64;
}

// DCH: 64-column chunks of the head dim (1: D <= 64, 2: D <= 128)
template <int DCH>
__global__ void __launch_bounds__(128, DCH == 1 ? 3 : 1)
    dkv_sm90_kernel(const __grid_constant__ Params p) {
  constexpr uint32_t Q_STAGE = DCH * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + DCH * TILE_BYTES;
  const uint32_t sQ = sV + DCH * TILE_BYTES;
  const uint32_t sO = sQ + 2 * Q_STAGE;
  const uint32_t sLD = sO + 2 * Q_STAGE;
  const uint32_t bar_kv = sLD + 1024;
  const uint32_t full0 = bar_kv + 8, empty0 = bar_kv + 24;
  // lse * log2(e) at [0, 64) and di at [64, 128) of each of 2 buffers
  float* ld = reinterpret_cast<float*>(smem_raw + (sLD - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int k0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * p.H + h;

  // causal: query rows above the block's first key see none of its keys
  const int t0 = p.causal ? k0 / 64 : 0;
  const int n_tiles = (p.Sq + 63) / 64;

  // query tile t of Q and dO into ring stage (t - t0) & 1
  auto load_q = [&](int t) {
    const uint32_t bar = full0 + 8 * ((t - t0) & 1);
    const uint32_t at = ((t - t0) & 1) * Q_STAGE;
    sm90::mbar_expect_tx(bar, 2 * Q_STAGE);
    for (int c = 0; c < DCH; ++c) {
      sm90::tma_load_rows(sQ + at + c * TILE_BYTES, p.tq, bar, c, 64 * t, h,
                          b);
      sm90::tma_load_rows(sO + at + c * TILE_BYTES, p.tdo, bar, c, 64 * t,
                          h, b);
    }
  };
  if (tid == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full0 + 8 * s, 1);
      sm90::mbar_init(empty0 + 8 * s, 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar_kv, 2 * DCH * TILE_BYTES);
    for (int c = 0; c < DCH; ++c) {
      sm90::tma_load_rows(sK + c * TILE_BYTES, p.tk, bar_kv, c, k0, h, b);
      sm90::tma_load_rows(sV + c * TILE_BYTES, p.tv, bar_kv, c, k0, h, b);
    }
    for (int t = t0; t < t0 + 2 && t < n_tiles; ++t) load_q(t);
  }
  __syncwarp();

  // this thread's keys: key_lo (d[4j + e]) and key_lo + 8 (d[4j + 2 + e]);
  // query rows 8j + cq + e of each tile
  const int key_lo = k0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float* bg =
      p.bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const uint32_t hseed = fa::head_seed_dev(p.seed, static_cast<uint32_t>(bh));
  const float scale2 = p.scale * fa::LOG2E;
  const bool k_edge = k0 + 64 > p.Sk;

  float dk[DCH][32], dv[DCH][32];
#pragma unroll
  for (int c = 0; c < DCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[c][i] = dv[c][i] = 0.f;

  sm90::mbar_wait(bar_kv, 0);
  for (int t = t0; t < n_tiles; ++t) {
    const int stage = (t - t0) & 1;
    const uint32_t parity = ((t - t0) >> 1) & 1;
    const int q0 = 64 * t;
    const bool q_edge = q0 + 64 > p.Sq;
    const uint32_t q_s = sQ + stage * Q_STAGE;
    const uint32_t o_s = sO + stage * Q_STAGE;
    float* lse2_t = ld + stage * 128;
    const float* di_t = lse2_t + 64;
    {
      const int row = q0 + (tid & 63);
      float x = 0.f;
      if (row < p.Sq)
        x = tid < 64 ? p.lse[bh * p.Sq + row] * fa::LOG2E
                     : p.di[bh * p.Sq + row];
      lse2_t[tid] = x;
    }
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
      sm90::wgmma_ss(s, sm90::desc_kmajor(sK + off),
                     sm90::desc_kmajor(q_s + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4 * DCH; ++kk) {
      const uint32_t off = (kk >> 2) * TILE_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss(dp, sm90::desc_kmajor(sV + off),
                     sm90::desc_kmajor(o_s + off), kk > 0);
    }
    sm90::wgmma_commit();
    __syncthreads();  // this tile's lse/di are in shared memory
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // scores in log2 units, x = (s * scale + bias) * log2(e); each mask
    // only in the tiles that need it. Element i is (key key_lo +
    // 8 ((i >> 1) & 1), row q0 + 8 (i >> 2) + cq + (i & 1)).
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale2;
    if (bg != nullptr) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int key = key_lo + 8 * h2;
        if (key >= p.Sk) continue;
        const float* bk = bg + (q0 + cq) * p.bias_sq + key;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!q_edge || q0 + 8 * j + cq + e < p.Sq)
              s[4 * j + 2 * h2 + e] =
                  fmaf(bk[(8 * j + e) * p.bias_sq], fa::LOG2E,
                       s[4 * j + 2 * h2 + e]);
      }
    }
    if (p.causal && q0 < k0 + 63) {  // the tile crosses the diagonal
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (key_lo + 8 * ((i >> 1) & 1) > q0 + 8 * (i >> 2) + cq + (i & 1))
          s[i] = NEG2;
    }
    if (q_edge || k_edge) {  // rows past Sq, keys past Sk: p = 0
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (key_lo + 8 * ((i >> 1) & 1) >= p.Sk ||
            q0 + 8 * (i >> 2) + cq + (i & 1) >= p.Sq)
          s[i] = -CUDART_INF_F;
    }

    // p_drop^T into s, ds^T into dp
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      // dropout positions: row * Sk + key
      const uint32_t pos = static_cast<uint32_t>(q0 + cq) *
                               static_cast<uint32_t>(p.Sk) +
                           static_cast<uint32_t>(key_lo + 8 * h2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h2 + e;
          const int r = 8 * j + cq + e;
          const float pr = exp2f(s[i] - lse2_t[r]);
          float pd = pr, d = dp[i];
          if (p.drop_t > 0) {
            const bool kp = fa::keep_pos(
                hseed, pos + static_cast<uint32_t>(8 * j + e) * p.Sk,
                p.drop_t);
            pd = kp ? pr * p.drop_scale : 0.f;
            d = kp ? d * p.drop_scale : 0.f;
          }
          s[i] = pd;
          dp[i] = pr * (d - di_t[r]);
        }
    }

    // dV += P_drop^T.dO, dK += dS^T.Q: A from registers, B MN-major
    uint32_t ap[4][4], as[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::a_frag(s, kk, ap[kk]);
      sm90::a_frag(dp, kk, as[kk]);
    }
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      sm90::fence_regs(dv[c]);
      sm90::fence_regs(dk[c]);
    }
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = c * TILE_BYTES + kk * 2048;
        sm90::wgmma_rs(dv[c], ap[kk], sm90::desc_mnmajor(o_s + off), 1);
        sm90::wgmma_rs(dk[c], as[kk], sm90::desc_mnmajor(q_s + off), 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      sm90::fence_regs(dv[c]);
      sm90::fence_regs(dk[c]);
    }

    sm90::mbar_arrive(empty0 + 8 * stage);
    // refill this stage with tile t + 2 once every thread is done with it
    if (tid == 0 && t + 2 < n_tiles) {
      sm90::mbar_wait(empty0 + 8 * stage, parity);
      load_q(t + 2);
    }
    __syncwarp();
  }

  __nv_bfloat16* dkg = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvg = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = key_lo + 8 * h2;
    if (key >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + cq;
        if (d < p.D) {
          const int i = 4 * j + 2 * h2;
          *reinterpret_cast<__nv_bfloat162*>(dkg + key * p.dk_ss + d) =
              __floats2bfloat162_rn(dk[c][i] * p.scale,
                                    dk[c][i + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(dvg + key * p.dv_ss + d) =
              __floats2bfloat162_rn(dv[c][i], dv[c][i + 1]);
        }
      }
  }
}

template <int DCH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<DCH>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_sm90_kernel<DCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + 63) / 64, p.H, p.B);
  dkv_sm90_kernel<DCH><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned8(const int64_t* st, int n) {
  for (int i = 0; i < n; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// Same arguments as pt_flash_attention_bwd_dkv (flash_attention_bwd.cu):
// reads q, k, v, dout, bias, lse and di (written by the dq entry point),
// writes dk and dv; out, dq, ds and g_lse (folded into di) are not read. dtype must be 1
// (bfloat16). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue when the call breaks TMA's rules (see the top).
extern "C" int pt_flash_attention_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* bias, const void* lse, void* di, void* dq,
    void* dk, void* dv, void* ds, const void* g_lse, int dtype, int B, int H,
    int Sq, int Sk, int D, const int64_t* st, float scale, int causal,
    const void* seed, int drop_t, void* stream) {
  (void)out, (void)dq, (void)ds, (void)g_lse;  // g_lse is in di already
  if (dtype != 1 || D < 8 || D > 128 || D % 8 != 0 || B < 1 || H < 1 ||
      Sq < 1 || Sk < 1 || drop_t < 0 ||
      (drop_t > 0 && seed == nullptr) || drop_t > 255 ||
      reinterpret_cast<uintptr_t>(dk) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dv) % 16 != 0 || !aligned8(st + 18, 6))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  if (!sm90::encode_seq(&p.tq, q, B, H, Sq, D, st[0], st[1], st[2], 64) ||
      !sm90::encode_seq(&p.tk, k, B, H, Sk, D, st[3], st[4], st[5], 64) ||
      !sm90::encode_seq(&p.tv, v, B, H, Sk, D, st[6], st[7], st[8], 64) ||
      !sm90::encode_seq(&p.tdo, dout, B, H, Sq, D, st[12], st[13], st[14],
                        64))
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.bias = static_cast<const float*>(bias);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.dk_sb = st[18];
  p.dk_ss = st[19];
  p.dk_sh = st[20];
  p.dv_sb = st[21];
  p.dv_ss = st[22];
  p.dv_sh = st[23];
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
