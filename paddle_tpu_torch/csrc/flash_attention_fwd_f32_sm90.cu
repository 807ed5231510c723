// Flash-attention forward for Hopper's tensor cores in float32 (sm_90a),
// plain C interface: 3xTF32 wgmma.mma_async for both products, TMA for q
// and k.
//
// Replaces: paddle_tpu/kernels/flash_attention.py _fa_kernel (line 353),
// reached through _fa_forward (line 593) and its pl.pallas_call (line
// 663), for float32 inputs (the serving forward's). Same function as the
// CUDA-core kernel of flash_attention_fwd.cu: s = q.k^T * scale + bias
// (bias [B|1, H|1, Sq|1, Sk] float32, read by strides), causal mask
// (absolute col > row) with the finite -1e30, keys past Sk at -inf, online
// softmax in float32, attention dropout by the position hash of
// flash_attention_common.cuh (kept weights scale by 256/t; l sums the
// undropped weights), out = acc / max(l, 1e-30) in float32, optional
// lse = m + log(max(l, 1e-30)) [B, H, Sq] float32.
//
// What bounds it on this card: at the Transformer-base serving shape
// (B=32, S=256, H=8, D=64) one call does 4*B*H*S*S*D = 4.3 GFLOP and moves
// q, k, v and out once, 67 MB. On the CUDA cores that is 64 us at the
// 67 TFLOP/s float32 peak (the CUDA-core kernel reached 23 % of it).
// Plain TF32 on the tensor cores keeps 11 bits and misses the float32
// tolerance; 3xTF32 keeps float32's: each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi), and a product is hi.hi + hi.lo +
// lo.hi (lo.lo, about 2^-22 of it, is dropped), as CUTLASS's
// OpMultiplyAddFastF32 does. That is 12.9 GFLOP of TF32, 26 us at
// 495 TFLOP/s, next to 20 us of bytes: bound by operations, and then by
// the work around the products on the CUDA cores (the splits, the
// transpose of v, exp2, the masks).
//
// What the design does about that:
//   * one block of one warpgroup (128 threads) per (batch, head, 64 query
//     rows), two blocks an SM at D <= 64 (96 KB of shared memory each);
//     thread 0 loads q once and k a tile at a time by TMA (128-byte
//     swizzle, 32 float32 columns a row); the next k tile is requested as
//     soon as this tile's S product has read it;
//   * the block splits q once and each k tile in shared memory: hi in
//     place, lo beside it; S = Q.K^T by wgmma m64n64k8 tf32 from shared
//     memory (both K-major as they lie), three products a k8 step;
//   * tf32 wgmma takes 32-bit operands from shared memory only K-major,
//     and v ([key][d]) is MN-major for O += P.V. So each thread loads its
//     part of the next v tile into registers (float4, 32 keys x 64
//     columns a warp) while this tile computes, then writes it
//     transposed, split, as V^T [d][key] tiles: a warp writes one row
//     (32 keys) at a time, conflict-free under the swizzle;
//   * P is the A operand from registers. The accumulator holds columns
//     2c, 2c + 1 of each 8-key step in lane c of a quad, the A fragment
//     wants columns c and c + 4: instead of moving P across lanes, V^T's
//     keys are written in the fragment's order (k-position c <- key 2c,
//     c + 4 <- key 2c + 1), so P splits in place into hi and lo
//     fragments;
//   * scores are kept in log2 units, each mask only in the tiles that
//     need it (the diagonal tile, the ragged last tile), as in the bf16
//     kernel (flash_attention_fwd_sm90.cu); ragged Sq and D short of a
//     chunk come from TMA's zero fill, ragged Sk from the masks and the
//     zeroed v rows.
//
// Layouts bshd ([B, S, H, D]) and bhsd ([B, H, S, D]) arrive as strides.
// TMA's rules for 4-byte elements: D a multiple of 4 and at most 128,
// 16-byte-aligned bases, strides multiples of 16 bytes (the wrapper's
// _sm90_eligible); the entry point refuses anything else.

#include "flash_attention_sm90.cuh"

namespace {

using fa::L_FLOOR;
using sm90::TILE_BYTES;  // [64 rows][128 bytes]: 32 float32 columns
// the finite mask value -1e30 in log2 units (scores are kept in them)
constexpr float NEG2 = fa::NEG_INF * fa::LOG2E;

struct Params {
  sm90::SeqMap tq, tk;
  const float* v;
  const float* bias;
  float* out;
  float* lse;
  int B, H, Sq, Sk, D;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t bias_sb, bias_sh, bias_sq;
  float scale;
  int causal;
  const int64_t* seed;  // [2] on the card; null: no dropout
  int drop_t;
  float drop_scale;
};

// DC: 64-column chunks of the head dim (1: D <= 64, 2: D <= 128). Shared
// memory, each region 2 DC tiles: Q hi, Q lo, K (TMA lands here, hi in
// place), K lo, V^T hi, V^T lo (two 32-key chunks of [64 DC rows][128 B]);
// then the barriers (q, k).
template <int DC>
constexpr uint32_t smem_bytes() {
  return 1024 + 12 * DC * TILE_BYTES + 16;
}

template <int DC>
__global__ void __launch_bounds__(128, DC == 1 ? 2 : 1)
    fa_fwd_f32_sm90_kernel(const __grid_constant__ Params p) {
  constexpr int QC = 2 * DC;                // 32-column chunks of q and k
  constexpr uint32_t REGION = QC * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sQlo = sQ + REGION;
  const uint32_t sK = sQlo + REGION;
  const uint32_t sKlo = sK + REGION;
  const uint32_t sVT = sKlo + REGION;
  const uint32_t sVTlo = sVT + REGION;
  const uint32_t bar_q = sVTlo + REGION, bar_k = bar_q + 8;
  uint8_t* const gen = smem_raw + (sQ - raw);  // generic address of sQ
  auto at = [&](uint32_t a) { return gen + (a - sQ); };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * 64;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n32 = (p.D + 31) / 32;  // chunks of q and k that hold columns

  // causal: keys past the block's last row are masked for every row
  const int kv_end = p.causal ? min(p.Sk, q0 + 64) : p.Sk;
  const int n_tiles = (kv_end + 63) / 64;

  auto load_k = [&](int t) {
    sm90::mbar_expect_tx(bar_k, n32 * TILE_BYTES);
    for (int c = 0; c < n32; ++c)
      sm90::tma_load_rows(sK + c * TILE_BYTES, p.tk, bar_k, c, 64 * t, h, b);
  };
  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    sm90::mbar_init(bar_k, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar_q, n32 * TILE_BYTES);
    for (int c = 0; c < n32; ++c)
      sm90::tma_load_rows(sQ + c * TILE_BYTES, p.tq, bar_q, c, q0, h, b);
    load_k(0);
  }

  // v: this thread's key (32 keys a warp, warps 0/2 the first 32 of a
  // tile, 1/3 the next) and its 32 DC columns (warps 0/1 the first half)
  const int vkey = 32 * (warp & 1) + lane;
  const int vcol0 = 32 * DC * (warp >> 1);
  const float* vg = p.v + b * p.v_sb + h * p.v_sh + vcol0;
  float4 vr[8 * DC];
  auto load_v = [&](int t) {
    const int key = 64 * t + vkey;
    const float* src = vg + static_cast<int64_t>(key) * p.v_ss;
#pragma unroll
    for (int i = 0; i < 8 * DC; ++i)
      vr[i] = key < p.Sk && vcol0 + 4 * i < p.D
                  ? __ldg(reinterpret_cast<const float4*>(src + 4 * i))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  // V^T[d][kpos] of this thread's key chunk: the key 8s + r of the chunk
  // sits at k-position 8s + (r odd ? 4 + r/2 : r/2), the place the P
  // fragment of k8 step s reads it from (see the top)
  const int r8 = lane & 7;
  const int kpos = 8 * (lane >> 3) + ((r8 & 1) ? 4 + (r8 >> 1) : (r8 >> 1));
  const uint32_t vt_base = (warp & 1) * DC * TILE_BYTES;
  auto store_vt = [&]() {
    uint8_t* hi = at(sVT) + vt_base;
    uint8_t* lo = at(sVTlo) + vt_base;
#pragma unroll
    for (int i = 0; i < 8 * DC; ++i) {
      const float x[4] = {vr[i].x, vr[i].y, vr[i].z, vr[i].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = vcol0 + 4 * i + e;
        const uint32_t off =
            n * 128 + (((kpos >> 2) ^ (n & 7)) << 4) + ((kpos & 3) << 2);
        uint32_t xh, xl;
        sm90::split_tf32(x[e], xh, xl);
        *reinterpret_cast<uint32_t*>(hi + off) = xh;
        *reinterpret_cast<uint32_t*>(lo + off) = xl;
      }
    }
  };
  // the tf32 split of n32 tiles of a q or k region: hi in place, lo beside
  auto split_region = [&](uint32_t src, uint32_t lo_dst) {
    uint4* x = reinterpret_cast<uint4*>(at(src));
    uint4* y = reinterpret_cast<uint4*>(at(lo_dst));
    const int n16 = n32 * (TILE_BYTES / 16);
    for (int i = tid; i < n16; i += 128) {
      uint4 v = x[i], w;
      sm90::split_tf32(__uint_as_float(v.x), v.x, w.x);
      sm90::split_tf32(__uint_as_float(v.y), v.y, w.y);
      sm90::split_tf32(__uint_as_float(v.z), v.z, w.z);
      sm90::split_tf32(__uint_as_float(v.w), v.w, w.w);
      x[i] = v;
      y[i] = w;
    }
  };

  // this thread's rows: r_lo (d[4j + e]) and r_lo + 8 (d[4j + 2 + e]);
  // columns 8j + cq + e of each key tile
  const int r_lo = q0 + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float* brow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2)
    brow[h2] = p.bias != nullptr && r_lo + 8 * h2 < p.Sq
                   ? p.bias + b * p.bias_sb + h * p.bias_sh +
                         (r_lo + 8 * h2) * p.bias_sq
                   : nullptr;
  const uint32_t hseed = fa::head_seed_dev(p.seed, b * p.H + h);
  const float scale2 = p.scale * fa::LOG2E;

  float o[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {NEG2, NEG2}, l[2] = {0.f, 0.f};

  load_v(0);
  sm90::mbar_wait(bar_q, 0);
  split_region(sQ, sQlo);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = 64 * t;
    const bool edge = k0 + 64 > p.Sk;
    sm90::mbar_wait(bar_k, t & 1);
    __syncthreads();  // the last tile's products have read K lo and V^T
    split_region(sK, sKlo);
    store_vt();
    sm90::fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles) load_v(t + 1);  // lands while this tile computes

    // S = Q.K^T: lo.hi + hi.lo + hi.hi a k8 step
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      if (c >= n32) break;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t off = c * TILE_BYTES + kk * 32;
        sm90::wgmma_ss_tf32(s, sm90::desc_kmajor(sQlo + off),
                            sm90::desc_kmajor(sK + off), 1);
        sm90::wgmma_ss_tf32(s, sm90::desc_kmajor(sQ + off),
                            sm90::desc_kmajor(sKlo + off), 1);
        sm90::wgmma_ss_tf32(s, sm90::desc_kmajor(sQ + off),
                            sm90::desc_kmajor(sK + off), 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    __syncthreads();  // every warp's products have read this k tile
    if (tid == 0 && t + 1 < n_tiles) load_k(t + 1);

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
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[c][4 * j + 2 * h2] *= corr;
          o[c][4 * j + 2 * h2 + 1] *= corr;
        }
    }

    // O += P.V: P split in registers (k8 step j: keys 8j + cq, + 1 of
    // rows r_lo, r_lo + 8), V^T K-major: lo.hi + hi.lo + hi.hi a step
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sm90::split_tf32(s[4 * j + 0], ph[j][0], pl[j][0]);
      sm90::split_tf32(s[4 * j + 2], ph[j][1], pl[j][1]);
      sm90::split_tf32(s[4 * j + 1], ph[j][2], pl[j][2]);
      sm90::split_tf32(s[4 * j + 3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) sm90::fence_regs(o[c]);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // key chunk j / 4, k8 step j % 4 in it, rows 64c.. of V^T
        const uint32_t off =
            (j >> 2) * DC * TILE_BYTES + c * TILE_BYTES + (j & 3) * 32;
        sm90::wgmma_rs_tf32(o[c], pl[j], sm90::desc_kmajor(sVT + off), 1);
        sm90::wgmma_rs_tf32(o[c], ph[j], sm90::desc_kmajor(sVTlo + off), 1);
        sm90::wgmma_rs_tf32(o[c], ph[j], sm90::desc_kmajor(sVT + off), 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DC; ++c) sm90::fence_regs(o[c]);
  }

  // out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
  float* og = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = r_lo + 8 * h2;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(lt, L_FLOOR);
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * c + 8 * j + cq;
        if (d < p.D)
          *reinterpret_cast<float2*>(og + row * p.o_ss + d) =
              make_float2(o[c][4 * j + 2 * h2] / denom,
                          o[c][4 * j + 2 * h2 + 1] / denom);
      }
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[(static_cast<int64_t>(b) * p.H + h) * p.Sq + row] =
          m[h2] * fa::LN2 + logf(denom);
  }
}

template <int DC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr uint32_t smem = smem_bytes<DC>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_f32_sm90_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + 63) / 64, p.H, p.B);
  fa_fwd_f32_sm90_kernel<DC><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Same arguments as pt_flash_attention_fwd (flash_attention_fwd.cu);
// dtype must be 0 (float32). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue when the call breaks TMA's rules (see the top).
extern "C" int pt_flash_attention_fwd_f32_sm90(
    const void* q, const void* k, const void* v, const void* bias,
    void* out, void* lse, int dtype, int B, int H, int Sq, int Sk, int D,
    const int64_t* strides, float scale, int causal, const void* seed,
    int drop_t, void* stream) {
  if (dtype != 0 || D < 4 || D > 128 || D % 4 != 0 || B < 1 || H < 1 ||
      Sq < 1 || Sk < 1 || drop_t < 0 ||
      (drop_t > 0 && seed == nullptr) || drop_t > 255 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 6; i < 12; ++i)  // v and out strides: float4 / float2 access
    if (strides[i] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  if (!sm90::encode_seq(&p.tq, q, B, H, Sq, D, strides[0], strides[1],
                        strides[2], 64, true) ||
      !sm90::encode_seq(&p.tk, k, B, H, Sk, D, strides[3], strides[4],
                        strides[5], 64, true))
    return static_cast<int>(cudaErrorInvalidValue);
  p.v = static_cast<const float*>(v);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
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
  p.seed = drop_t > 0 ? static_cast<const int64_t*>(seed) : nullptr;
  p.drop_t = drop_t;
  p.drop_scale = drop_t > 0 ? static_cast<float>(256.0 / drop_t) : 1.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? launch<1>(p, s) : launch<2>(p, s);
  return static_cast<int>(err);
}
