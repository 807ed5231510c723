// Quantized matrix product for Hopper's tensor cores (sm_90a), plain C
// interface: wgmma.mma_async and TMA.
//
// Replaces: paddle_tpu/kernels/quantized_matmul.py _qmm_block (line 64),
// reached through quantized_matmul (line 91) and its pl.pallas_call
// (line 104). C = A.B for A [M, K], B [K, N] (float32 or bf16, M, N, K
// multiples of 128), float32 out, in one of two modes:
//   int8: every 128x128 tile of A and of B gets one scale
//         s = max(max|tile|, 1e-30) / 127 and is rounded to
//         q = clamp(rint(v / s), -127, 127) (half to even, as jnp.round).
//         Each 128-deep K tile is an exact int32 sum of q products; it is
//         folded into a float32 accumulator as
//         acc = acc + isum * (sx * sy), each operation rounded once, in
//         K order: the TPU kernel's grouping. An int32 tile sum is exact
//         (|sum| <= 128 * 127^2 < 2^24), so this kernel equals its plain
//         version (kernels/quantized_matmul.py) bit for bit.
//   bf16: A and B rounded to bf16 (round to nearest even), products summed
//         in float32.
//
// What bounds it on this card: bytes. At the serving shapes the float32
// output dominates: [8192, 512] x [512, 512] moves 34.6 MB of A, B and C
// (10.3 us at 3.35 TB/s) against 4.3 GFLOP (4.3 us at the bf16 tensor-core
// peak, 2.2 us at the int8 one); [8192, 512] x [512, 32000] writes 1.05 GB
// of C (0.338 ms). The earlier design (mma.sync on 64x64 tiles staged
// through shared memory without pipelining, after two pre-pass launches
// that wrote a second copy of both operands) reached a quarter of this
// bound.
//
// What the design does about that:
//   * one pre-pass launch for both operands, a block a 128x128 tile: each
//     warp reads 16 whole rows of it (16 bytes a thread), the block max
//     gives the scale, and the rounded tile leaves as 4 values a thread
//     (as it lies) or through shared memory as 16-byte chunks (transposed).
//     int8 writes A as int8 [M, K] and B transposed as int8 [N, K], the
//     K-major layout both 8-bit wgmma operands need; bf16 writes only B,
//     as bf16 [N, K], and A only when it is not 16-byte aligned;
//   * the GEMM: one block an SM, each looping over tiles of C, and its
//     TMA ring running on into the next tile while the consumers store
//     this one's (with one block an SM nothing else would hide the
//     stores). A tile is 128 rows of C and 128 columns (256 where a
//     float32 A is rounded in the consumers and N allows: that halves the
//     reads of A, 4 bytes a value, which with those of B bound the
//     128-wide tile at the shapes of the serving forward) and loops over
//     K; two warpgroups each own 64 rows and issue wgmma m64nN (k32 s8 x
//     s8 -> s32, or k16 bf16 x bf16 -> f32) from tiles that thread 0 loads
//     by TMA (128-byte swizzle) into a ring of stages with full/empty
//     mbarriers. In bf16 mode a float32 A is read by TMA as it lies and
//     rounded to bf16 by the consumers into the register A operand, so A
//     is read once from device memory and written never; a bf16 A is read
//     by wgmma from shared memory;
//   * int8: each 128-deep K tile is one stage; its s32 product starts from
//     zero (scale-d = 0 on its first k32 step) and is folded into the
//     float32 accumulator as above, in K order;
//   * C leaves the registers as 16-byte stores (a lane pair swaps halves
//     of its accumulator rows with one shuffle), each row's 32 bytes from
//     two lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"  // mbarrier, TMA, descriptors, maps

namespace {

constexpr int TILE = 128;           // the quantization tile
constexpr int PACK_THREADS = 256;   // a tile a block: 8 warps x 16 rows
constexpr int BM = 128;             // C rows of a GEMM block (2 x 64)
constexpr int GTHREADS = 256;       // two consumer warpgroups
constexpr uint32_t PART = 128 * 128;  // one [128 rows][128 bytes] tile

// ------------------------------------------------------------- pre-pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive values as float32: one 16-byte (float32) or 8-byte
// (bf16) load where the operand's base is 16-byte aligned (kAligned),
// else four loads of one value
template <bool kAligned>
__device__ __forceinline__ float4 load4(const float* p) {
  if constexpr (kAligned) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
template <bool kAligned>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  if constexpr (kAligned) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
}

// the bits of one value of the output type: int8 clamp(rint(v / s)),
// or bf16 round to nearest even
template <bool kInt8>
__device__ __forceinline__ uint32_t quant(float v, float s) {
  if constexpr (kInt8) {
    const float t = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
    return static_cast<uint32_t>(static_cast<int>(t)) & 0xFFu;
  } else {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

// Row stride in bytes of the shared tile a transposed tile passes through.
template <bool kInt8>
__host__ __device__ constexpr int sm_ld() {
  return kInt8 ? TILE + 4 : 2 * TILE + 8;
}

// Tile (tr, tc) of src [R, C] (row-major). Each warp reads 16 whole rows
// of the tile, 16 bytes a thread and a row's 512 (float32) or 256 (bf16)
// bytes a warp; the output has 1 byte (int8) or 2 (bf16) a value.
// kInt8: scale and round to int8 (the tile's scale to
// scales[tr * C/128 + tc]); else round to bf16. kTranspose: dst is [C, R]
// (through the shared tile `sm`, written out 16 bytes a thread along R),
// else [R, C] (straight from registers).
template <typename Tin, bool kInt8, bool kTranspose, bool kAligned>
__device__ __forceinline__ void pack_one(const Tin* __restrict__ src, int R,
                                         int C, int tr, int tc,
                                         uint8_t* __restrict__ dst,
                                         float* __restrict__ scales,
                                         uint8_t* sm, float* red) {
  constexpr int EB = kInt8 ? 1 : 2;  // output bytes a value
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tin* s0 = src + static_cast<size_t>(tr * TILE + 16 * warp) * C +
                  tc * TILE + 4 * lane;
  float4 v[16];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    v[i] = load4<kAligned>(s0 + static_cast<size_t>(i) * C);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                             fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
  }
  float s = 1.f;
  if (kInt8) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < PACK_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
    s = __fdiv_rn(fmaxf(amax, 1e-30f), 127.f);
    if (tid == 0) scales[tr * (C / TILE) + tc] = s;
  }
  // row 16 warp + i, columns 4 lane .. + 3 of the tile
  uint8_t* row0 = kTranspose
                      ? sm + 16 * warp * sm_ld<kInt8>() + 4 * lane * EB
                      : dst + (static_cast<size_t>(tr * TILE + 16 * warp) * C +
                               tc * TILE + 4 * lane) * EB;
  const size_t ld = kTranspose ? sm_ld<kInt8>() : static_cast<size_t>(C) * EB;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t q0 = quant<kInt8>(v[i].x, s), q1 = quant<kInt8>(v[i].y, s);
    const uint32_t q2 = quant<kInt8>(v[i].z, s), q3 = quant<kInt8>(v[i].w, s);
    if constexpr (kInt8)
      *reinterpret_cast<uint32_t*>(row0 + i * ld) =
          q0 | (q1 << 8) | (q2 << 16) | (q3 << 24);
    else
      *reinterpret_cast<uint2*>(row0 + i * ld) =
          make_uint2(q0 | (q1 << 16), q2 | (q3 << 16));
  }
  if constexpr (kTranspose) {
    __syncthreads();
    // dst row tc*128 + c holds column c of the tile: 128 values along R,
    // 16-byte chunks of 16 (int8) or 8 (bf16) of them
    constexpr int PER = 16 / EB, CHUNKS = TILE / PER;
#pragma unroll
    for (int q = tid; q < TILE * CHUNKS; q += PACK_THREADS) {
      const int c = q / CHUNKS, j = q % CHUNKS;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const uint8_t* at = sm + (j * PER + e) * sm_ld<kInt8>() + c * EB;
        const uint32_t bits =
            kInt8 ? *at : *reinterpret_cast<const uint16_t*>(at);
        w[e * EB / 4] |= bits << (8 * ((e * EB) % 4));
      }
      *reinterpret_cast<uint4*>(
          dst + (static_cast<size_t>(tc * TILE + c) * R + tr * TILE +
                 j * PER) * EB) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One launch for both operands: blocks [0, nx) pack the tiles of A [M, K]
// as they lie (none when nx is 0), the others the tiles of B [K, N]
// transposed to [N, K]. kAligned: both bases are 16-byte aligned.
template <typename TA, typename TB, bool kInt8, bool kAligned>
__global__ void __launch_bounds__(PACK_THREADS, 2)
    pack_both(const TA* __restrict__ a, void* __restrict__ qa,
              float* __restrict__ sa, int nx, const TB* __restrict__ b,
              void* __restrict__ qbt, float* __restrict__ sb, int M, int N,
              int K) {
  __shared__ __align__(16) uint8_t sm[TILE * sm_ld<kInt8>()];
  __shared__ float red[PACK_THREADS / 32];
  const int bid = blockIdx.x;
  if (bid < nx) {
    pack_one<TA, kInt8, false, kAligned>(a, M, K, bid / (K / TILE),
                                         bid % (K / TILE),
                                         static_cast<uint8_t*>(qa), sa, sm,
                                         red);
  } else {
    const int t = bid - nx;
    pack_one<TB, kInt8, true, kAligned>(b, K, N, t / (N / TILE),
                                        t % (N / TILE),
                                        static_cast<uint8_t*>(qbt), sb, sm,
                                        red);
  }
}

// ------------------------------------------------------------ the GEMM

#define PT_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A . B^T, bf16, A [64 x 16] and B [128 x 16] K-major in shared
// memory
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PT_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B^T, bf16, A [64 x 16] from registers (fragment a), B
// [128 x 16] K-major in shared memory
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (+)= A . B^T, s8 x s8 -> s32, A [64 x 32] and B [128 x 32] K-major in
// shared memory
__device__ __forceinline__ void wgmma_s8_ss(int32_t (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PT_D64
      ", %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),
        "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),
        "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef PT_D64

#define PT_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d (+)= A . B^T, bf16, A [64 x 16] from registers (fragment a), B
// [256 x 16] K-major in shared memory
__device__ __forceinline__ void wgmma_bf16_rs256(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " PT_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef PT_D128

struct GemmParams {
  CUtensorMap ta, tb;
  const float* sa;  // int8: [M/128, K/128]
  const float* sb;  // int8: [K/128, N/128]
  float* out;
  int M, N, K;
};

// MODE 0 int8 (A int8 [M, K]), 1 bf16 with A bf16 [M, K], 2 bf16 with A
// float32 [M, K] (rounded by the consumers). B is [N, K] int8 / bf16; a
// block owns BM x BN of C (BN 256 only in MODE 2, where it halves how
// often the float32 A is read: at 8192x512x512 the reads of A and B from
// L2 bounded the 128-wide tile). A stage holds 128 bytes of K of every
// row: one quantization tile (128) in int8, 64 in bf16; A float32 comes
// as two [128][32] boxes.
template <int MODE, int BN>
struct Cfg {
  static constexpr uint32_t A_BYTES = MODE == 2 ? 2 * PART : PART;
  static constexpr uint32_t STAGE = A_BYTES + BN * 128;
  static constexpr int STAGES = STAGE > 48 * 1024 ? 3 : 4;
  static constexpr int KT = MODE == 0 ? 128 : 64;  // K per stage
  static constexpr uint32_t SMEM = 1024 + STAGES * STAGE + 64;
};

template <int MODE, int BN>
__global__ void __launch_bounds__(GTHREADS, 1)
    qmm_sm90_kernel(const __grid_constant__ GemmParams p) {
  using C = Cfg<MODE, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  const uint32_t bar0 = sbase + C::STAGES * C::STAGE;  // full[s], empty[s]
  const uint8_t* gbase = smem_raw + (sbase - raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;             // consumer warpgroup: rows 64 wg ..
  const int warp = (tid >> 5) & 3;     // warp within it
  const int lane = tid & 31;
  const int nk = p.K / C::KT;
  const int tiles_n = p.N / BN;
  // this block's C tiles: blockIdx.x, + gridDim.x, ...; its loads are
  // numbered g = (i-th tile) * nk + kt across them, so the ring runs on
  // into the next tile while this one's epilogue stores C
  const int n_mine =
      (tiles_n * (p.M / BM) - static_cast<int>(blockIdx.x) +
       static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  const int n_loads = n_mine * nk;

  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (C::STAGES + s); };
  auto load = [&](int g) {
    const int s = g % C::STAGES, kt = g % nk;
    const int tile = blockIdx.x + (g / nk) * gridDim.x;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const uint32_t at = sbase + s * C::STAGE;
    sm90::mbar_expect_tx(full(s), C::STAGE);
    if (MODE == 2) {
      sm90::tma_load_2d(at, &p.ta, full(s), kt * C::KT, m0);
      sm90::tma_load_2d(at + PART, &p.ta, full(s), kt * C::KT + 32, m0);
    } else {
      sm90::tma_load_2d(at, &p.ta, full(s), kt * 128 / (MODE == 0 ? 1 : 2),
                        m0);
    }
    sm90::tma_load_2d(at + C::A_BYTES, &p.tb, full(s),
                kt * 128 / (MODE == 0 ? 1 : 2), n0);
  };
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), GTHREADS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int g = 0; g < C::STAGES && g < n_loads; ++g) load(g);
  __syncwarp();

  // this thread's A rows within the block and its columns
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);

  for (int i = 0; i < n_mine; ++i) {
    const int tile = blockIdx.x + i * gridDim.x;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    float acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
    // int8: the scales of this tile's A and B tiles, one of each a K tile
    const float* sa_row = MODE == 0 ? p.sa + (m0 / TILE) * (p.K / TILE)
                                    : nullptr;
    const float* sb_col = MODE == 0 ? p.sb + n0 / TILE : nullptr;

    for (int kt = 0; kt < nk; ++kt) {
      const int g = i * nk + kt;
      const int s = g % C::STAGES;
      const uint32_t parity = (g / C::STAGES) & 1;
      const uint32_t a_s = sbase + s * C::STAGE;
      const uint32_t b_s = a_s + C::A_BYTES;
      sm90::mbar_wait(full(s), parity);
      if constexpr (MODE == 0) {
        int32_t isum[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) isum[e] = 0;
        sm90::fence_regs(isum);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8_ss(isum, sm90::desc_kmajor(a_s + wg * 8192 + kk * 32),
                      sm90::desc_kmajor(b_s + kk * 32), kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(isum);
        const float sc = __fmul_rn(sa_row[kt], sb_col[kt * (p.N / TILE)]);
#pragma unroll
        for (int e = 0; e < 64; ++e)
          acc[e] = __fadd_rn(acc[e],
                             __fmul_rn(static_cast<float>(isum[e]), sc));
      } else if constexpr (MODE == 1) {
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_ss(acc, sm90::desc_kmajor(a_s + wg * 8192 + kk * 32),
                        sm90::desc_kmajor(b_s + kk * 32), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc);
      } else {
        // the A fragment of k16 step kk from the float32 boxes: rows r0
        // and r0 + 8, columns 16 kk + cq (+1) and 16 kk + 8 + cq (+1),
        // rounded to bf16 pairs
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint8_t* box = gbase + (a_s - sbase) + (kk >> 1) * PART;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = r0 + 8 * (q & 1);
            const int col = 16 * (kk & 1) + cq + 8 * (q >> 1);
            const float2 v = *reinterpret_cast<const float2*>(
                box + sm90::swizzled<128>(r * 128 + col * 4));
            a[kk][q] = sm90::pack_bf16(v.x, v.y);
          }
        }
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (BN == 256)
            wgmma_bf16_rs256(acc, a[kk], sm90::desc_kmajor(b_s + kk * 32),
                             1);
          else
            wgmma_bf16_rs(acc, a[kk], sm90::desc_kmajor(b_s + kk * 32), 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(acc);
      }
      sm90::mbar_arrive(empty(s));
      // refill this stage once both warpgroups are done with it
      if (tid == 0 && g + C::STAGES < n_loads) {
        sm90::mbar_wait(empty(s), parity);
        load(g + C::STAGES);
      }
      __syncwarp();
    }

    // acc[4j + 2h + e] is (row r0 + 8h, column 8j + cq + e). Lanes c and
    // c ^ 1 swap: an even lane stores 4 columns of row r0, an odd one 4
    // of row r0 + 8, as one 16-byte store each.
    const bool odd = lane & 1;
    float* orow = p.out +
                  static_cast<size_t>(m0 + r0 + (odd ? 8 : 0)) * p.N + n0 +
                  (cq & ~3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float s0 = odd ? acc[4 * j] : acc[4 * j + 2];
      const float s1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
      const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      const float4 v = odd ? make_float4(g0, g1, acc[4 * j + 2],
                                         acc[4 * j + 3])
                           : make_float4(acc[4 * j], acc[4 * j + 1], g0, g1);
      *reinterpret_cast<float4*>(orow + 8 * j) = v;
    }
  }
}

template <int MODE, int BN>
int gemm(GemmParams& p, cudaStream_t stream) {
  using C = Cfg<MODE, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      qmm_sm90_kernel<MODE, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM (its shared memory and registers allow no second),
  // each looping over C tiles
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  const int tiles = (p.N / BN) * (p.M / BM);
  qmm_sm90_kernel<MODE, BN>
      <<<tiles < sms ? tiles : sms, GTHREADS, C::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kInt8>
int pack(const void* x, int x_dtype, void* wa, float* sa, int nx,
         const void* y, int y_dtype, void* wb, float* sb, int M, int N,
         int K, cudaStream_t stream) {
  const int blocks = nx + (K / TILE) * (N / TILE);
  const bool aligned = (nx == 0 || reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
#define PT_PACK2(TA, TB, AL)                                                \
  pack_both<TA, TB, kInt8, AL><<<blocks, PACK_THREADS, 0, stream>>>(       \
      static_cast<const TA*>(x), wa, sa, nx, static_cast<const TB*>(y), wb, \
      sb, M, N, K)
#define PT_PACK(TA, TB)       \
  if (aligned)                \
    PT_PACK2(TA, TB, true);   \
  else                        \
    PT_PACK2(TA, TB, false)
  if (x_dtype == 0 && y_dtype == 0) {
    PT_PACK(float, float);
  } else if (x_dtype == 0) {
    PT_PACK(float, __nv_bfloat16);
  } else if (y_dtype == 0) {
    PT_PACK(__nv_bfloat16, float);
  } else {
    PT_PACK(__nv_bfloat16, __nv_bfloat16);
  }
#undef PT_PACK2
#undef PT_PACK
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [M, N] float32 = x [M, K] . y [K, N]; x_dtype / y_dtype: 0 float32,
// 1 bf16; mode: 0 int8, 1 bf16. Workspace from the caller:
//   int8: wa int8 [M, K], wb int8 [N, K], sa float [M/128, K/128],
//         sb float [K/128, N/128] (the scales, kept for inspection);
//   bf16: wa bf16 [M, K] or NULL: NULL reads x as it is (16-byte
//         aligned), else the pre-pass rounds x into it; wb bf16 [N, K];
//         sa, sb unused.
// Two launches: the pre-pass, then the GEMM. Returns the first
// cudaError_t of the launches (cudaErrorInvalidValue for shapes or
// pointers the kernels do not take).
extern "C" int pt_quantized_matmul(const void* x, int x_dtype, const void* y,
                                   int y_dtype, int M, int N, int K,
                                   int mode, void* wa, void* wb, void* sa,
                                   void* sb, void* out, void* stream_ptr) {
  if (M <= 0 || N <= 0 || K <= 0 || M % TILE || N % TILE || K % TILE ||
      x_dtype < 0 || x_dtype > 1 || y_dtype < 0 || y_dtype > 1 ||
      mode < 0 || mode > 1 || wb == nullptr ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  GemmParams p;
  p.out = static_cast<float*>(out);
  p.M = M;
  p.N = N;
  p.K = K;
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  int err;
  if (mode == 0) {
    if (wa == nullptr || sa == nullptr || sb == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if ((err = pack<true>(x, x_dtype, wa, static_cast<float*>(sa),
                                  (M / TILE) * (K / TILE), y, y_dtype, wb,
                                  static_cast<float*>(sb), M, N, K, stream)))
      return err;
    if (!sm90::encode_2d(&p.ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wa, M, K,
                         128) ||
        !sm90::encode_2d(&p.tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wb, N, K,
                         128))
      return static_cast<int>(cudaErrorInvalidValue);
    return gemm<0, 128>(p, stream);
  }
  const int nx = wa == nullptr ? 0 : (M / TILE) * (K / TILE);
  if ((err = pack<false>(x, x_dtype, wa, nullptr, nx, y, y_dtype, wb,
                         nullptr, M, N, K, stream)))
    return err;
  if (!sm90::encode_2d(&p.tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wb, N, K,
                       64))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wa != nullptr || x_dtype == 1) {
    if (!sm90::encode_2d(&p.ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   wa != nullptr ? wa : x, M, K, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    return gemm<1, 128>(p, stream);
  }
  if (!sm90::encode_2d(&p.ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, M, K,
                       32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N % 256 != 0) return gemm<2, 128>(p, stream);
  if (!sm90::encode_2d(&p.tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wb, N, K, 64,
                 256))
    return static_cast<int>(cudaErrorInvalidValue);
  return gemm<2, 256>(p, stream);
}
