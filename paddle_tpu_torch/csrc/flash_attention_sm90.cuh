// Hopper pieces shared by the tensor-core kernels (the flash-attention
// kernels flash_attention_{fwd,bwd_dq,bwd_dkv}_sm90.cu and
// flash_attention_fwd_f32_sm90.cu, the GEMMs quantized_matmul.cu and
// tuned_matmul_sm90.cu): mbarrier and TMA (cp.async.bulk.tensor) wrappers,
// wgmma.mma_async m64n64k16 bf16 and m64n64k8 / m64n128k8 tf32 with A
// from shared memory or from registers, the shared-memory matrix
// descriptors of a 128-byte-swizzled tile (and of a 64-byte-swizzled one),
// and the host-side tensor maps (4-D bf16 and float32 sequences, 2-D
// row-major matrices).
//
// Tiles. Every bf16 tile is [rows][64] elements, one 128-byte row a
// sequence position, written by TMA with CU_TENSOR_MAP_SWIZZLE_128B at a
// 1024-byte-aligned shared address (the swizzle XORs address bits 4-6
// with bits 7-9). A head dimension of 128 is two such tiles, one per
// 64-column chunk. The same tile is read by wgmma as
//   * K-major (the 64 columns are the reduction dim): 8-row groups 1024 B
//     apart (SBO), one k16 step = +32 B on the start address;
//   * MN-major (the rows are the reduction dim, the 64 columns the N
//     dim): 8 reduction rows per 1024 B (SBO), one k16 step = +2048 B.
//
// Accumulator layout of m64n64 (f32, 32 registers a thread, warp w of
// the warpgroup, lane = 4 * g + c): d[4j + 2h + e] is (row 16w + g + 8h,
// col 8j + 2c + e), j = 0..7, h, e = 0..1. The A-from-registers fragment
// of k16 step kk is the accumulator's columns 16kk..16kk+15 in the same
// places: {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]},
// {d[8kk+6], d[8kk+7]}, each pair rounded to one bf16x2 register.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link

#include "flash_attention_common.cuh"

namespace sm90 {

constexpr uint32_t TILE_BYTES = 64 * 128;  // one [64][64] bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// generic-proxy stores to shared memory (st.shared) made visible to the
// async proxy (wgmma's operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// --------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// box (c0 columns, c1 rows) of a 2-D map (see encode_2d)
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The 4-D map of a [B, S, H, D] or [B, H, S, D] tensor (see encode_seq)
// loads `rows` sequence positions x one 128-byte row of columns (64 bf16
// or 32 float32) from chunk `dc` (columns cols * dc ..) of head h, batch
// b, starting at position s0.
struct SeqMap {
  CUtensorMap map;
  int head_inner;  // 1: dims (D, H, S, B); 0: dims (D, S, H, B)
  int cols;        // columns a chunk: 64 (bf16) or 32 (float32)
};

__device__ __forceinline__ void tma_load_rows(uint32_t dst, const SeqMap& m,
                                              uint32_t bar, int dc, int s0,
                                              int h, int b) {
  if (m.head_inner)
    tma_load_4d(dst, &m.map, bar, m.cols * dc, h, s0, b);
  else
    tma_load_4d(dst, &m.map, bar, m.cols * dc, s0, h, b);
}

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins accumulator registers at this point of the program: ordinary code
// after a wgmma.wait_group reads them only after the wait, and code before
// a wgmma has written them before it is issued.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

// the reduction dim runs along the tile's 64 columns
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// K-major, rows of `kRowBytes` bytes written by TMA with the swizzle of
// that span: 128 (as desc_kmajor) or 64 (64-byte swizzle, mode 2: address
// bits 4-5 XOR bits 7-8, 8-row groups 512 B apart). A k step adds its
// byte offset within the row to addr, as with 128 bytes.
template <int kRowBytes>
__device__ __forceinline__ uint64_t desc_kmajor_rows(uint32_t addr) {
  static_assert(kRowBytes == 128 || kRowBytes == 64, "swizzle span");
  constexpr uint64_t mode = kRowBytes == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) | (mode << 62);
}

// The byte offset of `off` (row * kRowBytes + byte in the row) within a
// tile that TMA wrote with the swizzle of a kRowBytes span (a tile base
// aligned to 1024 bytes): the 16-byte chunk index XOR the row's bits.
template <int kRowBytes>
__host__ __device__ __forceinline__ uint32_t swizzled(uint32_t off) {
  return off ^ ((off >> 3) & (kRowBytes == 128 ? 0x70u : 0x30u));
}

// the reduction dim runs along the tile's rows; N = the 64 columns (one
// swizzle atom wide, so the leading offset is not read)
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, 1024, 1024);
}

#define PT_WGMMA_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PT_WGMMA_OUT32(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (+)= A . B^T, A [64 x 16] and B [64 x 16] K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PT_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : PT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B, A [64 x 16] from registers (fragment a), B [16 x 64]
// MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : PT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// tf32 (10-bit mantissa, float32 range): 32-bit operands, K = 8 a step
// (32 bytes of a 128-byte row, as bf16's k16), both shared-memory
// operands K-major (32-bit types take no transpose).

// d (+)= A . B^T, A [64 x 8] and B [64 x 8] K-major in shared memory
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PT_WGMMA_D32
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : PT_WGMMA_OUT32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A . B^T, A [64 x 8] from registers (fragment a: rows 16w + g
// (a[0], a[2]) and 16w + g + 8 (a[1], a[3]), columns c (a[0], a[1]) and
// c + 4 (a[2], a[3]) for lane 4g + c of warp w), B [64 x 8] K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PT_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : PT_WGMMA_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#define PT_WGMMA_D64                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A . B^T, A [64 x 8] from registers (fragment a, as
// wgmma_rs_tf32), B [128 x 8] K-major in shared memory. Accumulator
// layout as m64n64's, j = 0..15.
__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " PT_WGMMA_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : PT_WGMMA_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

#undef PT_WGMMA_D64
#undef PT_WGMMA_D32
#undef PT_WGMMA_OUT32

// x rounded to tf32 (to nearest, ties away), as a 32-bit pattern whose
// low 13 bits are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// the 3xTF32 split of x: hi = tf32(x), lo = tf32(x - hi); x - hi is exact
// in float32, and hi + lo is x to about 2^-22 of |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of k16 step kk from a 64 x 64 accumulator (see the top)
__device__ __forceinline__ void a_frag(const float (&d)[32], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ------------------------------------------------------------ host: maps

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// The map of one bf16 (or, with f32, float32) [B, S, H, D] or [B, H, S, D]
// tensor from its element strides of (batch, sequence, head), the head dim
// contiguous: dims ordered as they lie in memory, boxes of one 128-byte
// row of columns (64 bf16, 32 float32) x `rows` positions, 128-byte
// swizzle, zero fill past every edge (ragged S, D short of a chunk). TMA
// wants a 16-byte-aligned base and strides that are multiples of 16 bytes:
// false if those fail or the driver refuses.
inline bool encode_seq(SeqMap* m, const void* base, int B, int H, int S,
                       int D, int64_t sb, int64_t ss, int64_t sh, int rows,
                       bool f32 = false) {
  EncodeTiledFn fn = encode_tiled();
  const int64_t es = f32 ? 4 : 2;
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (sb * es) % 16 != 0 || (ss * es) % 16 != 0 || (sh * es) % 16 != 0 ||
      (D * es) % 16 != 0)
    return false;
  m->head_inner = sh <= ss;
  m->cols = static_cast<int>(128 / es);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], estr[4] = {1, 1, 1, 1};
  dims[0] = static_cast<cuuint64_t>(D);
  box[0] = static_cast<cuuint32_t>(m->cols);
  if (m->head_inner) {
    dims[1] = H, dims[2] = S;
    strides[0] = sh * es, strides[1] = ss * es;
    box[1] = 1, box[2] = rows;
  } else {
    dims[1] = S, dims[2] = H;
    strides[0] = ss * es, strides[1] = sh * es;
    box[1] = rows, box[2] = 1;
  }
  dims[3] = static_cast<cuuint64_t>(B);
  strides[2] = sb * es;
  box[3] = 1;
  return fn(&m->map,
            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4,
            const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 2-D map of a row-major [rows, K] matrix: boxes of `box_cols`
// elements (one swizzle span: 128 bytes, or 64 with SWIZZLE_64B) x
// `box_rows` rows. False if the base is not 16-byte aligned or the driver
// refuses (K * elem_bytes must be a multiple of 16).
inline bool encode_2d(CUtensorMap* m, CUtensorMapDataType type,
                      int elem_bytes, const void* base, int rows, int K,
                      int box_cols, int box_rows = 128,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * elem_bytes};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estr[2] = {1, 1};
  return fn(m, type, 2, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
