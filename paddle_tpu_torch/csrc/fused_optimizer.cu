// Adam and SGD updates for Hopper (sm_90a), plain C interface.
//
// Adam replaces: paddle_tpu/kernels/fused_optimizer.py _adam_block (line
// 108), reached through fused_adam (line 202) and its pl.pallas_call. Same
// function as the JAX lowered adam (paddle_tpu/ops/optimizer_ops.py):
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   p' = p - (lr_t*m') / (sqrt(v') + eps)
// on float32 tensors of any length, written in place over p, m and v.
// lr_t = lr*sqrt(1-b2^t)/(1-b1^t) is computed on the card by the caller
// and read here from a device pointer, so no value crosses to the host.
//
// What bounds it on this card: 4 loads and 3 stores of 4 bytes per
// element against about 10 floating-point operations: 28 bytes per
// element, far below the ridge point. It is bound by HBM bandwidth
// (93.3M elements of Transformer-base: 2.61 GB, 0.78 ms at 3.35 TB/s).
//
// What the design does about that: a grid-stride loop over the flat
// arrays, one element per thread per step, so that neighbouring threads
// touch neighbouring addresses and every byte is read or written once;
// no staging through shared memory (there is no reuse to exploit). Each
// operation is rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn keep nvcc from contracting them into fused multiply-adds),
// so the kernel gives the plain PyTorch version's results bit for bit.
// One launch per parameter; a multi-tensor launch over all parameters
// is later work.
//
// SGD replaces: paddle_tpu/kernels/fused_optimizer.py _sgd_block (line
// 133), reached through fused_sgd (line 225) and the same pl.pallas_call:
//   p' = p - lr*(g + wd*p)
// (wd = 0 on the op path, where it is the JAX lowered sgd, p - lr*g), in
// place over p, with lr read from a device pointer. 3 accesses of 4 bytes
// per element (read p and g, write p) against 2 operations: bound by HBM
// bandwidth, 12 bytes per element (Transformer-base's 255 parameters:
// 1.12 GB, 0.334 ms at 3.35 TB/s).
//
// What the design does about that: one launch updates a whole list of
// parameters (the engine hands it every sgd op of a step that shares a
// rate; a single parameter is a list of one). The list, a table of
// (p, g, n) and each tensor's first chunk, travels by value as the
// kernel's parameter (up to 32 764 bytes since CUDA 12.1 on sm_70 and
// later: 1024 tensors a launch; a longer list takes more launches), so
// no host-to-device copy precedes it. Every tensor is cut into chunks of
// CHUNK elements, one block a chunk, so the 132 SMs stay balanced over
// tensors of 16M elements and of 10; a block finds its tensor by binary
// search over the first chunks and reads lr once. Where p and g share
// their offset from a 16-byte boundary, the chunk moves as float4 loads
// and stores between a scalar head and tail; else element by element.
// Each operation is rounded on its own (lr*g is never contracted into an
// FMA with the subtraction), as in the plain version: 0 ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
    adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                float* __restrict__ m, float* __restrict__ v,
                const float* __restrict__ lr_t_ptr, int64_t n, float b1,
                float one_minus_b1, float b2, float one_minus_b2,
                float eps) {
  const float lr_t = *lr_t_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const float gi = g[i];
    const float mi =
        __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, gi));
    const float vi = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(__fmul_rn(one_minus_b2, gi), gi));
    const float upd =
        __fdiv_rn(__fmul_rn(lr_t, mi), __fadd_rn(__fsqrt_rn(vi), eps));
    p[i] = __fadd_rn(p[i], -upd);
    m[i] = mi;
    v[i] = vi;
  }
}

// elements a block updates
constexpr int SGD_CHUNK = 4096;
// tensors a launch takes: the table below stays under the 32 764 bytes a
// kernel's parameters may hold
constexpr int SGD_MAX_TENSORS = 1024;

struct SgdTable {
  const float* lr;
  float wd;
  int count;
  float* p[SGD_MAX_TENSORS];
  const float* g[SGD_MAX_TENSORS];
  int64_t n[SGD_MAX_TENSORS];
  int first_chunk[SGD_MAX_TENSORS];  // ascending; tensor t's first block
};
static_assert(sizeof(SgdTable) <= 32764, "kernel parameters too large");

__device__ __forceinline__ float sgd_step(float p, float g, float lr,
                                          float wd) {
  if (wd != 0.0f) g = __fadd_rn(g, __fmul_rn(wd, p));
  return __fadd_rn(p, -__fmul_rn(lr, g));
}

__global__ void __launch_bounds__(NTHREADS)
    sgd_multi_kernel(const __grid_constant__ SgdTable a) {
  __shared__ int s_t;
  __shared__ float s_lr;
  const int chunk = blockIdx.x;
  if (threadIdx.x == 0) {
    // the last tensor whose first chunk is at or before this one
    int lo = 0, hi = a.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.first_chunk[mid] <= chunk)
        lo = mid;
      else
        hi = mid - 1;
    }
    s_t = lo;
    s_lr = *a.lr;
  }
  __syncthreads();
  const int t = s_t;
  const float lr = s_lr, wd = a.wd;
  float* __restrict__ p = a.p[t];
  const float* __restrict__ g = a.g[t];
  const int64_t start =
      static_cast<int64_t>(chunk - a.first_chunk[t]) * SGD_CHUNK;
  const int64_t end = min(a.n[t], start + SGD_CHUNK);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p + start);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g + start);
  int64_t v0 = start, v1 = start;  // the float4 span [v0, v1)
  if (((pa ^ ga) & 15) == 0) {
    v0 = min(end, start + static_cast<int64_t>(((16 - (pa & 15)) & 15) >> 2));
    v1 = v0 + ((end - v0) & ~int64_t{3});
    float4* p4 = reinterpret_cast<float4*>(p + v0);
    const float4* g4 = reinterpret_cast<const float4*>(g + v0);
    const int nv = static_cast<int>((v1 - v0) >> 2);
#pragma unroll 4
    for (int j = threadIdx.x; j < nv; j += NTHREADS) {
      float4 x = p4[j];
      const float4 y = __ldg(g4 + j);
      x.x = sgd_step(x.x, y.x, lr, wd);
      x.y = sgd_step(x.y, y.y, lr, wd);
      x.z = sgd_step(x.z, y.z, lr, wd);
      x.w = sgd_step(x.w, y.w, lr, wd);
      p4[j] = x;
    }
  }
  // the scalar head [start, v0) and tail [v1, end)
  const int64_t head = v0 - start;
  for (int64_t i = threadIdx.x; i < head + (end - v1); i += NTHREADS) {
    const int64_t e = i < head ? start + i : v1 + (i - head);
    p[e] = sgd_step(p[e], g[e], lr, wd);
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + NTHREADS - 1) / NTHREADS;
  // enough blocks to fill 132 SMs many times over; the loop takes the rest
  if (blocks > 132 * 32) blocks = 132 * 32;
  return static_cast<int>(blocks);
}

}  // namespace

// p, m, v: float32 [n], updated in place; g: float32 [n]; lr_t: one
// float32 on the card. Returns the cudaError_t of the launch.
extern "C" int pt_fused_adam(void* p, const void* g, void* m, void* v,
                             const void* lr_t, int64_t n, float b1,
                             float one_minus_b1, float b2,
                             float one_minus_b2, float eps, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  adam_kernel<<<grid_for(n), NTHREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(lr_t), n, b1, one_minus_b1, b2,
      one_minus_b2, eps);
  return static_cast<int>(cudaGetLastError());
}

// count tensors: p[i] float32 [n[i]], updated in place, g[i] float32
// [n[i]]; lr: one float32 on the card; wd: weight decay (0 on the op
// path). Launches sgd_multi_kernel as few times as the table allows
// (once for up to SGD_MAX_TENSORS tensors) and writes the number of
// launches to *launches. Returns the cudaError_t of the first failed
// launch, or 0.
extern "C" int pt_fused_sgd_multi(void* const* p, const void* const* g,
                                  const int64_t* n, int count, const void* lr,
                                  float wd, void* stream, int* launches) {
  *launches = 0;
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i)
    if (n[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  thread_local SgdTable table;  // 28 KB: not on the caller's stack
  table.lr = static_cast<const float*>(lr);
  table.wd = wd;
  int i = 0;
  while (i < count) {
    int k = 0;
    int64_t chunks = 0;
    for (; i < count && k < SGD_MAX_TENSORS; ++i) {
      if (n[i] == 0) continue;
      const int64_t c = (n[i] + SGD_CHUNK - 1) / SGD_CHUNK;
      if (chunks + c > 0x7FFFFFFF) break;  // the grid's x limit
      table.p[k] = static_cast<float*>(p[i]);
      table.g[k] = static_cast<const float*>(g[i]);
      table.n[k] = n[i];
      table.first_chunk[k] = static_cast<int>(chunks);
      chunks += c;
      ++k;
    }
    if (k == 0) {
      if (i < count) return static_cast<int>(cudaErrorInvalidValue);
      break;
    }
    table.count = k;
    sgd_multi_kernel<<<static_cast<unsigned>(chunks), NTHREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(table);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}
