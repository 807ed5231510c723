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
// bandwidth, 12 bytes per element. Same design as Adam: a grid-stride
// loop, no shared memory, each operation rounded on its own so that
// lr*g is never contracted into an FMA with the subtraction.

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

__global__ void __launch_bounds__(NTHREADS)
    sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
               const float* __restrict__ lr_ptr, int64_t n, float wd) {
  const float lr = *lr_ptr;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float gi = g[i];
    const float pi = p[i];
    if (wd != 0.0f) gi = __fadd_rn(gi, __fmul_rn(wd, pi));
    p[i] = __fadd_rn(pi, -__fmul_rn(lr, gi));
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

// p: float32 [n], updated in place; g: float32 [n]; lr: one float32 on
// the card; wd: weight decay (0 on the op path). Returns the cudaError_t
// of the launch.
extern "C" int pt_fused_sgd(void* p, const void* g, const void* lr,
                            int64_t n, float wd, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  sgd_kernel<<<grid_for(n), NTHREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(lr), n, wd);
  return static_cast<int>(cudaGetLastError());
}
