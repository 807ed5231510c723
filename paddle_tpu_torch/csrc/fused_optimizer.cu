// Adam and SGD updates for Hopper (sm_90a), plain C interface.
//
// Adam replaces: paddle_tpu/kernels/fused_optimizer.py _adam_block (line
// 108), reached through fused_adam (line 202) and its pl.pallas_call. Same
// function as the JAX lowered adam (paddle_tpu/ops/optimizer_ops.py),
// with the JAX kernel's weight-decay term (0 on the op path):
//   lr_t = lr*sqrt(1-b2p)/(1-b1p)      (b1p, b2p: the tensor's beta powers)
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   p' = p - ((lr_t*m') / (sqrt(v') + eps) + (lr_t*wd)*p)
//   Beta1PowOut = b1p*b1, Beta2PowOut = b2p*b2
// on float32 tensors of any length, p, m and v written in place. lr, b1p
// and b2p are read from device pointers, so no value crosses to the host.
//
// What bounds it on this card: 4 loads and 3 stores of 4 bytes per
// element against about 10 floating-point operations: 28 bytes per
// element, far below the ridge point. It is bound by HBM bandwidth (the
// 99 parameters the registry routes in Transformer-base, 93.2M elements:
// 2.61 GB, 0.78 ms at 3.35 TB/s). Host launches matter as much: one
// launch a parameter, each behind the scalar launches that computed its
// lr_t and beta powers, made a training step's update ~800 launches.
//
// What the design does about that: SGD's multi-tensor design below. One
// launch updates a whole list (the engine hands it every adam op of a
// step that shares a rate and betas; a single parameter is a list of
// one). The table of (p, g, m, v, b1p, b2p, n) and each tensor's first
// chunk travels by value as the kernel's parameter (512 tensors a
// launch; a longer list takes more launches). Each block updates a
// chunk of ADAM_CHUNK elements: it finds its tensor by binary search
// over the first chunks and computes the tensor's lr_t itself; the
// tensor's first block writes the new beta powers into a fresh [T, 2]
// buffer (never over b1p and b2p, which the tensor's other blocks still
// read). Where p, g, m and v share their offset from a 16-byte boundary
// the chunk moves as float4 loads and stores between a scalar head and
// tail; else element by element. Each operation is rounded on its own
// (__fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn keep nvcc from
// contracting them into fused multiply-adds), so the kernel gives the
// plain PyTorch version's results bit for bit.
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
//
// The bucket sweep replaces: paddle_tpu/kernels/fused_optimizer.py
// bucket_sweep (line 238), which drives the same bodies (_adam_block :108,
// _sgd_block :133, through _call :147 and its pl.pallas_call :153) over a
// comm-scheduler bucket's flat view, with two modes the list kernels lack:
// the stability guard's gate _gate (:95),
//   gated = nonfinite ? old : (spike ? old + (new - old)*damp : new)
// applied to p', m' and v' alike, and the ZeRO-1 row window _row_mask
// (:101) over _bounds (:182): the view counts rows of 128 lanes, and only
// the elements of rows [lo, hi) are updated; the rest are written back
// unchanged. The hyper table (lr_t, nonfinite, spike, damp: four float32)
// and the window (lo, hi: two int64) are read from device memory, so a
// CUDA graph that captured a sweep reads them anew at every replay.
// Unlike the list kernels it writes p', m' and v' to fresh buffers, as
// the reference returns new arrays.
//
// What bounds it: as the list kernels, HBM bandwidth (Adam 28 bytes per
// element, SGD 12). What the design does about that: one launch a bucket,
// a grid-stride loop of float4 loads and stores where every pointer is
// 16-byte aligned (a window's edges are multiples of 128 elements, so no
// float4 straddles one), else element by element; the gate and the window
// are selects on values already in registers, so they add no access.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

// elements a block updates
constexpr int ADAM_CHUNK = 4096;
// tensors a launch takes: the table below stays under the 32 764 bytes a
// kernel's parameters may hold
constexpr int ADAM_MAX_TENSORS = 512;

struct AdamTable {
  const float* lr;
  float* pow_out;  // [count, 2]: b1p*b1, b2p*b2 of each tensor
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int count;
  float* p[ADAM_MAX_TENSORS];
  const float* g[ADAM_MAX_TENSORS];
  float* m[ADAM_MAX_TENSORS];
  float* v[ADAM_MAX_TENSORS];
  const float* b1p[ADAM_MAX_TENSORS];
  const float* b2p[ADAM_MAX_TENSORS];
  int64_t n[ADAM_MAX_TENSORS];
  int first_chunk[ADAM_MAX_TENSORS];  // ascending; tensor t's first block
};
static_assert(sizeof(AdamTable) <= 32764, "kernel parameters too large");

struct AdamHyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd, lr_t, lr_wd;
};

__device__ __forceinline__ void adam_step(float& p, float g, float& m,
                                          float& v, const AdamHyper& h) {
  const float mi =
      __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  const float vi = __fadd_rn(__fmul_rn(h.b2, v),
                             __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  float upd =
      __fdiv_rn(__fmul_rn(h.lr_t, mi), __fadd_rn(__fsqrt_rn(vi), h.eps));
  if (h.wd != 0.0f) upd = __fadd_rn(upd, __fmul_rn(h.lr_wd, p));
  p = __fsub_rn(p, upd);
  m = mi;
  v = vi;
}

__global__ void __launch_bounds__(NTHREADS)
    adam_multi_kernel(const __grid_constant__ AdamTable a) {
  __shared__ int s_t;
  __shared__ float s_lr_t;
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
    const float b1p = *a.b1p[lo], b2p = *a.b2p[lo];
    s_t = lo;
    s_lr_t = __fdiv_rn(__fmul_rn(*a.lr, __fsqrt_rn(__fsub_rn(1.0f, b2p))),
                       __fsub_rn(1.0f, b1p));
    if (chunk == a.first_chunk[lo]) {
      a.pow_out[2 * lo] = __fmul_rn(b1p, a.b1);
      a.pow_out[2 * lo + 1] = __fmul_rn(b2p, a.b2);
    }
  }
  __syncthreads();
  const int t = s_t;
  AdamHyper h;
  h.b1 = a.b1;
  h.one_minus_b1 = a.one_minus_b1;
  h.b2 = a.b2;
  h.one_minus_b2 = a.one_minus_b2;
  h.eps = a.eps;
  h.wd = a.wd;
  h.lr_t = s_lr_t;
  h.lr_wd = __fmul_rn(h.lr_t, a.wd);
  float* __restrict__ p = a.p[t];
  const float* __restrict__ g = a.g[t];
  float* __restrict__ m = a.m[t];
  float* __restrict__ v = a.v[t];
  const int64_t start =
      static_cast<int64_t>(chunk - a.first_chunk[t]) * ADAM_CHUNK;
  const int64_t end = min(a.n[t], start + ADAM_CHUNK);
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p + start);
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g + start);
  const uintptr_t ma = reinterpret_cast<uintptr_t>(m + start);
  const uintptr_t va = reinterpret_cast<uintptr_t>(v + start);
  int64_t v0 = start, v1 = start;  // the float4 span [v0, v1)
  if ((((pa ^ ga) | (pa ^ ma) | (pa ^ va)) & 15) == 0 && start < end) {
    v0 = min(end, start + static_cast<int64_t>(((16 - (pa & 15)) & 15) >> 2));
    v1 = v0 + ((end - v0) & ~int64_t{3});
    float4* p4 = reinterpret_cast<float4*>(p + v0);
    const float4* g4 = reinterpret_cast<const float4*>(g + v0);
    float4* m4 = reinterpret_cast<float4*>(m + v0);
    float4* v4 = reinterpret_cast<float4*>(v + v0);
    const int nv = static_cast<int>((v1 - v0) >> 2);
#pragma unroll 4
    for (int j = threadIdx.x; j < nv; j += NTHREADS) {
      float4 x = p4[j], mm = m4[j], vv = v4[j];
      const float4 y = __ldg(g4 + j);
      adam_step(x.x, y.x, mm.x, vv.x, h);
      adam_step(x.y, y.y, mm.y, vv.y, h);
      adam_step(x.z, y.z, mm.z, vv.z, h);
      adam_step(x.w, y.w, mm.w, vv.w, h);
      p4[j] = x;
      m4[j] = mm;
      v4[j] = vv;
    }
  }
  // the scalar head [start, v0) and tail [v1, end)
  const int64_t head = v0 - start;
  for (int64_t i = threadIdx.x; i < head + (end - v1); i += NTHREADS) {
    const int64_t e = i < head ? start + i : v1 + (i - head);
    float pe = p[e], me = m[e], ve = v[e];
    adam_step(pe, g[e], me, ve, h);
    p[e] = pe;
    m[e] = me;
    v[e] = ve;
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

// ---------------------------------------------------------------------------
// bucket sweep (ZeRO-1 row window, guard gate)
// ---------------------------------------------------------------------------

constexpr int SWEEP_LANES = 128;     // a row of the reference's view
constexpr int SWEEP_MAX_BLOCKS = 132 * 16;

struct SweepHyper {
  float lr, damp;
  bool nonfinite, spike;
  int64_t lo, hi;  // the window, in elements
};

__device__ __forceinline__ SweepHyper load_sweep(const float* hyper,
                                                 const int64_t* bounds) {
  SweepHyper s;
  s.lr = hyper[0];
  s.nonfinite = hyper[1] > 0.0f;
  s.spike = hyper[2] > 0.0f;
  s.damp = hyper[3];
  s.lo = bounds[0] * SWEEP_LANES;
  s.hi = bounds[1] * SWEEP_LANES;
  return s;
}

// stability/guard.py _gate_value: old + (new - old)*damp on a spike,
// old on a nonfinite step
__device__ __forceinline__ float gate(float nw, float old, const SweepHyper& s) {
  const float damped = __fadd_rn(old, __fmul_rn(__fsub_rn(nw, old), s.damp));
  return s.nonfinite ? old : (s.spike ? damped : nw);
}

__device__ __forceinline__ void sweep_adam(float& p, float g, float& m,
                                           float& v, bool inside,
                                           const AdamHyper& h,
                                           const SweepHyper& s) {
  float pn = p, mn = m, vn = v;
  adam_step(pn, g, mn, vn, h);
  if (inside) {
    p = gate(pn, p, s);
    m = gate(mn, m, s);
    v = gate(vn, v, s);
  }
}

__global__ void __launch_bounds__(NTHREADS)
    bucket_sweep_adam_kernel(const float* __restrict__ hyper,
                             const int64_t* __restrict__ bounds,
                             const float* __restrict__ p,
                             const float* __restrict__ g,
                             const float* __restrict__ m,
                             const float* __restrict__ v,
                             float* __restrict__ po, float* __restrict__ mo,
                             float* __restrict__ vo, int64_t n, float b1,
                             float one_minus_b1, float b2,
                             float one_minus_b2, float eps, float wd,
                             int vec4) {
  const SweepHyper s = load_sweep(hyper, bounds);
  AdamHyper h;
  h.b1 = b1;
  h.one_minus_b1 = one_minus_b1;
  h.b2 = b2;
  h.one_minus_b2 = one_minus_b2;
  h.eps = eps;
  h.wd = wd;
  h.lr_t = s.lr;
  h.lr_wd = __fmul_rn(s.lr, wd);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NTHREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * NTHREADS +
                        threadIdx.x;
  if (vec4) {
    const int64_t nv = n >> 2;
    for (int64_t j = first; j < nv; j += stride) {
      const bool inside = 4 * j >= s.lo && 4 * j < s.hi;
      float4 x = reinterpret_cast<const float4*>(p)[j];
      float4 mm = reinterpret_cast<const float4*>(m)[j];
      float4 vv = reinterpret_cast<const float4*>(v)[j];
      const float4 y = __ldg(reinterpret_cast<const float4*>(g) + j);
      sweep_adam(x.x, y.x, mm.x, vv.x, inside, h, s);
      sweep_adam(x.y, y.y, mm.y, vv.y, inside, h, s);
      sweep_adam(x.z, y.z, mm.z, vv.z, inside, h, s);
      sweep_adam(x.w, y.w, mm.w, vv.w, inside, h, s);
      reinterpret_cast<float4*>(po)[j] = x;
      reinterpret_cast<float4*>(mo)[j] = mm;
      reinterpret_cast<float4*>(vo)[j] = vv;
    }
    return;
  }
  for (int64_t e = first; e < n; e += stride) {
    float pe = p[e], me = m[e], ve = v[e];
    sweep_adam(pe, g[e], me, ve, e >= s.lo && e < s.hi, h, s);
    po[e] = pe;
    mo[e] = me;
    vo[e] = ve;
  }
}

__device__ __forceinline__ float sweep_sgd(float p, float g, bool inside,
                                           float wd, const SweepHyper& s) {
  return inside ? gate(sgd_step(p, g, s.lr, wd), p, s) : p;
}

__global__ void __launch_bounds__(NTHREADS)
    bucket_sweep_sgd_kernel(const float* __restrict__ hyper,
                            const int64_t* __restrict__ bounds,
                            const float* __restrict__ p,
                            const float* __restrict__ g,
                            float* __restrict__ po, int64_t n, float wd,
                            int vec4) {
  const SweepHyper s = load_sweep(hyper, bounds);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NTHREADS;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * NTHREADS +
                        threadIdx.x;
  if (vec4) {
    const int64_t nv = n >> 2;
    for (int64_t j = first; j < nv; j += stride) {
      const bool inside = 4 * j >= s.lo && 4 * j < s.hi;
      float4 x = reinterpret_cast<const float4*>(p)[j];
      const float4 y = __ldg(reinterpret_cast<const float4*>(g) + j);
      x.x = sweep_sgd(x.x, y.x, inside, wd, s);
      x.y = sweep_sgd(x.y, y.y, inside, wd, s);
      x.z = sweep_sgd(x.z, y.z, inside, wd, s);
      x.w = sweep_sgd(x.w, y.w, inside, wd, s);
      reinterpret_cast<float4*>(po)[j] = x;
    }
    return;
  }
  for (int64_t e = first; e < n; e += stride)
    po[e] = sweep_sgd(p[e], g[e], e >= s.lo && e < s.hi, wd, s);
}

bool aligned16(const void* const* ptrs, int count) {
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15) return false;
  return true;
}

unsigned sweep_blocks(int64_t work) {
  const int64_t b = (work + NTHREADS - 1) / NTHREADS;
  return static_cast<unsigned>(b < 1 ? 1 : (b > SWEEP_MAX_BLOCKS ? SWEEP_MAX_BLOCKS : b));
}

}  // namespace

// count tensors: p[i], m[i], v[i] float32 [n[i]], updated in place; g[i]
// float32 [n[i]]; b1p[i], b2p[i]: one float32 each on the card, the
// tensor's beta powers; lr: one float32 on the card; pow_out: float32
// [count, 2], written with b1p[i]*b1 and b2p[i]*b2; wd: weight decay (0
// on the op path). Launches adam_multi_kernel as few times as the table
// allows (once for up to ADAM_MAX_TENSORS tensors) and writes the number
// of launches to *launches. Returns the cudaError_t of the first failed
// launch, or 0.
extern "C" int pt_fused_adam_multi(void* const* p, const void* const* g,
                                   void* const* m, void* const* v,
                                   const void* const* b1p,
                                   const void* const* b2p, const int64_t* n,
                                   int count, const void* lr, void* pow_out,
                                   float b1, float one_minus_b1, float b2,
                                   float one_minus_b2, float eps, float wd,
                                   void* stream, int* launches) {
  *launches = 0;
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i)
    if (n[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  thread_local AdamTable table;  // 30 KB: not on the caller's stack
  table.lr = static_cast<const float*>(lr);
  table.b1 = b1;
  table.one_minus_b1 = one_minus_b1;
  table.b2 = b2;
  table.one_minus_b2 = one_minus_b2;
  table.eps = eps;
  table.wd = wd;
  int i = 0;
  while (i < count) {
    // every tensor takes one chunk at least: an empty one still writes
    // its beta powers
    table.pow_out = static_cast<float*>(pow_out) + 2 * static_cast<int64_t>(i);
    int k = 0;
    int64_t chunks = 0;
    for (; i < count && k < ADAM_MAX_TENSORS; ++i, ++k) {
      const int64_t c = n[i] == 0 ? 1 : (n[i] + ADAM_CHUNK - 1) / ADAM_CHUNK;
      if (chunks + c > 0x7FFFFFFF) break;  // the grid's x limit
      table.p[k] = static_cast<float*>(p[i]);
      table.g[k] = static_cast<const float*>(g[i]);
      table.m[k] = static_cast<float*>(m[i]);
      table.v[k] = static_cast<float*>(v[i]);
      table.b1p[k] = static_cast<const float*>(b1p[i]);
      table.b2p[k] = static_cast<const float*>(b2p[i]);
      table.n[k] = n[i];
      table.first_chunk[k] = static_cast<int>(chunks);
      chunks += c;
    }
    if (k == 0) return static_cast<int>(cudaErrorInvalidValue);
    table.count = k;
    adam_multi_kernel<<<static_cast<unsigned>(chunks), NTHREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(table);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
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

// One Adam step over a bucket's flat view of n elements: p, g, m, v float32
// [n] in; po, mo, vo float32 [n] out (fresh buffers). hyper: float32 [4] on
// the card (lr_t, nonfinite, spike, damp); bounds: int64 [2] on the card,
// the window [lo, hi) in rows of 128 elements. One launch. Returns the
// cudaError_t of the launch, or 0.
extern "C" int pt_bucket_sweep_adam(const void* hyper, const void* bounds,
                                    const void* p, const void* g,
                                    const void* m, const void* v, void* po,
                                    void* mo, void* vo, int64_t n, float b1,
                                    float one_minus_b1, float b2,
                                    float one_minus_b2, float eps, float wd,
                                    void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {p, g, m, v, po, mo, vo};
  const int vec4 = (n % 4 == 0) && aligned16(ptrs, 7);
  bucket_sweep_adam_kernel<<<sweep_blocks(vec4 ? n / 4 : n), NTHREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hyper), static_cast<const int64_t*>(bounds),
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<float*>(po), static_cast<float*>(mo),
      static_cast<float*>(vo), n, b1, one_minus_b1, b2, one_minus_b2, eps, wd,
      vec4);
  return static_cast<int>(cudaGetLastError());
}

// One SGD step over a bucket's flat view: p, g float32 [n] in, po float32
// [n] out; hyper and bounds as for pt_bucket_sweep_adam (hyper[0] is lr).
extern "C" int pt_bucket_sweep_sgd(const void* hyper, const void* bounds,
                                   const void* p, const void* g, void* po,
                                   int64_t n, float wd, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {p, g, po};
  const int vec4 = (n % 4 == 0) && aligned16(ptrs, 3);
  bucket_sweep_sgd_kernel<<<sweep_blocks(vec4 ? n / 4 : n), NTHREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hyper), static_cast<const int64_t*>(bounds),
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<float*>(po), n, wd, vec4);
  return static_cast<int>(cudaGetLastError());
}
