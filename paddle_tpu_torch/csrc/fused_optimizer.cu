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
// unchanged. Unlike the list kernels it writes p', m' and v' to fresh
// buffers, as the reference returns new arrays.
//
// What bounds it: HBM bandwidth, as the list kernels: Adam 28 bytes an
// element inside the window and 24 outside (no gradient read), SGD 12
// and 8 (Transformer-base's 10 buckets, 93.3M elements: 0.78 and 0.33 ms
// at 3.35 TB/s). Launches matter too, at one a bucket: the reference
// builds its hyper table (lr_t, nonfinite, spike, damp) and its window
// with scalar ops, which on the card are 12 (Adam) or 7 (SGD) kernels
// ahead of every sweep launch.
//
// What the design does about that. No work on the card but the sweep's
// launch: its scalars travel by value in the kernel's parameters
// (SweepArgs), each as a pointer to one value on the card where the
// caller passed a tensor (read at each launch, so a captured graph
// rereads it at each replay) or as the value itself (a graph constant);
// the kernel folds the bias correction lr*sqrt(1-b2p)/(1-b1p) in the
// adam op's order and finds its window [idx*per, idx*per + per) rows from
// the index and the rows a window holds. The body: one block of 256
// threads a chunk of 2048 elements; each thread issues all its streaming
// float4 loads before any arithmetic and writes with streaming stores.
// The window is decided once a chunk: a chunk outside it reads no
// gradient and is copied through, one inside compares nothing, and only
// a chunk that an edge cuts (edges are multiples of 128 elements, so no
// float4 straddles one) selects a float4 at a time; a nonfinite step is
// an empty window. The launches are stream-ordered (programmatic
// dependent launch: sweep_stream_order), so one launch of a sweep starts
// during the tail of the one before. A view off a 16-byte boundary, or
// of a length 4 does not divide, takes an element-by-element grid-stride
// kernel. (A design that fed shared memory from a ring of 1-D bulk
// copies, a persistent grid and a copy-issuing warp, ran 3-5 % slower on
// the H100 at these sizes: PERF.md.)
// Each operation is rounded on its own, as in the list kernels, so the
// sweep equals its plain version bit for bit.

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

constexpr int SWEEP_LANES = 128;    // a row of the reference's view
// elements a block updates: a multiple of 128, so a window edge (a
// multiple of 128) never cuts a float4
constexpr int SWEEP_CHUNK = 2048;
constexpr int SWEEP_ITERS = SWEEP_CHUNK / 4 / NTHREADS;  // float4s a thread
static_assert(SWEEP_CHUNK % (4 * NTHREADS) == 0 &&
                  SWEEP_CHUNK % SWEEP_LANES == 0,
              "a chunk is whole float4s of every thread and whole rows");
constexpr int SWEEP_ELEM_BLOCKS = 132 * 16;  // the element path's grid cap

// A scalar of the sweep: read from the card at each launch where `ptr` is
// set (the caller passed a tensor: a captured graph rereads it at each
// replay), else `value` (a number: a constant of the graph).
struct SweepScalar {
  const float* ptr;
  float value;
};
struct SweepIndex {
  const int64_t* ptr;
  int64_t value;
};

// The scalars as the wrapper packs them (kernels/fused_optimizer.py
// _SweepArgs mirrors this layout; pt_bucket_sweep_args_size checks it).
struct SweepArgs {
  SweepScalar lr, beta1_pow, beta2_pow, nonfinite, spike, damp;
  SweepIndex shard;  // the window's index
  int64_t per;       // rows of 128 a window holds
  int fold;          // 1: lr_t = lr*sqrt(1-b2p)/(1-b1p); 0: lr_t = lr
};

struct SweepParams {
  SweepArgs a;
  const float* in[4];  // p, g, m, v (sgd: p, g)
  float* out[3];       // p', m', v' (sgd: p')
  int64_t n;
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

struct SweepHyper {
  float lr, damp;
  bool spike;
  int64_t lo, hi;  // the window, in elements
};

__device__ __forceinline__ float sweep_read(const SweepScalar& s) {
  return s.ptr ? *s.ptr : s.value;
}

// The launch's scalars: the adam op's bias correction in its order
// (adam_multi_kernel's), and the window [idx*per, idx*per + per) rows. A
// nonfinite step returns every element unchanged (the gate's `old`): an
// empty window.
__device__ __forceinline__ SweepHyper load_sweep(const SweepArgs& a) {
  SweepHyper s;
  float lr = sweep_read(a.lr);
  if (a.fold) {
    const float b1p = sweep_read(a.beta1_pow);
    const float b2p = sweep_read(a.beta2_pow);
    lr = __fdiv_rn(__fmul_rn(lr, __fsqrt_rn(__fsub_rn(1.0f, b2p))),
                   __fsub_rn(1.0f, b1p));
  }
  s.lr = lr;
  s.spike = sweep_read(a.spike) > 0.0f;
  s.damp = sweep_read(a.damp);
  const int64_t idx = a.shard.ptr ? *a.shard.ptr : a.shard.value;
  const bool nonfinite = sweep_read(a.nonfinite) > 0.0f;
  s.lo = nonfinite ? 0 : idx * a.per * SWEEP_LANES;
  s.hi = nonfinite ? 0 : s.lo + a.per * SWEEP_LANES;
  return s;
}

__device__ __forceinline__ AdamHyper adam_hyper(const SweepParams& prm,
                                                const SweepHyper& s) {
  AdamHyper h;
  h.b1 = prm.b1;
  h.one_minus_b1 = prm.one_minus_b1;
  h.b2 = prm.b2;
  h.one_minus_b2 = prm.one_minus_b2;
  h.eps = prm.eps;
  h.wd = prm.wd;
  h.lr_t = s.lr;
  h.lr_wd = __fmul_rn(s.lr, prm.wd);
  return h;
}

// stability/guard.py _gate_value on a spike: old + (new - old)*damp
__device__ __forceinline__ float damped(float nw, float old, float damp) {
  return __fadd_rn(old, __fmul_rn(__fsub_rn(nw, old), damp));
}

// one element of the window
__device__ __forceinline__ void sweep_adam(float& p, float g, float& m,
                                           float& v, const AdamHyper& h,
                                           const SweepHyper& s) {
  float pn = p, mn = m, vn = v;
  adam_step(pn, g, mn, vn, h);
  p = s.spike ? damped(pn, p, s.damp) : pn;
  m = s.spike ? damped(mn, m, s.damp) : mn;
  v = s.spike ? damped(vn, v, s.damp) : vn;
}

__device__ __forceinline__ float sweep_sgd(float p, float g, float wd,
                                           const SweepHyper& s) {
  const float pn = sgd_step(p, g, s.lr, wd);
  return s.spike ? damped(pn, p, s.damp) : pn;
}

// Stream-ordered launches (programmatic dependent launch): each block
// lets the next launch on the stream start as soon as every block of this
// one has started, then waits until the launch before it has finished and
// its writes are visible, before it reads anything. Back to back, the
// sweep's launches overlap one's tail with the next one's start, and no
// read runs ahead of the work it depends on.
__device__ __forceinline__ void sweep_stream_order() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// One chunk of SWEEP_CHUNK elements a block: every thread issues all its
// streaming float4 loads (SWEEP_ITERS of each operand) before any
// arithmetic, then updates and stores them (streaming: every byte is
// touched once). A chunk outside the window loads no gradient and is
// copied through; one inside compares nothing; only a chunk that a window
// edge cuts compares a float4 at a time. NOPS: the operands (p, g, m, v:
// 4; p, g: 2).
template <int NOPS>
__device__ __forceinline__ void sweep_chunk(const SweepParams& prm) {
  sweep_stream_order();
  const SweepHyper s = load_sweep(prm.a);
  const int64_t start = static_cast<int64_t>(blockIdx.x) * SWEEP_CHUNK;
  const int64_t end = min(prm.n, start + SWEEP_CHUNK);
  const bool outside = end <= s.lo || start >= s.hi;
  const bool inside = start >= s.lo && end <= s.hi;
  const int len4 = static_cast<int>(end - start) >> 2;
  const float4* in[NOPS];
  for (int k = 0; k < NOPS; ++k)
    in[k] = reinterpret_cast<const float4*>(prm.in[k] + start);
  float4 x[SWEEP_ITERS], y[SWEEP_ITERS], mm[SWEEP_ITERS], vv[SWEEP_ITERS];
#pragma unroll
  for (int i = 0; i < SWEEP_ITERS; ++i) {
    const int j = threadIdx.x + i * NTHREADS;
    if (j < len4) {
      x[i] = __ldcs(in[0] + j);
      if constexpr (NOPS == 4) {
        mm[i] = __ldcs(in[2] + j);
        vv[i] = __ldcs(in[3] + j);
      }
      if (!outside) y[i] = __ldcs(in[1] + j);
    }
  }
  AdamHyper h;
  if constexpr (NOPS == 4) h = adam_hyper(prm, s);
#pragma unroll
  for (int i = 0; i < SWEEP_ITERS; ++i) {
    const int j = threadIdx.x + i * NTHREADS;
    if (j >= len4) break;
    const bool upd = !outside && (inside || (start + 4 * j >= s.lo &&
                                             start + 4 * j < s.hi));
    if constexpr (NOPS == 4) {
      if (upd) {
        sweep_adam(x[i].x, y[i].x, mm[i].x, vv[i].x, h, s);
        sweep_adam(x[i].y, y[i].y, mm[i].y, vv[i].y, h, s);
        sweep_adam(x[i].z, y[i].z, mm[i].z, vv[i].z, h, s);
        sweep_adam(x[i].w, y[i].w, mm[i].w, vv[i].w, h, s);
      }
      __stcs(reinterpret_cast<float4*>(prm.out[1] + start) + j, mm[i]);
      __stcs(reinterpret_cast<float4*>(prm.out[2] + start) + j, vv[i]);
    } else if (upd) {
      x[i].x = sweep_sgd(x[i].x, y[i].x, prm.wd, s);
      x[i].y = sweep_sgd(x[i].y, y[i].y, prm.wd, s);
      x[i].z = sweep_sgd(x[i].z, y[i].z, prm.wd, s);
      x[i].w = sweep_sgd(x[i].w, y[i].w, prm.wd, s);
    }
    __stcs(reinterpret_cast<float4*>(prm.out[0] + start) + j, x[i]);
  }
}

__global__ void __launch_bounds__(NTHREADS)
    bucket_sweep_adam_kernel(const __grid_constant__ SweepParams prm) {
  sweep_chunk<4>(prm);
}

__global__ void __launch_bounds__(NTHREADS)
    bucket_sweep_sgd_kernel(const __grid_constant__ SweepParams prm) {
  sweep_chunk<2>(prm);
}

// The element path: a view off a 16-byte boundary or of a length that 4
// does not divide, a grid-stride loop an element at a time.
__global__ void __launch_bounds__(NTHREADS)
    bucket_sweep_adam_elem_kernel(const __grid_constant__ SweepParams prm) {
  const SweepHyper s = load_sweep(prm.a);
  const AdamHyper h = adam_hyper(prm, s);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NTHREADS;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x;
       e < prm.n; e += stride) {
    float pe = prm.in[0][e], me = prm.in[2][e], ve = prm.in[3][e];
    if (e >= s.lo && e < s.hi) sweep_adam(pe, prm.in[1][e], me, ve, h, s);
    prm.out[0][e] = pe;
    prm.out[1][e] = me;
    prm.out[2][e] = ve;
  }
}

__global__ void __launch_bounds__(NTHREADS)
    bucket_sweep_sgd_elem_kernel(const __grid_constant__ SweepParams prm) {
  const SweepHyper s = load_sweep(prm.a);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * NTHREADS;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x;
       e < prm.n; e += stride) {
    const float pe = prm.in[0][e];
    prm.out[0][e] = e >= s.lo && e < s.hi
                        ? sweep_sgd(pe, prm.in[1][e], prm.wd, s)
                        : pe;
  }
}

// Launches one sweep: the chunked kernel where every pointer is 16-byte
// aligned and 4 divides n, else the element path.
template <int NOPS>
int launch_sweep(const SweepParams& prm, cudaStream_t stream) {
  if (prm.n < 0) return static_cast<int>(cudaErrorInvalidValue);
  bool vec4 = prm.n % 4 == 0;
  for (int i = 0; i < NOPS; ++i)
    vec4 = vec4 && (reinterpret_cast<uintptr_t>(prm.in[i]) & 15) == 0;
  for (int i = 0; i < NOPS - 1; ++i)
    vec4 = vec4 && (reinterpret_cast<uintptr_t>(prm.out[i]) & 15) == 0;
  if (!vec4) {
    const int64_t b = (prm.n + NTHREADS - 1) / NTHREADS;
    const unsigned grid = static_cast<unsigned>(
        b < 1 ? 1 : (b > SWEEP_ELEM_BLOCKS ? SWEEP_ELEM_BLOCKS : b));
    if constexpr (NOPS == 4)
      bucket_sweep_adam_elem_kernel<<<grid, NTHREADS, 0, stream>>>(prm);
    else
      bucket_sweep_sgd_elem_kernel<<<grid, NTHREADS, 0, stream>>>(prm);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t chunks = (prm.n + SWEEP_CHUNK - 1) / SWEEP_CHUNK;
  if (chunks > 0x7FFFFFFF)  // the grid's x limit
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(chunks < 1 ? 1 : chunks));
  cfg.blockDim = dim3(NTHREADS);
  cfg.stream = stream;
  cudaLaunchAttribute order;
  order.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  order.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &order;
  cfg.numAttrs = 1;
  if constexpr (NOPS == 4)
    return static_cast<int>(
        cudaLaunchKernelEx(&cfg, bucket_sweep_adam_kernel, prm));
  else
    return static_cast<int>(
        cudaLaunchKernelEx(&cfg, bucket_sweep_sgd_kernel, prm));
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

// The size of SweepArgs, for the wrapper's check of its ctypes mirror.
extern "C" int pt_bucket_sweep_args_size() {
  return static_cast<int>(sizeof(SweepArgs));
}

// One Adam step over a bucket's flat view of n elements: p, g, m, v float32
// [n] in; po, mo, vo float32 [n] out (fresh buffers). args: a SweepArgs
// (a C type of internal linkage, hence void*): the scalars (rate, beta
// powers, guard, window index), each a value or a pointer to one on the
// card, and the window's rows. One launch, no other work on
// the card. Returns the cudaError_t of the launch, or 0.
extern "C" int pt_bucket_sweep_adam(const void* args, const void* p,
                                    const void* g, const void* m,
                                    const void* v, void* po, void* mo,
                                    void* vo, int64_t n, float b1,
                                    float one_minus_b1, float b2,
                                    float one_minus_b2, float eps, float wd,
                                    void* stream) {
  SweepParams prm;
  prm.a = *static_cast<const SweepArgs*>(args);
  prm.in[0] = static_cast<const float*>(p);
  prm.in[1] = static_cast<const float*>(g);
  prm.in[2] = static_cast<const float*>(m);
  prm.in[3] = static_cast<const float*>(v);
  prm.out[0] = static_cast<float*>(po);
  prm.out[1] = static_cast<float*>(mo);
  prm.out[2] = static_cast<float*>(vo);
  prm.n = n;
  prm.b1 = b1;
  prm.one_minus_b1 = one_minus_b1;
  prm.b2 = b2;
  prm.one_minus_b2 = one_minus_b2;
  prm.eps = eps;
  prm.wd = wd;
  return launch_sweep<4>(prm, static_cast<cudaStream_t>(stream));
}

// One SGD step over a bucket's flat view: p, g float32 [n] in, po float32
// [n] out; args as for pt_bucket_sweep_adam (lr is the rate; fold 0).
extern "C" int pt_bucket_sweep_sgd(const void* args, const void* p,
                                   const void* g, void* po, int64_t n,
                                   float wd, void* stream) {
  SweepParams prm = {};
  prm.a = *static_cast<const SweepArgs*>(args);
  prm.in[0] = static_cast<const float*>(p);
  prm.in[1] = static_cast<const float*>(g);
  prm.out[0] = static_cast<float*>(po);
  prm.n = n;
  prm.wd = wd;
  return launch_sweep<2>(prm, static_cast<cudaStream_t>(stream));
}
