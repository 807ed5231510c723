"""Adam and SGD updates: the wrappers of the CUDA kernels, their plain
PyTorch versions and their registry entries.

Counterpart of paddle_tpu/kernels/fused_optimizer.py (_adam_block via
fused_adam, _sgd_block via fused_sgd, both through bucket_sweep). The kernels are in paddle_tpu_torch/csrc/fused_optimizer.cu:
one pass over the operands that writes the new values in place, any
length, a list of parameters a launch, with the rates read from
one-element float32 tensors on the card (no host sync). Adam's list
entry, fused_adam_multi, takes each tensor's beta powers and computes
its bias-corrected rate lr_t = lr*sqrt(1-b2p)/(1-b1p) and its new beta
powers in the kernel; fused_adam takes lr_t itself, as the JAX
fused_adam does, and is the list entry on a list of one (beta powers 0,
so that lr_t comes out as given). SGD's list entry is fused_sgd_multi;
fused_sgd is a list of one. The engine calls the list entries with every
adam (sgd) op of a step that shares a rate (and betas). A CUDA tensor
always goes to the kernel; a CPU or meta tensor goes to the plain
version, and so does a CUDA tensor under
kernels.registry.plain_reference().

Both are registered as the JAX package registers them: ``fused_adam``
for the ``adam`` op and ``fused_sgd`` for ``sgd``, eligible for float32
operands of at least ``PT_KERNEL_MIN_NUMEL`` elements (default 65536).
The ops ask the registry (ops/optimizer_ops.py); a parameter it does not
route takes the plain update.

The arithmetic is the JAX lowered ops' (paddle_tpu/ops/optimizer_ops.py),
with their grouping, and the JAX kernels' weight-decay terms (0 on the
op path):
    adam:  m' = b1*m + (1-b1)*g
           v' = b2*v + ((1-b2)*g)*g
           p' = p - ((lr_t*m') / (sqrt(v') + eps) + (lr_t*wd)*p)
    sgd:   p' = p - lr*(g + wd*p)
The kernels round each operation separately (no fused multiply-add), so
they give the plain versions' float32 results bit for bit.

bucket_sweep is the reference's bucket surface: one Adam or SGD step over
a comm-scheduler bucket's flat view (parallel/comm_scheduler.py), with
the stability guard's gate and a ZeRO-1 row window, on fresh output
buffers. On the card its kernels (bucket_sweep_adam, bucket_sweep_sgd)
are the only work: sweep_args packs the scalars (rate, beta powers,
guard, window index) into the kernel's parameters, a tensor as a pointer
the kernel reads at each launch (so a captured sweep rereads it at each
replay), a number as its value; the kernel folds the bias correction and
finds its window [idx*per, idx*per + per) rows of 128 lanes of the view
padded to 256-row blocks itself. The plain route builds the same
scalars as a hyper table (lr_t, nonfinite, spike, damp: sweep_hyper,
with sweep_lr_t's fold) and a window (sweep_bounds); bucket_sweep_plain
follows _adam_block / _sgd_block / _gate line for line.
"""
from __future__ import annotations

import ctypes

import torch

from . import registry

__all__ = ["adam_plain", "fused_adam", "fused_adam_multi", "sgd_plain",
           "fused_sgd", "fused_sgd_multi", "bucket_sweep",
           "bucket_sweep_plain", "sweep_hyper", "sweep_bounds",
           "sweep_lr_t", "sweep_args"]

_LANES = 128
_BLOCK_ROWS = 256


def adam_plain(p, g, m, v, lr_t, beta1, beta2, epsilon, weight_decay=0.0):
    """The Adam kernel's function in plain PyTorch: returns new
    (p', m', v')."""
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    upd = lr_t * m_new / (torch.sqrt(v_new) + epsilon)
    if weight_decay:
        upd = upd + (lr_t * weight_decay) * p
    return p - upd, m_new, v_new


def adam_multi_plain(ps, gs, ms, vs, lr, b1ps, b2ps, beta1, beta2,
                     epsilon, weight_decay=0.0):
    """The Adam list kernel's function in plain PyTorch, with the adam
    op's arithmetic for the rate and the beta powers: returns new lists
    (p', m', v', b1p*beta1, b2p*beta2)."""
    out = ([], [], [], [], [])
    lr = lr.reshape(())
    for p, g, m, v, b1p, b2p in zip(ps, gs, ms, vs, b1ps, b2ps):
        b1, b2 = b1p.reshape(()), b2p.reshape(())
        lr_t = lr * torch.sqrt(1 - b2) / (1 - b1)
        new = adam_plain(p, g, m, v, lr_t, beta1, beta2, epsilon,
                         weight_decay)
        new += ((b1 * beta1).reshape(b1p.shape),
                (b2 * beta2).reshape(b2p.shape))
        for lst, t in zip(out, new):
            lst.append(t)
    return out


def sgd_plain(p, g, lr, weight_decay=0.0):
    """The SGD kernel's function in plain PyTorch: returns a new p'."""
    if weight_decay:
        g = g + weight_decay * p
    return p - lr * g


def fused_adam(p, g, m, v, lr_t, beta1=0.9, beta2=0.999, epsilon=1e-8,
               weight_decay=0.0):
    """One Adam step on one parameter with the bias-corrected rate lr_t (a
    one-element float32 tensor on p's device): fused_adam_multi on a list
    of one whose beta powers are 0, so that its rate is lr_t itself
    (lr_t*sqrt(1-0)/(1-0) == lr_t). Returns (p', m', v'): on the card p,
    m and v, updated in place; elsewhere new tensors."""
    zero = torch.zeros(1, dtype=torch.float32, device=p.device)
    out = fused_adam_multi([p], [g], [m], [v], lr_t, [zero], [zero],
                           beta1, beta2, epsilon, weight_decay)
    return out[0][0], out[1][0], out[2][0]


def fused_adam_multi(ps, gs, ms, vs, lr, b1ps, b2ps, beta1=0.9,
                     beta2=0.999, epsilon=1e-8, weight_decay=0.0):
    """One Adam step on each parameter of a list, with one rate lr (a
    one-element float32 tensor on their device) and each parameter's
    beta powers b1ps[i], b2ps[i] (one float32 each there). Returns lists
    (p', m', v', Beta1PowOut, Beta2PowOut). On the card one launch
    updates every p, m and v in place (more launches only past 512
    tensors) and the beta powers come in a fresh buffer; elsewhere new
    tensors."""
    n = len(ps)
    if not all(len(x) == n for x in (gs, ms, vs, b1ps, b2ps)):
        raise ValueError(f"fused_adam: lists of {n} parameters, "
                         f"{len(gs)} gradients, {len(ms)} and {len(vs)} "
                         f"moments, {len(b1ps)} and {len(b2ps)} beta "
                         f"powers")
    if not ps:
        return [], [], [], [], []
    dev = ps[0].device
    if dev.type == "cuda" and not registry.plain_forced():
        return _launch_adam(ps, gs, ms, vs, lr, b1ps, b2ps, beta1, beta2,
                            epsilon, weight_decay)
    if dev.type in ("cpu", "meta", "cuda"):
        return adam_multi_plain(ps, gs, ms, vs, lr, b1ps, b2ps, beta1,
                                beta2, epsilon, weight_decay)
    raise ValueError(f"fused_adam: unsupported device {dev}")


def fused_sgd(p, g, lr, weight_decay=0.0):
    """One SGD step on one parameter: fused_sgd_multi on a list of one."""
    return fused_sgd_multi([p], [g], lr, weight_decay)[0]


def fused_sgd_multi(ps, gs, lr, weight_decay=0.0):
    """One SGD step on each parameter of a list, with one rate lr (a
    one-element float32 tensor on their device). On the card one launch
    updates every p in place (more launches only past 1024 tensors) and
    the list is returned; elsewhere a list of new tensors."""
    if len(ps) != len(gs):
        raise ValueError(f"fused_sgd: {len(ps)} parameters, {len(gs)} "
                         f"gradients")
    if not ps:
        return []
    dev = ps[0].device
    if dev.type == "cuda" and not registry.plain_forced():
        return _launch_sgd(ps, gs, lr, weight_decay)
    if dev.type in ("cpu", "meta", "cuda"):
        return [sgd_plain(p, g, lr.reshape(()), weight_decay)
                for p, g in zip(ps, gs)]
    raise ValueError(f"fused_sgd: unsupported device {dev}")


def _check(kernel, rate, **operands):
    """Every operand float32, contiguous, of p's shape on p's device; the
    rate one float32 there."""
    p = operands["p"]
    for name, t in operands.items():
        if t.device != p.device or t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {name} must be float32 on "
                            f"{p.device}, got {t.dtype} on {t.device}")
        if t.shape != p.shape or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} {tuple(t.shape)} must be "
                             f"contiguous with p's shape {tuple(p.shape)}")
    _check_scalar(kernel, "the rate", rate, p.device)


def _check_scalar(kernel, name, t, device):
    if t.device != device or t.dtype != torch.float32 or t.numel() != 1:
        raise TypeError(f"{kernel}: {name} must be one float32 on "
                        f"{device}, got {t.dtype} [{t.numel()}] on "
                        f"{t.device}")


def _bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _F, _N = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
_ADAM_ARGS = [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, _P, _F, _F, _F,
              _F, _F, _F, _P, ctypes.POINTER(ctypes.c_int)]
_SGD_ARGS = [_P, _P, _P, ctypes.c_int, _P, _F, _P,
             ctypes.POINTER(ctypes.c_int)]


def _launch_adam(ps, gs, ms, vs, lr, b1ps, b2ps, beta1, beta2, epsilon,
                 weight_decay):
    dev = ps[0].device
    for p, g, m, v, b1p, b2p in zip(ps, gs, ms, vs, b1ps, b2ps):
        if p.device != dev:
            raise ValueError(f"fused_adam: parameters on {dev} and "
                             f"{p.device}")
        _check("fused_adam", lr, p=p, g=g, m=m, v=v)
        _check_scalar("fused_adam", "Beta1Pow", b1p, dev)
        _check_scalar("fused_adam", "Beta2Pow", b2p, dev)
    fn = _bind(registry.library("fused_adam"), "pt_fused_adam_multi",
               _ADAM_ARGS)
    n = len(ps)
    pows = torch.empty((n, 2), dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)

    def ptrs(ts):
        return (_P * n)(*(t.data_ptr() for t in ts))
    with torch.cuda.device(dev):
        err = fn(ptrs(ps), ptrs(gs), ptrs(ms), ptrs(vs), ptrs(b1ps),
                 ptrs(b2ps), (_N * n)(*(p.numel() for p in ps)), n,
                 lr.data_ptr(), pows.data_ptr(), beta1, 1.0 - beta1, beta2,
                 1.0 - beta2, epsilon, weight_decay,
                 torch.cuda.current_stream(dev).cuda_stream,
                 ctypes.byref(launched))
    for _ in range(launched.value):
        registry.count_launch("fused_adam")
    if err != 0:
        raise RuntimeError(f"fused_adam launch failed with CUDA error {err}")
    # one view a tensor, in the shape of its input
    outs = []
    for col, ins in ((0, b1ps), (1, b2ps)):
        views = pows[:, col:col + 1].unbind(0)
        outs.append([v if v.shape == b.shape else v.reshape(b.shape)
                     for v, b in zip(views, ins)])
    return ps, ms, vs, outs[0], outs[1]


def _launch_sgd(ps, gs, lr, weight_decay):
    for p, g in zip(ps, gs):
        if p.device != ps[0].device:
            raise ValueError(f"fused_sgd: parameters on {ps[0].device} "
                             f"and {p.device}")
        _check("fused_sgd", lr, p=p, g=g)
    fn = _bind(registry.library("fused_sgd"), "pt_fused_sgd_multi",
               _SGD_ARGS)
    n = len(ps)
    launched = ctypes.c_int(0)
    dev = ps[0].device
    with torch.cuda.device(dev):
        err = fn((_P * n)(*(p.data_ptr() for p in ps)),
                 (_P * n)(*(g.data_ptr() for g in gs)),
                 (_N * n)(*(p.numel() for p in ps)), n, lr.data_ptr(),
                 weight_decay, torch.cuda.current_stream(dev).cuda_stream,
                 ctypes.byref(launched))
    for _ in range(launched.value):
        registry.count_launch("fused_sgd")
    if err != 0:
        raise RuntimeError(f"fused_sgd launch failed with CUDA error {err}")
    return ps


# ---------------------------------------------------------------------------
# the bucket surface (paddle_tpu/kernels/fused_optimizer.py:238-287)
# ---------------------------------------------------------------------------

def rows_padded(n: int) -> int:
    """Rows of 128 lanes of an n-element view, padded to whole blocks of
    256 rows (the reference's _rows_padded)."""
    rows = -(-n // _LANES)
    return -(-rows // _BLOCK_ROWS) * _BLOCK_ROWS


def _on(x, dtype, device):
    """x as a 0-d tensor of `dtype` on `device`: a tensor is converted
    there (a captured graph reads it), a number filled in (a constant)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def sweep_hyper(lr_t, guard, device) -> torch.Tensor:
    """The hyper table float32 [4]: (lr_t, nonfinite, spike, damp), zeros
    for the gate without a guard (the reference's _hyper)."""
    nf, sp, damp = (0.0, 0.0, 0.0) if guard is None else guard
    return torch.stack([_on(x, torch.float32, device)
                        for x in (lr_t, nf, sp, damp)])


def sweep_bounds(rows: int, shard, device) -> torch.Tensor:
    """The row window int64 [2]: [0, rows) without a shard, else shard
    (i, num)'s [i*rows/num, (i+1)*rows/num); i may be a tensor. A padded
    row count that num does not divide raises (the reference's
    _bounds)."""
    if shard is None:
        return torch.stack([_on(0, torch.int64, device),
                            _on(rows, torch.int64, device)])
    idx, num = shard
    per = _rows_per(rows, num)
    lo = _on(idx, torch.int64, device) * per
    return torch.stack([lo, lo + per])


def _rows_per(rows, num):
    if rows % num:
        raise ValueError(
            "bucket rows (%d) not divisible by num_shards (%d); pad "
            "the bucket to num_shards*128 elements" % (rows, num))
    return rows // num


def sweep_lr_t(lr, beta1_pow, beta2_pow, device) -> torch.Tensor:
    """The reference's bias-corrected rate lr*sqrt(1-b2p)/(1-b1p), float32
    on `device`, each operation rounded once in this order (the adam op's
    and the kernel's; the square root correctly rounded, _sqrt_rn)."""
    b1p = _on(beta1_pow, torch.float32, device)
    b2p = _on(beta2_pow, torch.float32, device)
    return _on(lr, torch.float32, device) * _sqrt_rn(1.0 - b2p) / \
        (1.0 - b1p)


class _Scalar(ctypes.Structure):
    """csrc/fused_optimizer.cu SweepScalar: a pointer to one float32 on
    the card (read at each launch), or null and the value."""
    _fields_ = [("ptr", ctypes.c_void_p), ("value", ctypes.c_float)]


class _Index(ctypes.Structure):
    """SweepIndex: the same for one int64."""
    _fields_ = [("ptr", ctypes.c_void_p), ("value", ctypes.c_int64)]


_SWEEP_SCALARS = ("lr", "beta1_pow", "beta2_pow", "nonfinite", "spike",
                  "damp")


class _SweepArgs(ctypes.Structure):
    """SweepArgs: the sweep kernels' scalars, the window's index and rows,
    and whether to fold the bias correction (pt_bucket_sweep_args_size
    holds the C side's size)."""
    _fields_ = [(name, _Scalar) for name in _SWEEP_SCALARS] + [
        ("shard", _Index), ("per", ctypes.c_int64), ("fold", ctypes.c_int)]


def sweep_args(n, lr, beta1_pow=None, beta2_pow=None, shard=None,
               guard=None, *, device):
    """The sweep kernels' scalars for an n-element view, packed for one
    launch: lr, beta1_pow, beta2_pow, the guard's (nonfinite, spike, damp)
    and the shard index each take a pointer slot where they are tensors
    and a value slot where they are numbers. A tensor of another dtype
    than float32 (int64 for the index) or on another device is converted
    onto `device` first: one kernel. The bias correction is folded (fold
    1) where both beta powers are given; the window holds rows_padded(n)
    / num rows, and a count that num does not divide raises ValueError.
    Returns (args, tensors): the converted tensors must outlive the
    launch's queuing."""
    idx, num = (0, 1) if shard is None else shard
    fold = beta1_pow is not None and beta2_pow is not None
    nf, sp, damp = (0.0, 0.0, 0.0) if guard is None else guard
    args = _SweepArgs(per=_rows_per(rows_padded(n), num), fold=int(fold))
    keep = []

    def put(slot, x, dtype, number):
        if isinstance(x, torch.Tensor):
            t = x.reshape(()).to(device=device, dtype=dtype)
            keep.append(t)
            slot.ptr = t.data_ptr()
        else:
            slot.value = number(x)

    values = (lr, beta1_pow if fold else 0.0, beta2_pow if fold else 0.0,
              nf, sp, damp)
    for name, x in zip(_SWEEP_SCALARS, values):
        put(getattr(args, name), x, torch.float32, float)
    put(args.shard, idx, torch.int64, int)
    return args, keep


def _gate(new, old, nf, sp, damp):
    """stability/guard.py _gate_value, elementwise (the reference's
    _gate)."""
    damped = old + (new - old) * damp
    return torch.where(nf, old, torch.where(sp, damped, new))


def _sqrt_rn(x):
    """The correctly rounded float32 square root (XLA's and the kernel's
    __fsqrt_rn): torch's float32 sqrt on the CPU is not, in about 0.7 %
    of normal inputs; float64's, rounded to float32, is."""
    return torch.sqrt(x.double()).to(x.dtype)


def bucket_sweep_plain(kind, hyper, bounds, p, g, m=None, v=None, *,
                       beta1=0.9, beta2=0.999, epsilon=1e-8,
                       weight_decay=0.0, gated=False):
    """The bucket kernels' function in plain PyTorch, _adam_block /
    _sgd_block over the flat view: returns p' (sgd) or (p', m', v')."""
    rows = torch.arange(p.shape[0], device=p.device) // _LANES
    inside = (rows >= bounds[0]) & (rows < bounds[1])
    lr_t = hyper[0]
    nf, sp, damp = hyper[1] > 0.0, hyper[2] > 0.0, hyper[3]
    if kind == "adam":
        m_new = beta1 * m + (1.0 - beta1) * g
        v_new = beta2 * v + (1.0 - beta2) * g * g
        upd = lr_t * m_new / (_sqrt_rn(v_new) + epsilon)
        if weight_decay:
            upd = upd + lr_t * weight_decay * p
        p_new = p - upd
        if gated:
            p_new = _gate(p_new, p, nf, sp, damp)
            m_new = _gate(m_new, m, nf, sp, damp)
            v_new = _gate(v_new, v, nf, sp, damp)
        return (torch.where(inside, p_new, p), torch.where(inside, m_new, m),
                torch.where(inside, v_new, v))
    if weight_decay:
        g = g + weight_decay * p
    p_new = p - lr_t * g
    if gated:
        p_new = _gate(p_new, p, nf, sp, damp)
    return torch.where(inside, p_new, p)


def bucket_sweep(kind, flat_param, flat_grad, flat_m=None, flat_v=None,
                 *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 beta1_pow=None, beta2_pow=None, weight_decay=0.0,
                 shard=None, guard=None):
    """One optimizer step over a bucket's flat view (the reference's
    bucket_sweep, same arguments and results).

    kind        "adam" | "sgd".
    flat_*      1-D float32 views in the comm scheduler's GradBucket
                order (param and grad, plus m and v for adam).
    lr          the rate, a number or a one-element tensor; for adam
                the bias correction lr*sqrt(1-b2p)/(1-b1p) is folded in
                float32 (on the card, by the kernel) when beta1_pow and
                beta2_pow are given.
    shard       optional (shard_index, num_shards), the index a number
                or a tensor: only rows [i*rows/num, (i+1)*rows/num) of
                the padded view are updated, the rest pass through.
    guard       optional (nonfinite, spike, damp), numbers or tensors:
                the gate of stability/guard.py _gate_value.

    Numbers are constants of a captured graph; tensors are read at each
    replay. Returns p' for sgd, (p', m', v') for adam, in new tensors.
    On the card one launch of the bucket kernel and no other work (a
    scalar tensor that is not float32, int64 for the index, or not on
    the card is converted first: one kernel); on the CPU (and under
    kernels.registry.plain_reference()) bucket_sweep_plain."""
    if kind not in ("adam", "sgd"):
        raise ValueError("bucket_sweep kind must be adam|sgd, got %r"
                         % (kind,))
    dev = flat_param.device
    n = flat_param.shape[0]
    if kind == "sgd" or beta1_pow is None or beta2_pow is None:
        beta1_pow = beta2_pow = None
    bufs = (flat_param, flat_grad) + \
        ((flat_m, flat_v) if kind == "adam" else ())
    if dev.type == "cuda" and not registry.plain_forced():
        # keep: the converted scalars, alive until the launch is queued
        args, keep = sweep_args(n, lr, beta1_pow, beta2_pow, shard, guard,
                                device=dev)
        return _launch_sweep(kind, args, bufs, beta1, beta2, epsilon,
                             weight_decay)
    if dev.type in ("cpu", "meta", "cuda"):
        lr_t = lr if beta1_pow is None else \
            sweep_lr_t(lr, beta1_pow, beta2_pow, dev)
        return bucket_sweep_plain(kind, sweep_hyper(lr_t, guard, dev),
                                  sweep_bounds(rows_padded(n), shard, dev),
                                  *bufs, beta1=beta1, beta2=beta2,
                                  epsilon=epsilon,
                                  weight_decay=weight_decay,
                                  gated=guard is not None)
    raise ValueError(f"bucket_sweep: unsupported device {dev}")


_SWEEP_ADAM_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _N, _F, _F, _F, _F, _F,
                    _F, _P]
_SWEEP_SGD_ARGS = [_P, _P, _P, _P, _N, _F, _P]


def _sweep_entry(name):
    """The C entry of a sweep kernel, bound once; its library's SweepArgs
    must have _SweepArgs's size."""
    lib = registry.library(name)
    kind = name[len("bucket_sweep_"):]
    fn = _bind(lib, "pt_bucket_sweep_" + kind, _SWEEP_ADAM_ARGS
               if kind == "adam" else _SWEEP_SGD_ARGS)
    if not getattr(fn, "checked", False):
        size = lib.pt_bucket_sweep_args_size()
        if size != ctypes.sizeof(_SweepArgs):
            raise RuntimeError(f"{name}: SweepArgs is {size} bytes in the "
                               f"library, {ctypes.sizeof(_SweepArgs)} in "
                               f"_SweepArgs")
        fn.checked = True
    return fn


def _launch_sweep(kind, args, bufs, beta1, beta2, epsilon, weight_decay):
    name = "bucket_sweep_" + kind
    p = bufs[0]
    for label, t in zip(("flat_param", "flat_grad", "flat_m", "flat_v"),
                        bufs):
        if t.device != p.device or t.dtype != torch.float32 or \
                t.ndim != 1 or t.shape != p.shape or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous 1-D "
                             f"float32 [{p.shape[0]}] on {p.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    outs = [torch.empty_like(p) for _ in range(3 if kind == "adam" else 1)]
    fn = _sweep_entry(name)
    dev = p.device
    ptrs = [t.data_ptr() for t in bufs + tuple(outs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "adam":
            err = fn(ctypes.byref(args), *ptrs, p.shape[0], beta1,
                     1.0 - beta1, beta2, 1.0 - beta2, epsilon,
                     weight_decay, stream)
        else:
            err = fn(ctypes.byref(args), *ptrs, p.shape[0], weight_decay,
                     stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    registry.count_launch(name)
    return tuple(outs) if kind == "adam" else outs[0]


# ---------------------------------------------------------------------------
# registry entries (paddle_tpu/kernels/fused_optimizer.py:294-310)
# ---------------------------------------------------------------------------

def _dense_f32(sig: registry.Signature) -> bool:
    return (all(dt == "float32" for dt in sig.dtypes)
            and sig.numel >= registry.min_numel())


registry.register_kernel(
    "fused_adam", op_types=("adam",), eligible=_dense_f32, run=fused_adam,
    run_many=fused_adam_multi,
    doc="single-pass Adam update (m/v EMAs + bias-corrected step), one "
        "launch for a list of parameters; dense f32, >= "
        "PT_KERNEL_MIN_NUMEL elements")

registry.register_kernel(
    "fused_sgd", op_types=("sgd",), eligible=_dense_f32, run=fused_sgd,
    run_many=fused_sgd_multi,
    doc="single-pass SGD update, one launch for a list of parameters; "
        "dense f32, >= PT_KERNEL_MIN_NUMEL elements")
