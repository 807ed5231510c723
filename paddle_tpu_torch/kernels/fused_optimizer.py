"""Adam and SGD updates: the wrappers of the CUDA kernels, their plain
PyTorch versions and their registry entries.

Counterpart of paddle_tpu/kernels/fused_optimizer.py (_adam_block via
fused_adam, _sgd_block via fused_sgd; the bucket_sweep surface is not
ported). The kernels are in paddle_tpu_torch/csrc/fused_optimizer.cu:
one pass over the operands that writes the new values in place, any
length, with the rate (Adam's bias-corrected lr_t, SGD's lr) read from
a one-element float32 tensor on the card (no host sync). Adam takes one
parameter a launch; SGD a list of parameters a launch (fused_sgd_multi,
which the engine calls with every sgd op of a step that shares a rate;
fused_sgd is a list of one). A CUDA tensor always goes to the kernel; a
CPU or meta tensor goes to the plain version, and so does a CUDA tensor
under kernels.registry.plain_reference().

Both are registered as the JAX package registers them: ``fused_adam``
for the ``adam`` op and ``fused_sgd`` for ``sgd``, eligible for float32
operands of at least ``PT_KERNEL_MIN_NUMEL`` elements (default 65536).
The ops ask the registry (ops/optimizer_ops.py); a parameter it does not
route takes the plain update.

The arithmetic is the JAX lowered ops' (paddle_tpu/ops/optimizer_ops.py),
with their grouping:
    adam:  m' = b1*m + (1-b1)*g
           v' = b2*v + ((1-b2)*g)*g
           p' = p - (lr_t*m') / (sqrt(v') + eps)
    sgd:   p' = p - lr*(g + wd*p)        (wd = 0 on the op path)
The kernels round each operation separately (no fused multiply-add), so
they give the plain versions' float32 results bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import registry

__all__ = ["adam_plain", "fused_adam", "sgd_plain", "fused_sgd",
           "fused_sgd_multi"]


def adam_plain(p, g, m, v, lr_t, beta1, beta2, epsilon):
    """The Adam kernel's function in plain PyTorch: returns new
    (p', m', v')."""
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + epsilon)
    return p_new, m_new, v_new


def sgd_plain(p, g, lr, weight_decay=0.0):
    """The SGD kernel's function in plain PyTorch: returns a new p'."""
    if weight_decay:
        g = g + weight_decay * p
    return p - lr * g


def fused_adam(p, g, m, v, lr_t, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """One Adam step on one parameter. lr_t: a one-element float32 tensor
    on p's device. On the card p, m and v are updated in place and
    returned; elsewhere new tensors are returned."""
    if p.device.type == "cuda" and not registry.plain_forced():
        return _launch_adam(p, g, m, v, lr_t, beta1, beta2, epsilon)
    if p.device.type in ("cpu", "meta", "cuda"):
        return adam_plain(p, g, m, v, lr_t.reshape(()), beta1, beta2,
                          epsilon)
    raise ValueError(f"fused_adam: unsupported device {p.device}")


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
    if rate.device != p.device or rate.dtype != torch.float32 or \
            rate.numel() != 1:
        raise TypeError(f"{kernel}: the rate must be one float32 on the "
                        f"card")


def _bind(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _F, _N = ctypes.c_void_p, ctypes.c_float, ctypes.c_int64
_ADAM_ARGS = [_P, _P, _P, _P, _P, _N, _F, _F, _F, _F, _F, _P]
_SGD_ARGS = [_P, _P, _P, ctypes.c_int, _P, _F, _P,
             ctypes.POINTER(ctypes.c_int)]


def _finish(kernel, err):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {err}")
    registry.count_launch(kernel)


def _launch_adam(p, g, m, v, lr_t, beta1, beta2, epsilon):
    _check("fused_adam", lr_t, p=p, g=g, m=m, v=v)
    fn = _bind(registry.library("fused_adam"), "pt_fused_adam", _ADAM_ARGS)
    with torch.cuda.device(p.device):
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 lr_t.data_ptr(), p.numel(), beta1, 1.0 - beta1, beta2,
                 1.0 - beta2, epsilon,
                 torch.cuda.current_stream(p.device).cuda_stream)
    _finish("fused_adam", err)
    return p, m, v


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
# registry entries (paddle_tpu/kernels/fused_optimizer.py:294-310)
# ---------------------------------------------------------------------------

def _dense_f32(sig: registry.Signature) -> bool:
    return (all(dt == "float32" for dt in sig.dtypes)
            and sig.numel >= registry.min_numel())


registry.register_kernel(
    "fused_adam", op_types=("adam",), eligible=_dense_f32, run=fused_adam,
    doc="single-pass Adam update (m/v EMAs + bias-corrected step); dense "
        "f32, >= PT_KERNEL_MIN_NUMEL elements")

registry.register_kernel(
    "fused_sgd", op_types=("sgd",), eligible=_dense_f32, run=fused_sgd,
    run_many=fused_sgd_multi,
    doc="single-pass SGD update, one launch for a list of parameters; "
        "dense f32, >= PT_KERNEL_MIN_NUMEL elements")
