"""Adam update: the wrapper of the CUDA kernel and its plain PyTorch
version.

Counterpart of paddle_tpu/kernels/fused_optimizer.py (_adam_block via
fused_adam). The kernel is paddle_tpu_torch/csrc/fused_optimizer.cu: one
pass over p, g, m, v that writes p', m', v' in place, any length, with
the bias-corrected rate lr_t read from a one-element float32 tensor on
the card (no host sync). A CUDA tensor always goes to the kernel (one
launch per call); a CPU or meta tensor goes to adam_plain, and so does a
CUDA tensor under kernels.registry.plain_reference().

The arithmetic is the JAX lowered adam's (paddle_tpu/ops/optimizer_ops.py
adam), with its grouping:
    m' = b1*m + (1-b1)*g
    v' = b2*v + ((1-b2)*g)*g
    p' = p - (lr_t*m') / (sqrt(v') + eps)
The kernel rounds each operation separately (no fused multiply-add), so
it gives the plain version's float32 results bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import registry

_KERNEL = "fused_adam"


def adam_plain(p, g, m, v, lr_t, beta1, beta2, epsilon):
    """The kernel's function in plain PyTorch: returns new (p', m', v')."""
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + epsilon)
    return p_new, m_new, v_new


def fused_adam(p, g, m, v, lr_t, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """One Adam step on one parameter. lr_t: a one-element float32 tensor
    on p's device. On the card p, m and v are updated in place and
    returned; elsewhere new tensors are returned."""
    if p.device.type == "cuda" and not registry.plain_forced():
        return _launch(p, g, m, v, lr_t, beta1, beta2, epsilon)
    if p.device.type in ("cpu", "meta", "cuda"):
        return adam_plain(p, g, m, v, lr_t.reshape(()), beta1, beta2,
                          epsilon)
    raise ValueError(f"fused_adam: unsupported device {p.device}")


def _check(p, g, m, v, lr_t):
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device != p.device or t.dtype != torch.float32:
            raise TypeError(f"fused_adam: {name} must be float32 on "
                            f"{p.device}, got {t.dtype} on {t.device}")
        if t.shape != p.shape or not t.is_contiguous():
            raise ValueError(f"fused_adam: {name} {tuple(t.shape)} must be "
                             f"contiguous with p's shape {tuple(p.shape)}")
    if lr_t.device != p.device or lr_t.dtype != torch.float32 or \
            lr_t.numel() != 1:
        raise TypeError("fused_adam: lr_t must be one float32 on the card")


def _bind(lib):
    fn = lib.pt_fused_adam
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int64, ctypes.c_float,
                       ctypes.c_float, ctypes.c_float, ctypes.c_float,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(p, g, m, v, lr_t, beta1, beta2, epsilon):
    _check(p, g, m, v, lr_t)
    fn = _bind(registry.library(_KERNEL))
    with torch.cuda.device(p.device):
        err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 lr_t.data_ptr(), p.numel(), beta1, 1.0 - beta1, beta2,
                 1.0 - beta2, epsilon,
                 torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error {err}")
    registry.count_launch(_KERNEL)
    return p, m, v
