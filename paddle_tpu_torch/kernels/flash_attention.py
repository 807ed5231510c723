"""Flash-attention forward: the wrapper of the CUDA kernel and its plain
PyTorch version.

Counterpart of paddle_tpu/kernels/flash_attention.py (_fa_kernel via
_fa_forward). The kernel is paddle_tpu_torch/csrc/flash_attention_fwd.cu,
built at first use (kernels/registry.py). A CUDA tensor always goes to
the kernel; a CPU tensor goes to fused_attention_plain. The meta tensors
of build-time shape inference take the plain version too, which reads no
value. Under kernels.registry.plain_reference() CUDA tensors take the
plain version as well.

Constants are the TPU kernel's: a finite -1e30 for masked scores and the
running-max start (-inf would turn a fully masked row into NaN), and a
1e-30 floor under the softmax denominator. Causal masking is absolute
(col > row is masked) even when Sq != Sk.
"""
from __future__ import annotations

import ctypes

import torch

from . import registry

_NEG_INF = -1e30
_L_FLOOR = 1e-30
_KERNEL = "flash_attention_fwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128


def _dims(q, layout):
    """(B, H, S, D) of a q/k/v tensor in `layout`."""
    if layout == "bshd":
        B, S, H, D = q.shape
    else:
        B, H, S, D = q.shape
    return B, H, S, D


def fused_attention_plain(q, k, v, bias, scale, causal, layout,
                          return_lse=False):
    """The kernel's function in plain PyTorch: scores in float32, the
    same masks and constants, p rounded to v's dtype before p.v (as the
    kernel does for bf16), out in q's dtype; lse [B, H, Sq] float32."""
    bshd = layout == "bshd"
    s = torch.einsum("bqhd,bkhd->bhqk" if bshd else "bhqd,bhkd->bhqk",
                     q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        rows = torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = s.masked_fill(cols > rows, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(_L_FLOOR)   # [B,H,Sq,1]
    out = torch.einsum("bhqk,bkhd->bqhd" if bshd else "bhqk,bhkd->bhqd",
                       p.to(v.dtype).float(), v.float())
    out = out / (l.transpose(1, 2) if bshd else l)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def fused_attention_forward(q, k, v, bias, scale, causal, layout,
                            return_lse=False, dropout_prob=0.0):
    """Attention forward on q/k/v [B, S, H, D] (layout "bshd") or
    [B, H, S, D] ("bhsd"), with an optional additive bias
    [B|1, 1|H, 1|Sq, Sk]. Returns out (q's layout and dtype) and, with
    return_lse, lse [B, H, Sq] float32.

    Dropout on the attention weights is not in the kernel yet: a nonzero
    dropout_prob raises, on every device."""
    if dropout_prob:
        raise NotImplementedError(
            "attention dropout is not in the flash-attention kernel yet "
            "(it arrives with the training slice); run with is_test=True "
            "or dropout_prob=0")
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown attention layout {layout!r}")
    dev = q.device.type
    if dev == "cuda" and not registry.plain_forced():
        return _launch(q, k, v, bias, scale, causal, layout, return_lse)
    if dev in ("cpu", "meta", "cuda"):
        return fused_attention_plain(q, k, v, bias, scale, causal, layout,
                                     return_lse)
    raise ValueError(f"fused attention: unsupported device {q.device}")


def _seq_strides(x, layout):
    """Element strides of (batch, sequence, head)."""
    if layout == "bshd":
        return x.stride(0), x.stride(1), x.stride(2)
    return x.stride(0), x.stride(2), x.stride(1)


def _check(q, k, v, bias, layout):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"fused attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"fused attention: {name} is {t.dtype}, "
                            f"q is {q.dtype}")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"fused attention: {name} must be a "
                             f"contiguous 4-D tensor, got {tuple(t.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"fused attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    B, H, Sq, D = _dims(q, layout)
    Bk, Hk, Sk, Dk = _dims(k, layout)
    if (Bk, Hk, Dk) != (B, H, D) or k.shape != v.shape:
        raise ValueError(f"fused attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree "
                         f"({layout})")
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"fused attention kernel takes head dim 1..."
                         f"{_MAX_D}, got {D}")
    if min(B, H, Sq, Sk) < 1 or B > 65535 or H > 65535:
        raise ValueError(f"fused attention kernel: unsupported sizes "
                         f"B={B} H={H} Sq={Sq} Sk={Sk}")
    if bias is not None:
        if bias.device != q.device or bias.dtype != torch.float32:
            raise TypeError(f"fused attention: bias must be float32 on "
                            f"{q.device}, got {bias.dtype} on "
                            f"{bias.device}")
        ok = (bias.ndim == 4 and bias.shape[0] in (1, B)
              and bias.shape[1] in (1, H) and bias.shape[2] in (1, Sq)
              and bias.shape[3] == Sk and bias.stride(3) == 1)
        if not ok:
            raise ValueError(f"fused attention: bias {tuple(bias.shape)} "
                             f"does not broadcast to [{B}, {H}, {Sq}, "
                             f"{Sk}] with contiguous keys")
    return B, H, Sq, Sk, D


def _bind(lib):
    fn = lib.pt_flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i,
                       p]
        fn.restype = i
    return fn


def _launch(q, k, v, bias, scale, causal, layout, return_lse):
    B, H, Sq, Sk, D = _check(q, k, v, bias, layout)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    bias_strides = (0, 0, 0)
    if bias is not None:
        bias_strides = tuple(0 if bias.shape[i] == 1 else bias.stride(i)
                             for i in range(3))
    strides = (ctypes.c_int64 * 15)(
        *_seq_strides(q, layout), *_seq_strides(k, layout),
        *_seq_strides(v, layout), *_seq_strides(out, layout),
        *bias_strides)
    fn = _bind(registry.library(_KERNEL))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(),
                 _DTYPES[q.dtype], B, H, Sq, Sk, D, strides, float(scale),
                 int(bool(causal)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error "
                           f"{err}")
    registry.count(_KERNEL)
    return (out, lse) if return_lse else out
