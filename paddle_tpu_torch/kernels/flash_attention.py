"""Flash attention: the wrappers of the CUDA kernels (forward; backward
dq and dk/dv) and their plain PyTorch versions.

Counterpart of paddle_tpu/kernels/flash_attention.py: _fa_kernel via
_fa_forward, and _fa_bwd_dq_kernel / _fa_bwd_dkv_kernel via
_fa_backward. The kernels are paddle_tpu_torch/csrc/flash_attention_fwd.cu
and flash_attention_bwd.cu, built at first use (kernels/registry.py). A
CUDA tensor always goes to the kernels; a CPU tensor goes to the plain
versions. The meta tensors of build-time shape inference take the plain
versions too, which read no value. Under
kernels.registry.plain_reference() CUDA tensors take the plain versions
as well.

Constants are the TPU kernels': a finite -1e30 for masked scores and the
running-max start (-inf would turn a fully masked row into NaN), and a
1e-30 floor under the softmax denominator. Causal masking is absolute
(col > row is masked) even when Sq != Sk.

Attention dropout is `dropout = (s0, s1, t)`: two uint32 seed words and
the keep threshold t in 1..255. A weight is kept when the position hash
of paddle_tpu's dropout_keep_mask is below t (dropout_keep_mask here is
the same mask, bit for bit); kept weights scale by 256/t, and the
softmax denominator sums the undropped weights. The mask depends on
position only, so the kernels and the plain versions drop the same
weights whatever their tiles.
"""
from __future__ import annotations

import ctypes

import torch

from . import registry

_NEG_INF = -1e30
_L_FLOOR = 1e-30
_KERNEL = "flash_attention_fwd"
_KERNEL_DQ = "flash_attention_bwd_dq"
_KERNEL_DKV = "flash_attention_bwd_dkv"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128
_M32 = 0xFFFFFFFF


def _dims(q, layout):
    """(B, H, S, D) of a q/k/v tensor in `layout`."""
    if layout == "bshd":
        B, S, H, D = q.shape
    else:
        B, H, S, D = q.shape
    return B, H, S, D


# ---------------------------------------------------------------------------
# attention-dropout mask
# ---------------------------------------------------------------------------

def _mul32(h, c):
    """(h * c) mod 2**32 for int64 tensors holding uint32 values, in
    16-bit halves so that no product leaves int64."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(h):
    """murmur3's finalizer on uint32 values carried in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_keep_mask(s0, s1, B, H, Sq, Sk, t, device="cpu"):
    """[B, H, Sq, Sk] bool keep mask: the JAX package's
    dropout_keep_mask(seed, ...) with seed = (s0, s1) as uint32 words,
    and the mask the CUDA kernels compute."""
    rows = torch.arange(Sq, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(Sk, dtype=torch.int64, device=device)[None, :]
    pos = (rows * Sk + cols) & _M32
    bh = torch.arange(B * H, dtype=torch.int64,
                      device=device).reshape(B, H, 1, 1)
    seed = (int(s0) & _M32) ^ _mix32((int(s1) & _M32)
                                     ^ _mul32(bh, 0x9E3779B1))
    return (_mix32(pos[None, None] ^ seed) & 255) < int(t)


def _check_dropout(dropout):
    if dropout is None:
        return None
    s0, s1, t = dropout
    if not 1 <= int(t) <= 255:
        raise ValueError(
            f"attention dropout: the kernels realize keep thresholds "
            f"1..255, got t={t} (t >= 256 is no dropout: pass None; "
            f"t <= 0 drops everything: emit zeros at the call site)")
    return int(s0) & _M32, int(s1) & _M32, int(t)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _scores(q, k, bias, scale, causal, bshd):
    """float32 scores [B, H, Sq, Sk] with bias and the causal mask."""
    s = torch.einsum("bqhd,bkhd->bhqk" if bshd else "bhqd,bhkd->bhqk",
                     q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        rows = torch.arange(s.shape[-2], device=s.device)[:, None]
        cols = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = s.masked_fill(cols > rows, _NEG_INF)
    return s


def _keep(dropout, s):
    B, H, Sq, Sk = s.shape
    s0, s1, t = dropout
    return dropout_keep_mask(s0, s1, B, H, Sq, Sk, t, s.device)


def fused_attention_plain(q, k, v, bias, scale, causal, layout,
                          return_lse=False, dropout=None):
    """The forward kernel's function in plain PyTorch: scores in float32,
    the same masks and constants, the dropped weights rounded to v's
    dtype before p.v (as the kernel does for bf16), out in q's dtype;
    lse [B, H, Sq] float32 of the undropped weights."""
    dropout = _check_dropout(dropout)
    bshd = layout == "bshd"
    s = _scores(q, k, bias, scale, causal, bshd)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(_L_FLOOR)   # [B,H,Sq,1]
    if dropout is not None:
        t = dropout[2]
        p = torch.where(_keep(dropout, s), p * (256.0 / t),
                        torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd" if bshd else "bhqk,bhkd->bhqd",
                       p.to(v.dtype).float(), v.float())
    out = out / (l.transpose(1, 2) if bshd else l)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def _reduce_bias_grad(ds, bias):
    """Sum the per-element bias gradient over bias's broadcast dims."""
    dims = [i for i in range(3) if bias.shape[i] == 1 and ds.shape[i] != 1]
    if dims:
        ds = ds.sum(dim=dims, keepdim=True)
    return ds.to(bias.dtype)


def fused_attention_backward_plain(q, k, v, bias, out, lse, dout, scale,
                                   causal, layout, dropout=None,
                                   want_dbias=False):
    """The backward kernels' function in plain PyTorch, from the
    forward's out and lse [B, H, Sq]: returns (dq, dk, dv, dbias), the
    gradients in q/k/v's dtypes, dbias (bias's dtype) only with
    want_dbias and a bias."""
    dropout = _check_dropout(dropout)
    bshd = layout == "bshd"
    p = torch.exp(_scores(q, k, bias, scale, causal, bshd)
                  - lse.float()[..., None])
    do = dout.float()
    di = (do * out.float()).sum(-1)                 # [B,S,H] or [B,H,S]
    if bshd:
        di = di.transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk" if bshd else "bhqd,bhkd->bhqk",
                      do, v.float())
    p_v = p
    if dropout is not None:
        keep = _keep(dropout, p)
        c = 256.0 / dropout[2]
        zero = torch.zeros_like(p)
        dp = torch.where(keep, dp * c, zero)
        p_v = torch.where(keep, p * c, zero)
    ds = p * (dp - di[..., None])
    eo = "bhqk,bqhd->bkhd" if bshd else "bhqk,bhqd->bhkd"
    dv = torch.einsum(eo, p_v.to(v.dtype).float(), do)
    dk = torch.einsum(eo, ds.to(q.dtype).float(), q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd" if bshd else "bhqk,bhkd->bhqd",
                      ds.to(k.dtype).float(), k.float()) * scale
    dbias = _reduce_bias_grad(ds, bias) \
        if want_dbias and bias is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _route(q):
    dev = q.device.type
    if dev == "cuda" and not registry.plain_forced():
        return "kernel"
    if dev in ("cpu", "meta", "cuda"):
        return "plain"
    raise ValueError(f"fused attention: unsupported device {q.device}")


def fused_attention_forward(q, k, v, bias, scale, causal, layout,
                            return_lse=False, dropout=None):
    """Attention forward on q/k/v [B, S, H, D] (layout "bshd") or
    [B, H, S, D] ("bhsd"), with an optional additive bias
    [B|1, 1|H, 1|Sq, Sk] and optional attention dropout (s0, s1, t).
    Returns out (q's layout and dtype) and, with return_lse, lse
    [B, H, Sq] float32."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown attention layout {layout!r}")
    if _route(q) == "kernel":
        return _launch(q, k, v, bias, scale, causal, layout, return_lse,
                       dropout)
    return fused_attention_plain(q, k, v, bias, scale, causal, layout,
                                 return_lse, dropout)


def fused_attention_backward(q, k, v, bias, out, lse, dout, scale, causal,
                             layout, dropout=None, want_dbias=False):
    """Gradients of fused_attention_forward from its out and lse:
    (dq, dk, dv, dbias). On the card: the dq kernel (with its di
    pre-pass), then the dk/dv kernel."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown attention layout {layout!r}")
    if _route(q) == "kernel":
        return _launch_bwd(q, k, v, bias, out, lse, dout, scale, causal,
                           layout, dropout, want_dbias)
    return fused_attention_backward_plain(q, k, v, bias, out, lse, dout,
                                          scale, causal, layout, dropout,
                                          want_dbias)


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


def _bias_strides(bias):
    if bias is None:
        return (0, 0, 0)
    return tuple(0 if bias.shape[i] == 1 else bias.stride(i)
                 for i in range(3))


def _bind(lib):
    fn = lib.pt_flash_attention_fwd
    if fn.argtypes is None:
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i,
                       u, u, i, p]
        fn.restype = i
    return fn


def _launch(q, k, v, bias, scale, causal, layout, return_lse, dropout):
    B, H, Sq, Sk, D = _check(q, k, v, bias, layout)
    s0, s1, t = _check_dropout(dropout) or (0, 0, 0)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    strides = (ctypes.c_int64 * 15)(
        *_seq_strides(q, layout), *_seq_strides(k, layout),
        *_seq_strides(v, layout), *_seq_strides(out, layout),
        *_bias_strides(bias))
    fn = _bind(registry.library(_KERNEL))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(),
                 _DTYPES[q.dtype], B, H, Sq, Sk, D, strides, float(scale),
                 int(bool(causal)), s0, s1, t,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{_KERNEL} launch failed with CUDA error "
                           f"{err}")
    registry.count(_KERNEL)
    return (out, lse) if return_lse else out


def _bind_bwd(lib, symbol):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
        fn.argtypes = [p] * 12 + [i] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i, u, u, i, p]
        fn.restype = i
    return fn


def _launch_bwd(q, k, v, bias, out, lse, dout, scale, causal, layout,
                dropout, want_dbias):
    B, H, Sq, Sk, D = _check(q, k, v, bias, layout)
    s0, s1, t = _check_dropout(dropout) or (0, 0, 0)
    dout = dout.to(q.dtype).contiguous()
    if out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"fused attention backward: out "
                         f"{tuple(out.shape)} {out.dtype} must be like q")
    out = out.contiguous()
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"fused attention backward: lse must be float32 "
                         f"[{B}, {H}, {Sq}], got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    want_dbias = bool(want_dbias) and bias is not None
    ds = torch.zeros((B, H, Sq, Sk), dtype=torch.float32,
                     device=q.device) if want_dbias else None
    strides = (ctypes.c_int64 * 27)(
        *(st for x in (q, k, v, out, dout, dq, dk, dv)
          for st in _seq_strides(x, layout)), *_bias_strides(bias))
    lib = registry.library(_KERNEL_DQ)
    ptr = (lambda x: None if x is None else x.data_ptr())
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), ptr(bias), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(ds),
            _DTYPES[q.dtype], B, H, Sq, Sk, D, strides, float(scale),
            int(bool(causal)), s0, s1, t)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for name, symbol in ((_KERNEL_DQ, "pt_flash_attention_bwd_dq"),
                             (_KERNEL_DKV, "pt_flash_attention_bwd_dkv")):
            err = _bind_bwd(lib, symbol)(*args, stream)
            if err != 0:
                raise RuntimeError(f"{name} launch failed with CUDA error "
                                   f"{err}")
            registry.count(name)
    dbias = _reduce_bias_grad(ds, bias) if want_dbias else None
    return dq, dk, dv, dbias
