"""Flash attention: the wrappers of the CUDA kernels (forward; backward
dq and dk/dv) and their plain PyTorch versions.

Counterpart of paddle_tpu/kernels/flash_attention.py: _fa_kernel via
_fa_forward, and _fa_bwd_dq_kernel / _fa_bwd_dkv_kernel via
_fa_backward, with its g_lse term (flash_attention_lse, an entry point
that returns (out, lse) and takes cotangents on both). The kernels are paddle_tpu_torch/csrc/flash_attention_fwd.cu
and flash_attention_bwd.cu (float32 FMA on CUDA cores, any dtype the
wrappers take, any head dim), the tensor-core designs for bf16,
flash_attention_fwd_sm90.cu, flash_attention_bwd_dq_sm90.cu (di fused
in) and flash_attention_bwd_dkv_sm90.cu (wgmma and TMA, head dims up to
128), and the float32 forward on the tensor cores,
flash_attention_fwd_f32_sm90.cu (3xTF32 wgmma, head dims up to 128),
all built at first use (kernels/registry.py). A call that meets TMA's
rules (_sm90_eligible) takes the tensor-core kernels: bf16 forward and
backward, float32 the forward (its backward stays on the CUDA cores);
every other call the CUDA-core ones. A CUDA tensor goes to the kernels
unless the kernel registry denies "flash_attention"
(FLAGS_use_custom_kernels=0, PT_KERNEL_DENY); a CPU tensor goes to the
plain versions (_route). The meta tensors of build-time shape inference
take the plain versions too, which read no value. Under
kernels.registry.plain_reference() CUDA tensors take the plain versions
as well.

Constants are the TPU kernels': a finite -1e30 for masked scores and the
running-max start (-inf would turn a fully masked row into NaN), and a
1e-30 floor under the softmax denominator. Causal masking is absolute
(col > row is masked) even when Sq != Sk.

Attention dropout is `dropout = (seed, t)`: the two uint32 seed words as
an int64 [2] tensor on q's device (ExecContext.seed_tensor) and the keep
threshold t in 1..255; `(s0, s1, t)` with the words as ints is taken too
and put on the device first. The kernels read the words from the device
tensor, never from the host (the counterpart of the JAX kernels'
seed_ref), so a CUDA graph that captured a call draws, at each replay,
the mask of the words written before it. A weight is kept when the
position hash of paddle_tpu's dropout_keep_mask is below t
(dropout_keep_mask here is the same mask, bit for bit); kept weights
scale by 256/t, and the softmax denominator sums the undropped weights.
The mask depends on position only, so the kernels and the plain versions
drop the same weights whatever their tiles.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.registry import seed_tensor
from . import registry

_NEG_INF = -1e30
_L_FLOOR = 1e-30
_KERNEL = "flash_attention_fwd"
_KERNEL_DQ = "flash_attention_bwd_dq"
_KERNEL_DKV = "flash_attention_bwd_dkv"
# the tensor-core designs; the counters above count every launch of
# their entry, these three the tensor-core launches alone
_KERNEL_SM90 = "flash_attention_fwd_sm90"
_KERNEL_DKV_SM90 = "flash_attention_bwd_dkv_sm90"
_KERNEL_DQ_SM90 = "flash_attention_bwd_dq_sm90"
# the float32 tensor-core forward; flash_attention_fwd counts it too
_KERNEL_F32_SM90 = "flash_attention_fwd_f32_sm90"
# the name the kernel registry's flag, deny list and dispatch stats use
_REGISTRY_NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels take: the CUDA-core kernels any D (chunks of 128
# columns above 128, groups of 256 output columns above 256); the
# tensor-core kernels rows of 16-byte multiples (bf16 D % 8 == 0,
# float32 D % 4 == 0) up to 128 (their accumulators at D > 128 would not
# fit in 255 registers a thread)
_MAX_D_SM90 = 128
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


def dropout_keep_mask(s0, s1, B, H, Sq, Sk, t, device=None):
    """[B, H, Sq, Sk] bool keep mask: the JAX package's
    dropout_keep_mask(seed, ...) with seed = (s0, s1) as uint32 words,
    and the mask the CUDA kernels compute. s0 and s1 are ints, or 0-d
    int64 tensors (the two elements of a device seed tensor: the mask is
    then computed on the device, with no host read). On `device`, or on
    the default place's (CUDAPlace(0), which raises where torch sees no
    card) when None."""
    if device is None:
        from ..core.place import default_place
        device = default_place().torch_device()
    rows = torch.arange(Sq, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(Sk, dtype=torch.int64, device=device)[None, :]
    pos = (rows * Sk + cols) & _M32
    bh = torch.arange(B * H, dtype=torch.int64,
                      device=device).reshape(B, H, 1, 1)
    if not isinstance(s0, torch.Tensor):
        s0, s1 = int(s0), int(s1)
    seed = (s0 & _M32) ^ _mix32((s1 & _M32) ^ _mul32(bh, 0x9E3779B1))
    return (_mix32(pos[None, None] ^ seed) & 255) < int(t)


def _check_dropout(dropout, device):
    """(seed, t) with seed an int64 [2] tensor on `device`, from either
    form of the dropout argument; None for none."""
    if dropout is None:
        return None
    if len(dropout) == 3:
        s0, s1, t = dropout
        seed = seed_tensor((s0, s1), device)
    else:
        seed, t = dropout
        if not isinstance(seed, torch.Tensor) or seed.dtype != \
                torch.int64 or tuple(seed.shape) != (2,) or \
                seed.device != torch.device(device):
            raise TypeError(
                f"attention dropout: the seed must be an int64 [2] tensor "
                f"on {device}, got {getattr(seed, 'dtype', type(seed))} "
                f"{tuple(getattr(seed, 'shape', ()))} on "
                f"{getattr(seed, 'device', None)}")
    if not 1 <= int(t) <= 255:
        raise ValueError(
            f"attention dropout: the kernels realize keep thresholds "
            f"1..255, got t={t} (t >= 256 is no dropout: pass None; "
            f"t <= 0 drops everything: emit zeros at the call site)")
    return seed.contiguous(), int(t)


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
    seed, t = dropout
    return dropout_keep_mask(seed[0], seed[1], B, H, Sq, Sk, t, s.device)


def fused_attention_plain(q, k, v, bias, scale, causal, layout,
                          return_lse=False, dropout=None):
    """The forward kernel's function in plain PyTorch: scores in float32,
    the same masks and constants, the dropped weights rounded to v's
    dtype before p.v (as the kernel does for bf16), out in q's dtype;
    lse [B, H, Sq] float32 of the undropped weights."""
    dropout = _check_dropout(dropout, q.device)
    bshd = layout == "bshd"
    s = _scores(q, k, bias, scale, causal, bshd)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(_L_FLOOR)   # [B,H,Sq,1]
    if dropout is not None:
        t = dropout[1]
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
                                   want_dbias=False, g_lse=None):
    """The backward kernels' function in plain PyTorch, from the
    forward's out and lse [B, H, Sq]: returns (dq, dk, dv, dbias), the
    gradients in q/k/v's dtypes, dbias (bias's dtype) only with
    want_dbias and a bias. g_lse, the cotangent of lse ([B, H, Sq]), is
    subtracted from di in float32: ds = p*(dp - (di - g_lse))."""
    dropout = _check_dropout(dropout, q.device)
    bshd = layout == "bshd"
    p = torch.exp(_scores(q, k, bias, scale, causal, bshd)
                  - lse.float()[..., None])
    do = dout.float()
    di = (do * out.float()).sum(-1)                 # [B,S,H] or [B,H,S]
    if bshd:
        di = di.transpose(1, 2)
    if g_lse is not None:
        di = di - g_lse.float()
    dp = torch.einsum("bqhd,bkhd->bhqk" if bshd else "bhqd,bhkd->bhqk",
                      do, v.float())
    p_v = p
    if dropout is not None:
        keep = _keep(dropout, p)
        c = 256.0 / dropout[1]
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


# bf16's unit roundoff (8 significant bits): |bf16(x) - x| <= 2^-8 |x|
_U_BF16 = 2.0 ** -8
# float32 arithmetic before the roundings: a float32 sum of n terms in any
# order is within n 2^-24 of the sum of their magnitudes, and 2^-12 is
# that for n = 4096 (head dims and key counts up to 4096)
_F32_SLACK = 2.0 ** -12


def bf16_backward_bound(q, k, v, bias, out, lse, dout, scale, causal,
                        layout, dropout=None, g_lse=None):
    """What a correct bf16 backward must meet: ((dq, dk, dv) exact, (dq,
    dk, dv) bound), float64 tensors in q/k/v's shapes.

    The exact gradients are taken in float64 from the same bf16 inputs,
    out and lse, with the float32 p of the plain version (in a row whose
    keys all carry a -1e9 bias, lse rounds to -1e9 and p is 1 on every
    key, as in the JAX kernels) and ds and p_drop unrounded. Derivation,
    for dq (dk the same with q for k and the sum over rows; dv with
    p_drop for ds, dO for k, and m = p_drop):

    1. A kernel computes ds_ij = p_ij (dp_ij - di_i) from float32 dot
       products over the head dim, dp_ij = dO_i . v_j (times the keep
       scale) and di_i = dO_i . O_i. Each is within D 2^-24 <= 2^-12 of
       the sum of its products' magnitudes, not of its value: where
       those cancel (row 0 of a causal head sees one key, so p = 1,
       exact ds = 0 and dp = di, which can be ~1e-4 against products
       summing to ~1e2 in magnitude) the rounding is all there is. So
           m_ij = p_ij (sum_d |dO_id| |v_jd| + sum_d |dO_id| |O_id|)
       with 2^-12 m_ij bounding the float32 error of ds_ij (p's own,
       from the scores and exp, relative and far below 2^-12 here, is
       bounded by the same term since |dp - di| <= m / p). The kernel
       rounds ds_ij to bf16, within 2^-8 |ds_ij|, so its float32 sum
       f = scale * sum_j bf16(ds_ij) k_jd is within
           s = scale * sum_j (2^-8 |ds_ij| + 2^-12 m_ij) |k_jd|
       of exact (the float32 sum over keys, Sk 2^-24 of the same
       magnitudes, is inside the 2^-12 term).
    2. The kernel then rounds f, not the exact value, to bf16:
       |bf16(f) - f| <= 2^-8 |f| <= 2^-8 (|exact| + s). So
           |dq - exact| <= s + 2^-8 (|exact| + s).
    3. With an lse cotangent g_lse (flash_attention_lse), ds_ij =
       p_ij (dp_ij - (di_i - g_lse_i)): the kernels subtract g_lse_i,
       read exactly in float32, from the float32 di_i once, and then
       di_i - g_lse_i from dp_ij. Each subtraction rounds within 2^-24
       of |dp_ij| + |di_i| + |g_lse_i|, so |g_lse_i| joins the
       magnitudes: m_ij = p_ij (sum_d |dO_id| |v_jd| + sum_d |dO_id|
       |O_id| + |g_lse_i|), and the exact ds takes the term. Where
       di - g_lse cancels the bound so still holds the float32 rounding
       of the three, which a bound without |g_lse_i| would not.
    4. Head dims above 128: the CUDA-core kernels run the scores and dp
       over 128-column chunks, each chunk's products added to the same
       float32 register, so a score is one float32 sum of D products in
       D's order, as below 128, and gets no term of its own; the
       gradients' columns are split into groups, not their sums.

    Where p = 1 on every key |ds| is in the tens, and this bound, not
    BF16_TOL, is what a correct kernel meets there."""
    dropout = _check_dropout(dropout, q.device)
    bshd = layout == "bshd"
    f64 = torch.float64
    p = torch.exp(_scores(q, k, bias, scale, causal, bshd)
                  - lse.float()[..., None]).to(f64)
    qd, kd, vd, od, gd = (x.to(f64) for x in (q, k, v, out, dout))
    if bshd:   # [B, H, S, D] from here on
        qd, kd, vd, od, gd = (x.transpose(1, 2) for x in
                              (qd, kd, vd, od, gd))
    di = (gd * od).sum(-1, keepdim=True)
    dp = gd @ vd.transpose(-1, -2)
    # the magnitudes of the two dot products' terms (step 1)
    adi = (gd.abs() * od.abs()).sum(-1, keepdim=True)
    if g_lse is not None:   # step 3
        gl = g_lse.to(f64)[..., None]
        di, adi = di - gl, adi + gl.abs()
    adp = gd.abs() @ vd.abs().transpose(-1, -2)
    p_v = p
    if dropout is not None:
        keep = _keep(dropout, p).to(f64) * (256.0 / dropout[1])
        dp, adp, p_v = dp * keep, adp * keep, p * keep
    ds = p * (dp - di)
    m = p * (adp + adi)
    w = _U_BF16 * ds.abs() + _F32_SLACK * m
    wv = (_U_BF16 + _F32_SLACK) * p_v
    exact = (scale * ds @ kd, scale * ds.transpose(-1, -2) @ qd,
             p_v.transpose(-1, -2) @ gd)
    slack = (scale * w @ kd.abs(), scale * w.transpose(-1, -2) @ qd.abs(),
             wv.transpose(-1, -2) @ gd.abs())
    bound = tuple(s + _U_BF16 * (e.abs() + s) for e, s in zip(exact, slack))
    if bshd:
        exact, bound = (tuple(x.transpose(1, 2) for x in t)
                        for t in (exact, bound))
    return exact, bound


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _route(q):
    """"kernel" or "plain", as the reference's use_kernel_path decides
    (paddle_tpu/kernels/flash_attention.py), and counted as the kernel
    registry counts its decisions, where routing is possible (a CUDA
    tensor, or a CPU tensor under registry._ROUTE_ON_CPU): under
    FLAGS_use_custom_kernels=0 or PT_KERNEL_DENY=flash_attention the
    plain (composed) version runs, counted `denied`; otherwise a CUDA
    tensor launches the kernels (`custom`), and a CPU tensor, or any
    tensor under plain_reference(), runs the plain version (`lowered`).
    Where routing is impossible (a CPU tensor without the hook, the meta
    tensors of shape inference) the plain version runs uncounted. The
    TPU's crossover (_KERNEL_MIN_SEQ_PRODUCT) was measured on a TPU and
    is not carried over."""
    dev = q.device.type
    if dev not in ("cpu", "cuda", "meta"):
        raise ValueError(f"fused attention: unsupported device {q.device}")
    if not registry._device_routes(q.device):
        return "plain"
    if not registry.allowed(_REGISTRY_NAME):
        registry.count(_REGISTRY_NAME, "denied")
        return "plain"
    if dev == "cuda" and not registry.plain_forced():
        registry.count(_REGISTRY_NAME, "custom")
        return "kernel"
    registry.count(_REGISTRY_NAME, "lowered")
    return "plain"


def fused_attention_forward(q, k, v, bias, scale, causal, layout,
                            return_lse=False, dropout=None):
    """Attention forward on q/k/v [B, S, H, D] (layout "bshd") or
    [B, H, S, D] ("bhsd"), with an optional additive bias
    [B|1, 1|H, 1|Sq, Sk] and optional attention dropout (seed, t) or
    (s0, s1, t).
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
                             layout, dropout=None, want_dbias=False,
                             g_lse=None):
    """Gradients of fused_attention_forward from its out and lse:
    (dq, dk, dv, dbias). On the card: the dq kernel (with di), then the
    dk/dv kernel. g_lse: the cotangent of lse, float32 [B, H, Sq], or
    None (zero)."""
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown attention layout {layout!r}")
    if _route(q) == "kernel":
        return _launch_bwd(q, k, v, bias, out, lse, dout, scale, causal,
                           layout, dropout, want_dbias, g_lse)
    return fused_attention_backward_plain(q, k, v, bias, out, lse, dout,
                                          scale, causal, layout, dropout,
                                          want_dbias, g_lse)


class _FlashLse(torch.autograd.Function):
    """(out, lse) of attention on [B, H, S, D] with cotangents on both."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out, lse = fused_attention_forward(q, k, v, bias, scale, False,
                                           "bhsd", return_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale = scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        dq, dk, dv, dbias = fused_attention_backward(
            q, k, v, bias, out, lse, g_out, ctx.scale, False, "bhsd",
            want_dbias=ctx.needs_input_grad[3], g_lse=g_lse)
        return dq, dk, dv, dbias, None


def flash_attention_lse(q, k, v, bias=None, scale=1.0, block_q=128,
                        block_k=128):
    """Attention on q, k, v [B, H, S, D] returning (out, lse): out in q's
    dtype, lse [B, H, Sq] float32, the block primitive of ring
    attention's online-softmax merge (the reference's
    flash_attention_lse). Differentiable through both outputs: the lse
    cotangent folds into di in the backward kernels' di pre-pass,
    ds = p*(dp - (di - g_lse)). Routed as fused attention is (_route):
    on the card the kernels (the tensor-core design where
    _sm90_eligible holds), on the CPU the plain versions. block_q and
    block_k are the TPU kernel's tiles, taken for the signature; the
    CUDA kernels tile on their own."""
    del block_q, block_k
    return _FlashLse.apply(q, k, v, bias, scale)


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
    if D < 1:
        raise ValueError(f"fused attention kernels take head dims from 1, "
                         f"got {D}")
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


def _sm90_eligible(q, k, v, out, layout):
    """Whether a call can take the tensor-core kernels: TMA's rules for
    the four [B, S, H, D] / [B, H, S, D] tensors it reads or writes
    (forward: q, k, v, out; backward: q, k, v, dout). All four bf16 (the
    forward and backward kernels) or all four float32 (the 3xTF32
    forward), rows of 16-byte multiples (D % 8 == 0 in bf16, D % 4 == 0 in
    float32) at most _MAX_D_SM90 wide, every base pointer 16-byte aligned,
    every (batch, sequence, head) stride a multiple of 16 bytes. A pure
    function of dtypes, shapes, pointers and strides."""
    ts = (q, k, v, out)
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != q.dtype or t.ndim != 4 for t in ts):
        return False
    D = q.shape[-1]
    if D % (16 // q.element_size()) or D > _MAX_D_SM90:
        return False
    for t in ts:
        if t.stride(3) != 1 or t.data_ptr() % 16:
            return False
        if any(st * t.element_size() % 16
               for st in _seq_strides(t, layout)):
            return False
    return True


def _bias_strides(bias):
    if bias is None:
        return (0, 0, 0)
    return tuple(0 if bias.shape[i] == 1 else bias.stride(i)
                 for i in range(3))


def _bind(lib, symbol):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i,
                       p, i, p]
        fn.restype = i
    return fn


def _launch(q, k, v, bias, scale, causal, layout, return_lse, dropout):
    """The forward kernel: the tensor-core one of q's dtype where
    _sm90_eligible holds, else the CUDA-core one."""
    B, H, Sq, Sk, D = _check(q, k, v, bias, layout)
    seed, t = _check_dropout(dropout, q.device) or (None, 0)
    out = torch.empty_like(q)
    sm90 = _sm90_eligible(q, k, v, out, layout)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    strides = (ctypes.c_int64 * 15)(
        *_seq_strides(q, layout), *_seq_strides(k, layout),
        *_seq_strides(v, layout), *_seq_strides(out, layout),
        *_bias_strides(bias))
    name = (_KERNEL if not sm90 else _KERNEL_SM90
            if q.dtype == torch.bfloat16 else _KERNEL_F32_SM90)
    fn = _bind(registry.library(name), "pt_" + name)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 out.data_ptr(), None if lse is None else lse.data_ptr(),
                 _DTYPES[q.dtype], B, H, Sq, Sk, D, strides, float(scale),
                 int(bool(causal)), None if seed is None else seed.data_ptr(),
                 t, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    registry.count_launch(_KERNEL)
    if sm90:
        registry.count_launch(name)
    return (out, lse) if return_lse else out


def _bind_bwd(lib, symbol):
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 13 + [i] * 6 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i, p, i, p]
        fn.restype = i
    return fn


def _launch_bwd(q, k, v, bias, out, lse, dout, scale, causal, layout,
                dropout, want_dbias, g_lse=None):
    """The dq kernel, then the dk/dv kernel: for bf16 where _sm90_eligible
    holds (out too meets TMA's rules) the tensor-core ones, the dq kernel
    with the di pre-pass fused in; else (float32 always) the CUDA-core
    ones, dq after its di pre-pass."""
    B, H, Sq, Sk, D = _check(q, k, v, bias, layout)
    seed, t = _check_dropout(dropout, q.device) or (None, 0)
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
    if g_lse is not None:
        if g_lse.shape != (B, H, Sq) or g_lse.device != q.device:
            raise ValueError(f"fused attention backward: g_lse must be "
                             f"[{B}, {H}, {Sq}] on {q.device}, got "
                             f"{tuple(g_lse.shape)} on {g_lse.device}")
        g_lse = g_lse.to(torch.float32).contiguous()
    sm90 = q.dtype == torch.bfloat16 and \
        _sm90_eligible(q, k, v, dout, layout) and \
        _sm90_eligible(out, k, v, dout, layout)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    want_dbias = bool(want_dbias) and bias is not None
    ds = torch.zeros((B, H, Sq, Sk), dtype=torch.float32,
                     device=q.device) if want_dbias else None
    strides = (ctypes.c_int64 * 27)(
        *(st for x in (q, k, v, out, dout, dq, dk, dv)
          for st in _seq_strides(x, layout)), *_bias_strides(bias))
    ptr = (lambda x: None if x is None else x.data_ptr())
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), ptr(bias), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ptr(ds),
            ptr(g_lse), _DTYPES[q.dtype], B, H, Sq, Sk, D, strides, float(scale),
            int(bool(causal)), ptr(seed), t)
    if sm90:
        launches = (((_KERNEL_DQ, _KERNEL_DQ_SM90),
                     "pt_flash_attention_bwd_dq_sm90"),
                    ((_KERNEL_DKV, _KERNEL_DKV_SM90),
                     "pt_flash_attention_bwd_dkv_sm90"))
    else:
        launches = (((_KERNEL_DQ,), "pt_flash_attention_bwd_dq"),
                    ((_KERNEL_DKV,), "pt_flash_attention_bwd_dkv"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for names, symbol in launches:
            lib = registry.library(names[-1])
            err = _bind_bwd(lib, symbol)(*args, stream)
            if err != 0:
                raise RuntimeError(f"{names[-1]} launch failed with CUDA "
                                   f"error {err}")
            for name in names:
                registry.count_launch(name)
    dbias = _reduce_bias_grad(ds, bias) if want_dbias else None
    return dq, dk, dv, dbias


def wgmma_probe(a, b):
    """One m64n64k16 wgmma product of each kind the tensor-core kernels
    use, on the card: a, b [64, 64] bf16 CUDA tensors; returns
    (a . b^T from shared memory, bf16(a . b^T) . b with A from registers)
    in float32. For the card tests."""
    if a.shape != (64, 64) or b.shape != (64, 64) or a.device.type != \
            "cuda" or a.dtype != torch.bfloat16 or b.dtype != a.dtype:
        raise ValueError("wgmma_probe takes two [64, 64] bf16 CUDA tensors")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty((64, 64), dtype=torch.float32, device=a.device)
    r = torch.empty_like(c)
    fn = registry.library(_KERNEL_SM90).pt_fa_sm90_wgmma_probe
    p = ctypes.c_void_p
    fn.argtypes, fn.restype = [p] * 5, ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), r.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma probe failed with CUDA error {err}")
    return c, r
