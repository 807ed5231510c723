"""fused_attention and its hand-written grad (counterpart of
paddle_tpu/ops/fused.py).

The op always goes through kernels/flash_attention: on a CUDA tensor
that launches the hand-written kernels, on a CPU tensor it runs their
plain versions. The JAX package's TPU block-size policy and its
kernel-vs-composed crossover were measured on a TPU and are not carried
over: the CUDA kernels pick their own tiles, and block_q/block_k stay in
the Program only for parity.

Attention dropout (dropout_prob, off under is_test) draws its two seed
words from the op's seed (program seed, op uid, run index) and hands
them to the kernels as a device tensor (ExecContext.seed_tensor: in a
block the engine captures, the tensor it rewrites before each replay);
the grad op has the forward's uid and so the same words. When the grad
op is in the block, the forward keeps (out, lse, seed) as its record
and the grad op consumes it: the forward kernel runs once per step, and
the backward reads the forward's own out and lse.
"""
from __future__ import annotations

import torch

from ..core.amp import amp_cast
from ..core.registry import GRAD_SUFFIX, override_grad_lowering, register_op
from ..kernels.flash_attention import (fused_attention_backward,
                                       fused_attention_forward)


def _attn_args(ctx):
    """One parse of the op for forward and grad: q, k, v, the float32
    bias, layout, scale, causal and the dropout threshold. Under AMP the
    grad op (not under the context policy) casts as its forward read:
    q/k/v and the bias in the amp dtype, so the kernels add the bias
    rounded through bf16, as the JAX package's."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    bias = ctx.input("BiasQK") if ctx.has_input("BiasQK") else None
    q, k, v, bias = amp_cast("fused_attention", q, k, v, bias)
    if bias is not None:
        bias = bias.float()   # the kernels read the bias in float32
    layout = ctx.attr("layout", "bhsd") or "bhsd"
    scale = ctx.attr("scale", None)
    if scale is None or scale <= 0:
        scale = float(q.shape[-1]) ** -0.5
    causal = bool(ctx.attr("causal", False))
    p_drop = float(ctx.attr("dropout_prob", 0.0) or 0.0)
    drop_t = None
    if p_drop and not ctx.attr("is_test", False):
        # u8 keep-threshold, both edges as in the dropout op: t >= 256
        # keeps everything (no dropout), t <= 0 drops everything
        t = int(round((1.0 - p_drop) * 256.0))
        if t < 256:
            drop_t = max(t, 0)
    return q, k, v, bias, layout, scale, causal, drop_t


def _dropout(ctx, drop_t):
    if drop_t is None:
        return None
    return ctx.seed_tensor(), drop_t


@register_op("fused_attention")
def fused_attention(ctx):
    """Q/K/V: [B, H, S, D] ("bhsd") or [B, S, H, D] ("bshd"); optional
    BiasQK [B, 1|H, Sq|1, Sk] additive. attrs: scale (default d^-0.5),
    layout, dropout_prob (attention-weights dropout, off under is_test),
    causal (masks cols > rows in absolute positions)."""
    q, k, v, bias, layout, scale, causal, drop_t = _attn_args(ctx)
    if drop_t == 0:
        # dropout_prob ~ 1.0: everything dropped
        ctx.set_output("Out", torch.zeros_like(q))
        return
    dropout = _dropout(ctx, drop_t)
    if ctx.wants_record():
        out, lse = fused_attention_forward(q, k, v, bias, scale, causal,
                                           layout, return_lse=True,
                                           dropout=dropout)
        ctx.record((out, lse, dropout))
    else:
        out = fused_attention_forward(q, k, v, bias, scale, causal, layout,
                                      dropout=dropout)
    ctx.set_output("Out", out)   # in q's dtype: bf16 under AMP


@override_grad_lowering("fused_attention")
def fused_attention_grad(ctx):
    """dQ, dK, dV (and dBiasQK only when BiasQK@GRAD is bound) through
    the backward kernels, from the forward's record (out, lse, seed);
    without a record the forward runs again for them. Each
    gradient comes out in its primal's dtype."""
    op = ctx.op
    q, k, v, bias, layout, scale, causal, drop_t = _attn_args(ctx)
    dout = ctx.env[op.input("Out" + GRAD_SUFFIX)[0]]

    def _bound(slot):
        names = op.output(slot + GRAD_SUFFIX)
        return bool(names and names[0])

    if drop_t == 0:
        # the forward emitted constant zeros: nothing flows back
        dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
        dbias = None if bias is None else torch.zeros_like(bias)
    else:
        rec = ctx.take_record()
        if rec is None:
            dropout = _dropout(ctx, drop_t)
            out, lse = fused_attention_forward(
                q, k, v, bias, scale, causal, layout, return_lse=True,
                dropout=dropout)
        else:
            out, lse, dropout = rec
        dq, dk, dv, dbias = fused_attention_backward(
            q, k, v, bias, out, lse, dout.to(q.dtype), scale, causal,
            layout, dropout=dropout, want_dbias=_bound("BiasQK"))

    for slot, grad in (("Q", dq), ("K", dk), ("V", dv), ("BiasQK", dbias)):
        names = op.output(slot + GRAD_SUFFIX)
        if names and names[0] and grad is not None:
            primal = ctx.env[op.input(slot)[0]]
            ctx.env[names[0]] = grad.to(primal.dtype)
