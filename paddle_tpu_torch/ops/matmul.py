"""mul, matmul and bilinear_tensor_product (counterpart of
paddle_tpu/ops/matmul.py).

Parity: the reference mul_op (flatten to 2-D by x_num_col_dims /
y_num_col_dims) and matmul_op (transpose_X/Y, 1-D promotion, alpha,
batched). Each consults the kernel registry (kernels/registry.py) on its
2-D product, as the JAX lowerings do: a registered kernel that is
eligible (the opt-in quantized_matmul, a tuned_matmul winner) computes
it; otherwise the product goes to torch.matmul, as the JAX package
leaves it to XLA. float32 stays full float32 on the card: the port never
turns TF32 on.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from ..kernels import registry as kreg


def _flat2d(x, num_col_dims):
    return x.reshape(math.prod(x.shape[:num_col_dims]),
                     math.prod(x.shape[num_col_dims:]))


def _routed(op_type, x, y, res_t):
    """The registry's kernel for the 2-D product x @ y, run, or None to
    keep the lowered path."""
    if not kreg.routable(op_type, x.device):
        return None
    sel = kreg.select(op_type, kreg.signature(op_type, x, y))
    if sel is None:
        return None
    return sel.run(x.contiguous(), y.contiguous(), out_dtype=res_t)


@register_op("mul")
def mul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    x2, y2 = _flat2d(x, xn), _flat2d(y, yn)
    out = _routed("mul", x2, y2, torch.promote_types(x.dtype, y.dtype))
    if out is None:
        out = x2 @ y2
    ctx.set_output("Out", out.reshape(out_shape))


@register_op("matmul")
def matmul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    tx = ctx.attr("transpose_X", False)
    ty = ctx.attr("transpose_Y", False)
    alpha = ctx.attr("alpha", 1.0)
    if x.ndim == 1:
        x = x[None, :] if not tx else x[:, None]
    if y.ndim == 1:
        y = y[:, None] if not ty else y[None, :]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = None
    if x.ndim == 2 and y.ndim == 2 and alpha == 1.0:
        out = _routed("matmul", x, y, torch.promote_types(x.dtype, y.dtype))
    if out is None:
        out = torch.matmul(x, y)
        if alpha != 1.0:
            out = out * alpha
    ctx.set_output("Out", out)


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ctx):
    """out[b, o] = x[b] @ Weight[o] @ y[b] (+ Bias [1, o]); Weight is
    [out, dx, dy]. No kernel computes it in the JAX package either."""
    x, y, w = ctx.input("X"), ctx.input("Y"), ctx.input("Weight")
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    b = ctx.input("Bias")
    if b is not None:
        out = out + b
    ctx.set_output("Out", out)
