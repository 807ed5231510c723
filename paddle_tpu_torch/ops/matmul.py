"""mul (counterpart of paddle_tpu/ops/matmul.py). The JAX package leaves
this GEMM to XLA, with no Pallas kernel; the port leaves it to
torch.matmul. float32 stays full float32 on the card: the port never
turns TF32 on."""
from __future__ import annotations

import math

from ..core.registry import register_op


def _flat2d(x, num_col_dims):
    return x.reshape(math.prod(x.shape[:num_col_dims]),
                     math.prod(x.shape[num_col_dims:]))


@register_op("mul")
def mul(ctx):
    x, y = ctx.input("X"), ctx.input("Y")
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    out_shape = tuple(x.shape[:xn]) + tuple(y.shape[yn:])
    out = _flat2d(x, xn) @ _flat2d(y, yn)
    ctx.set_output("Out", out.reshape(out_shape))
