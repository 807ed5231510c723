"""Automatic mixed precision state (bf16 compute, float32 master weights).

Counterpart of paddle_tpu/core/amp.py, with the same op lists and the
same policy, in torch dtypes. The policy is applied centrally by
ExecContext (core/registry.py) while a block runs under amp_guard:

* WHITE (matrix-product ops): float32 inputs are read as the amp dtype,
  so their results stay in the amp dtype.
* GRAY (elementwise, activation and shape ops): follow the inputs; if any
  float input already has the amp dtype, float32 inputs are cast down.
* BLACK (losses and reductions): reduced-precision inputs are read as
  float32.
* NORM (layer_norm and kin): inputs untouched; the lowering computes its
  statistics in float32 and emits Y in the input's dtype.
* OUT_CAST (lookup_table): inputs untouched (no cast of a vocab-sized
  table); the gathered rows are cast to the amp dtype on output.

Everything else sees values exactly as the env holds them. The engine
enters amp_guard from Program._amp, which the mixed-precision decorator
sets (contrib/mixed_precision).
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()

WHITE_OPS = frozenset({
    "matmul", "mul", "conv2d", "depthwise_conv2d", "conv2d_transpose",
    "conv3d", "fused_attention",
})

GRAY_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "sum",
    "relu", "relu6", "gelu", "tanh", "sigmoid", "leaky_relu", "elu",
    "swish", "softplus", "softsign", "brelu", "soft_relu",
    "hard_sigmoid", "selu", "stanh", "logsigmoid", "sqrt", "rsqrt",
    "abs", "pow", "scale", "clip", "dropout",
    "pool2d", "pad", "pad2d", "concat", "split", "stack", "slice",
    "reshape2", "reshape", "transpose2", "transpose", "squeeze2",
    "squeeze", "unsqueeze2", "unsqueeze", "expand", "flatten2",
    "flatten", "add_position_encoding",
})

# label_smoothed_softmax_xent is not here: its lowering reads the logits
# in their own dtype and upcasts inside each reduction
BLACK_OPS = frozenset({
    "softmax", "log_softmax", "softmax_with_cross_entropy",
    "cross_entropy", "cross_entropy2",
    "sigmoid_cross_entropy_with_logits",
    "mean", "reduce_mean", "reduce_sum", "exp", "log", "square",
    "cos_sim",
})

NORM_OPS = frozenset({
    "layer_norm", "batch_norm", "group_norm", "data_norm",
})

OUT_CAST_OPS = frozenset({"lookup_table", "lookup_table_v2"})

_REDUCED = (torch.bfloat16, torch.float16)


def _st():
    if not hasattr(_state, "cfg"):
        _state.cfg = {"enabled": False, "dtype": torch.bfloat16,
                      "black": frozenset(), "white": frozenset()}
    return _state.cfg


def amp_dtype() -> torch.dtype:
    return _st()["dtype"]


@contextlib.contextmanager
def amp_guard(enabled=True, dtype=torch.bfloat16, black_ops=(),
              white_ops=()):
    old = dict(_st())
    _st().update(enabled=enabled, dtype=dtype, black=frozenset(black_ops),
                 white=frozenset(white_ops))
    try:
        yield
    finally:
        _st().update(old)


def op_mode(op_type: str):
    """Policy mode of an op type under the active amp config, or None when
    amp is off or the op is unlisted. The decorator's lists override the
    defaults."""
    cfg = _st()
    if not cfg["enabled"]:
        return None
    if op_type in cfg["white"] and op_type not in cfg["black"]:
        return "white"
    if op_type in cfg["black"] or op_type in BLACK_OPS:
        return "black"
    if op_type in NORM_OPS:
        return "norm"
    if op_type in WHITE_OPS:
        return "white"
    if op_type in OUT_CAST_OPS:
        return "out_cast"
    if op_type in GRAY_OPS:
        return "gray"
    return None


def cast_in(mode, value, follow: bool):
    """The input-side policy for one value. `follow`: some float input of
    this op already carries the amp dtype (gray ops)."""
    dt = getattr(value, "dtype", None)
    if dt is None:
        return value
    if mode == "white":
        if dt == torch.float32:
            return value.to(_st()["dtype"])
    elif mode == "gray":
        if follow and dt == torch.float32:
            return value.to(_st()["dtype"])
    elif mode == "black":
        if dt in _REDUCED:
            return value.float()
    return value


def cast_out(mode, value):
    if mode == "out_cast" and getattr(value, "dtype", None) == torch.float32:
        return value.to(_st()["dtype"])
    return value


def amp_cast(op_type, *vals):
    """Cast float32 operands of a white op to the amp dtype (no-op when
    amp is off or the op is black-listed). For lowerings that are not
    under the context policy themselves, such as a hand-written grad op,
    so that they read what their forward read."""
    cfg = _st()
    if not cfg["enabled"] or op_type in cfg["black"]:
        return vals
    return tuple(v.to(cfg["dtype"]) if v is not None
                 and v.dtype == torch.float32 else v for v in vals)
