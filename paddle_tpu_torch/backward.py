"""append_backward: the grad program built in Python.

Counterpart of paddle_tpu/backward.py, op for op: the default grad op of
a forward op of type T is `T_grad` (core/registry.py gives it the generic
vector-Jacobian-product lowering unless a hand-written one overrides
it); it binds the forward inputs and outputs, each output's cotangent
under `<slot>@GRAD`, and writes `<slot>@GRAD` for each input slot that
needs a gradient. A var that receives several gradient contributions
gets them under `<name>@GRAD`, `<name>@GRAD@RENAME@1`, ... and one `sum`
op adds them before the first reader.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from . import framework
from .core.registry import GRAD_SUFFIX, OP_UID_ATTR, OPS, RENAME_SEP
from .core.types import DT_BFLOAT16, DT_FLOAT16, DT_FLOAT32, DT_FLOAT64, \
    convert_dtype

__all__ = ["append_backward", "OP_ROLE_ATTR"]

OP_ROLE_ATTR = "op_role"

_FLOAT_DTYPES = (DT_FLOAT16, DT_BFLOAT16, DT_FLOAT32, DT_FLOAT64)


def _grad_name(name: str) -> str:
    return name + GRAD_SUFFIX


class _GradAccumulator:
    """Gradient contributions per forward var; finalized with sum ops."""

    def __init__(self, block):
        self.block = block
        self.contribs: Dict[str, List[str]] = {}
        self.finalized: Dict[str, str] = {}

    def add(self, var_name: str) -> str:
        """Reserve the output name of a new contribution."""
        lst = self.contribs.setdefault(var_name, [])
        out = _grad_name(var_name) if not lst else \
            f"{_grad_name(var_name)}{RENAME_SEP}{len(lst)}"
        lst.append(out)
        self.finalized.pop(var_name, None)
        return out

    def has(self, var_name: str) -> bool:
        return bool(self.contribs.get(var_name))

    def final(self, var_name: str) -> Optional[str]:
        """The name holding the whole gradient of var_name, appending a
        sum op on first request when there are several contributions."""
        if var_name in self.finalized:
            return self.finalized[var_name]
        lst = self.contribs.get(var_name)
        if not lst:
            return None
        gname = _grad_name(var_name)
        if len(lst) > 1:
            fwd = self.block._find_var_recursive(var_name)
            self.block.create_var(name=gname, shape=fwd.shape,
                                  dtype=fwd.dtype)
            self.block.append_op(
                "sum", inputs={"X": list(lst)}, outputs={"Out": gname},
                attrs={OP_ROLE_ATTR: "backward"})
        self.finalized[var_name] = gname
        return gname


def _create_grad_var(block, fwd_name: str, grad_name: str):
    if block.has_var(grad_name):
        return block.vars[grad_name]
    fwd = block._find_var_recursive(fwd_name)
    return block.create_var(
        name=grad_name, shape=fwd.shape if fwd is not None else (),
        dtype=fwd.dtype if fwd is not None else "float32")


def _input_needs_grad(block, name: str, no_grad_set: Set[str]) -> bool:
    if name in no_grad_set:
        return False
    v = block._find_var_recursive(name)
    if v is None or v.stop_gradient:
        return False
    return convert_dtype(v.dtype) in _FLOAT_DTYPES


def _make_grad_op(block, op, acc: _GradAccumulator, no_grad_set: Set[str]):
    """Append `<type>_grad` for one forward op; False if no gradient
    flows through it."""
    info = OPS.get(op.type)
    grad_type = op.type + "_grad"
    if not OPS.has(grad_type):
        return False
    if not any(acc.has(n) for n in op.output_arg_names):
        return False

    inputs, outputs = {}, {}
    for slot in op.input_slots():
        names = op.input(slot)
        inputs[slot] = list(names)
        if slot in info.no_grad_slots:
            continue
        g_names = [acc.add(n) if _input_needs_grad(block, n, no_grad_set)
                   else "" for n in names]
        if any(g_names):
            outputs[slot + GRAD_SUFFIX] = g_names
    if not outputs:
        return False

    for slot in op.output_slots():
        names = op.output(slot)
        inputs[slot] = list(names)
        inputs[slot + GRAD_SUFFIX] = [acc.final(n) or "" for n in names]

    attrs = dict(op._all_attrs())
    attrs[OP_ROLE_ATTR] = "backward"
    # the forward uid: the grad op draws the forward's random numbers
    # and finds the forward's record
    attrs[OP_UID_ATTR] = op.attr(OP_UID_ATTR)

    for names in outputs.values():
        for n in names:
            if n:
                _create_grad_var(block, n.split(GRAD_SUFFIX)[0], n)
    block.append_op(grad_type, inputs=inputs, outputs=outputs, attrs=attrs,
                    infer_shape=False)
    return True


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append the ops computing d loss / d params to loss's program.
    Returns [(param, grad_var)]."""
    block = loss.block
    no_grad = set(no_grad_set or ())
    if tuple(loss.shape) not in ((), (1,)):
        raise ValueError(
            f"loss must be a scalar (shape () or (1,)), got {loss.shape}")

    loss_grad = _grad_name(loss.name)
    block.create_var(name=loss_grad, shape=loss.shape, dtype=loss.dtype)
    block.append_op(
        "fill_constant", inputs={}, outputs={"Out": loss_grad},
        attrs={"shape": list(loss.shape), "value": 1.0,
               "dtype": int(loss.dtype), OP_ROLE_ATTR: "backward"})

    acc = _GradAccumulator(block)
    acc.contribs[loss.name] = [loss_grad]

    fwd_ops = [op for op in block.ops
               if op.attr(OP_ROLE_ATTR, "forward") == "forward"]
    loss_idx = len(fwd_ops)
    for i, op in enumerate(fwd_ops):
        if loss.name in op.output_arg_names:
            loss_idx = i
    for op in reversed(fwd_ops[:loss_idx + 1]):
        _make_grad_op(block, op, acc, no_grad)

    if parameter_list is None:
        params = [p.name for p in block.program.all_parameters()
                  if p.trainable]
    else:
        params = [p.name if isinstance(p, framework.Variable) else p
                  for p in parameter_list]
    params_and_grads = []
    for pname in params:
        g = acc.final(pname)
        if g is None:
            continue
        params_and_grads.append((block._find_var_recursive(pname),
                                 block._find_var_recursive(g)))
    return params_and_grads
