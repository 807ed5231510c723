"""Enforce-style error layer (counterpart of paddle_tpu/core/enforce.py).

The engine wraps each lowering call and re-raises a failure as
``EnforceNotMet`` carrying the op type, its slot->var-name map and the
shape/dtype of every input already computed, so a user debugs the
Program rather than a torch stack trace.
"""
from __future__ import annotations

__all__ = ["EnforceNotMet", "format_op_context", "wrap_op_error"]


class EnforceNotMet(RuntimeError):
    """Raised when running an op fails or a runtime check trips."""

    def __init__(self, message: str, op_type: str = None):
        super().__init__(message)
        self.op_type = op_type


def _shape_of(value):
    shape = getattr(value, "shape", None)
    if shape is None:
        return type(value).__name__
    return f"{getattr(value, 'dtype', None)}{list(shape)}"


def format_op_context(op, env, op_index=None) -> str:
    where = f"op #{op_index} " if op_index is not None else "op "
    lines = [f"{where}type={op.type!r}"]
    for slot in op.input_slots():
        names = op.input(slot)
        if not names:
            continue
        rendered = [f"{n}:{_shape_of(env[n])}" if n in env
                    else f"{n}:<not computed>" for n in names]
        lines.append(f"  input  {slot}: " + ", ".join(rendered))
    for slot in op.output_slots():
        names = op.output(slot)
        if names:
            lines.append(f"  output {slot}: " + ", ".join(names))
    small = {k: v for k, v in sorted(op.all_attrs().items())
             if isinstance(v, (int, float, bool, str))}
    if small:
        lines.append(f"  attrs: {small}")
    return "\n".join(lines)


def wrap_op_error(exc: Exception, op, env, op_index=None) -> EnforceNotMet:
    msg = (f"Error running operator {op.type!r}:\n"
           f"{format_op_context(op, env, op_index)}\n"
           f"caused by: {type(exc).__name__}: {exc}")
    err = EnforceNotMet(msg, op_type=op.type)
    err.__cause__ = exc
    return err
