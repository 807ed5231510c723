"""The knobs the kernel registry reads (counterpart of the
``kernel_*`` entries of paddle_tpu/tuning/knobs.py, with their names,
environment variables, types and defaults).

:func:`value` reads the environment at each call, so a change to
``os.environ`` takes effect at the next dispatch.
"""
from __future__ import annotations

import os

__all__ = ["value", "names"]

# name -> (environment variable, type, default)
_KNOBS = {
    # eligibility floor for size-gated kernels (kernels/registry.py)
    "kernel_min_numel": ("PT_KERNEL_MIN_NUMEL", int, 65536),
    # comma-separated kernel names the registry must not select
    "kernel_deny": ("PT_KERNEL_DENY", str, ""),
    # quantized-matmul opt-in mode: "int8" or "bf16" (changes numerics)
    "kernel_quant_matmul": ("PT_KERNEL_QUANT_MATMUL", str, ""),
}


def value(name: str):
    """Typed current value of one knob; the default when the variable is
    unset, empty or does not parse."""
    try:
        key, kind, default = _KNOBS[name]
    except KeyError:
        raise KeyError(f"unknown knob {name!r}; known: "
                       f"{sorted(_KNOBS)}") from None
    raw = os.environ.get(key)
    if raw is None or raw == "":
        return default
    try:
        return kind(raw)
    except (TypeError, ValueError):
        return default


def names():
    """The knobs' names."""
    return tuple(_KNOBS)
