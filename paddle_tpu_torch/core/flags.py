"""Runtime flags (counterpart of paddle_tpu/core/flags.py).

The port defines only the flags its runtime reads. Each has a default
here; a ``FLAGS_<name>`` environment variable overrides it when this
module is imported, and ``set_flags``/``get_flags`` write and read it at
run time. Setting an unknown flag raises.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["get_flags", "set_flags", "FLAGS"]

_DEFAULTS: Dict[str, Any] = {
    # route eligible ops through the custom-kernel registry
    # (kernels/registry.py); per-kernel denial: PT_KERNEL_DENY
    "use_custom_kernels": True,
    # the RPC framing of distributed/async_ps.py and its resilience
    # layer (distributed/resilience.py), with the JAX package's defaults
    "rpc_deadline_s": 60.0,       # total deadline of one RPC, retries in
    "rpc_max_retries": 5,         # retries after the first attempt
    "rpc_backoff_base_s": 0.1,    # retry i sleeps base * 2**i (+ jitter)
    "rpc_backoff_max_s": 2.0,     # one backoff's cap, before jitter
    "rpc_backoff_jitter": 0.5,    # each backoff scaled by U[1, 1+jitter]
    "rpc_breaker_failures": 5,    # consecutive failures that open a breaker
    "rpc_breaker_cooldown_s": 2.0,  # open breaker's wait before a probe
    "rpc_max_message_mb": 1024,   # refuse a larger length prefix unread
    # metric observation and spans (observability/metrics.py)
    "telemetry": False,
    # the gradient bucket cap in MB of parallel/comm_scheduler.py's
    # planner; <= 0: one bucket a gradient
    "allreduce_bucket_mb": 32.0,
}
_VALUES: Dict[str, Any] = dict(_DEFAULTS)
_LOCK = threading.Lock()


def _coerce(name: str, value):
    kind = type(_DEFAULTS[name])
    if kind is bool and isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    return kind(value)


def _name(raw: str) -> str:
    name = raw[6:] if raw.startswith("FLAGS_") else raw
    if name not in _DEFAULTS:
        raise ValueError(f"unknown flag {raw!r}; known flags: "
                         f"{sorted(_DEFAULTS)}")
    return name


def set_flags(flags: Dict[str, Any]):
    """Set flags by name (``{"FLAGS_use_custom_kernels": False}`` or the
    bare name)."""
    with _LOCK:
        for raw, value in flags.items():
            name = _name(raw)
            _VALUES[name] = _coerce(name, value)
            if name == "telemetry":
                from ..observability import metrics
                metrics.enable_telemetry(_VALUES[name])


def get_flags(names) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {"FLAGS_" + _name(raw): _VALUES[_name(raw)] for raw in names}


class _FlagsView:
    """Attribute access for runtime code: ``FLAGS.use_custom_kernels``."""

    def __getattr__(self, name):
        try:
            return _VALUES[name]
        except KeyError:
            raise AttributeError(name) from None


FLAGS = _FlagsView()

for _n in _DEFAULTS:
    if os.environ.get("FLAGS_" + _n) is not None:
        _VALUES[_n] = _coerce(_n, os.environ["FLAGS_" + _n])
