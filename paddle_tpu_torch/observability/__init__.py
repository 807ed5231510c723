"""paddle_tpu_torch.observability (counterpart of
paddle_tpu/observability/, the part that serving and the RPC layer
call): the metrics registry (metrics.py), correlated spans
(tracing.py, with the dump directory of recorder.py) and the
device-memory census of the serving owners (memory.py). The rest of the
JAX package's observatory is ROADMAP.md A.11.
"""
from . import memory, metrics, recorder, tracing  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, counter, default_registry,
                      enable_telemetry, gauge, histogram,
                      telemetry_active)
