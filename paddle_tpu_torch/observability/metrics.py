"""Metrics registry: counters, gauges, histograms (counterpart of
paddle_tpu/observability/metrics.py, the part that serving and the RPC
layer call).

A Prometheus-style data model: a `Counter` is a monotonic total, a
`Gauge` a point-in-time value, a `Histogram` counts observations in
exponential buckets; each may carry one series per label tuple.
Collectors are read at collect() time, so stat dicts kept elsewhere
(the circuit breakers' states, the retry counts) cost nothing per
increment.

The hot-path gate is one boolean, `_HOT[0]`: spans (tracing.py) are
recorded only while it is true, which is while telemetry is on
(`FLAGS_telemetry` or `enable_telemetry`). Counters and gauges are
always updated. The exposition endpoint, the engine collector and the
rest of the observatory are not ported (ROADMAP.md A.11).
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Family", "MetricsRegistry",
           "default_registry", "telemetry_active", "enable_telemetry",
           "counter", "gauge", "histogram", "exponential_buckets"]

# the hot-path gate, mutated only by enable_telemetry
_HOT = [False]
_TELEMETRY = [False]


def telemetry_active() -> bool:
    return _TELEMETRY[0]


def enable_telemetry(on: bool = True) -> None:
    """Turn metric observation and span recording on or off
    (FLAGS_telemetry routes here)."""
    _TELEMETRY[0] = bool(on)
    _HOT[0] = _TELEMETRY[0]


class Family:
    """One exposition family: every sample shares name, type and help."""

    __slots__ = ("name", "type", "help", "samples")

    def __init__(self, name: str, mtype: str, help: str,
                 samples: Optional[List[Tuple[Dict[str, str], object]]]
                 = None):
        self.name = name
        self.type = mtype          # "counter" | "gauge" | "histogram"
        self.help = help
        self.samples = samples if samples is not None else []


def _key(labels) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic total. `inc(v, **labels)` also adds to the series of
    that label tuple; the unlabeled value is the grand total."""

    __slots__ = ("name", "help", "value", "_series")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, v: float = 1.0, **labels) -> None:
        self.value += v
        if labels:
            k = _key(labels)
            self._series[k] = self._series.get(k, 0.0) + v

    def get(self, **labels) -> float:
        if not labels:
            return self.value
        return self._series.get(_key(labels), 0.0)

    def collect(self) -> Family:
        samples = [({}, self.value)]
        samples.extend((dict(k), v)
                       for k, v in sorted(self._series.items()))
        return Family(self.name, "counter", self.help, samples)


class Gauge:
    """Point-in-time value, one series per label tuple."""

    __slots__ = ("name", "help", "_series")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, v: float, **labels) -> None:
        self._series[_key(labels)] = float(v)

    def inc(self, v: float = 1.0, **labels) -> None:
        k = _key(labels)
        self._series[k] = self._series.get(k, 0.0) + v

    def get(self, **labels) -> float:
        return self._series.get(_key(labels), 0.0)

    def collect(self) -> Family:
        return Family(self.name, "gauge", self.help,
                      [(dict(k), v) for k, v in self._series.items()])


def exponential_buckets(start: float, factor: float,
                        count: int) -> List[float]:
    """`count` upper bounds start, start*factor, ... (the histogram adds
    the overflow bucket)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return [start * factor ** i for i in range(count)]


# 0.5 ms .. ~16 s, factor 2
DEFAULT_BUCKETS = exponential_buckets(0.0005, 2.0, 16)


class Histogram:
    """Counts of observations per exponential bucket, with their sum and
    count. observe() is one bisect and two adds."""

    __slots__ = ("name", "help", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.help = help
        self.bounds = sorted(float(b) for b in
                             (buckets if buckets is not None
                              else DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.bounds) + 1)  # +1 overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper bound, cumulative count)], ending with (inf, total)."""
        out, acc = [], 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out

    def reset(self) -> None:
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def collect(self) -> Family:
        return Family(self.name, "histogram", self.help, [({}, self)])


class MetricsRegistry:
    """Name -> metric, plus collectors read at collect() time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[[], Iterable[Family]]] = []

    def register(self, metric):
        """The metric registered under its name: the first one wins."""
        with self._lock:
            return self._metrics.setdefault(metric.name, metric)

    def counter(self, name: str, help: str = "") -> Counter:
        return self.register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.register(Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        return self.register(Histogram(name, help, buckets))

    def register_collector(
            self, fn: Callable[[], Iterable[Family]]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def get(self, name: str):
        return self._metrics.get(name)

    def collect(self) -> List[Family]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        fams = [m.collect() for m in metrics]
        for fn in collectors:
            try:
                fams.extend(fn())
            except Exception:
                continue    # a broken collector never fails a scrape
        return fams


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
            _install_standard_families(_DEFAULT)
    return _DEFAULT


def counter(name: str, help: str = "") -> Counter:
    return default_registry().counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return default_registry().gauge(name, help)


def histogram(name: str, help: str = "", buckets=None) -> Histogram:
    return default_registry().histogram(name, help, buckets)


def _rpc_families() -> List[Family]:
    """The RPC layer's retry counts and breaker states, read from
    distributed/resilience.py at collect() time."""
    from ..distributed import resilience
    fams = [Family(f"pt_rpc_{k}_total", "counter",
                   f"resilience retry_stats[{k!r}]", [({}, float(v))])
            for k, v in sorted(resilience.retry_stats().items())]
    states = {"closed": 0.0, "half_open": 1.0, "open": 2.0}
    snap = sorted(resilience.endpoint_health.snapshot().items())
    fams.append(Family(
        "pt_rpc_breaker_state", "gauge",
        "circuit breaker state per endpoint (0=closed 1=half_open "
        "2=open)",
        [({"endpoint": ep}, states.get(info["state"], -1.0))
         for ep, info in snap]))
    fams.append(Family(
        "pt_rpc_breaker_consecutive_failures", "gauge",
        "consecutive failures per endpoint",
        [({"endpoint": ep}, float(info["consecutive_failures"]))
         for ep, info in snap]))
    return fams


def _install_standard_families(reg: MetricsRegistry) -> None:
    """The families the ported modules emit, registered up front so a
    scrape lists them before their first sample."""
    reg.counter("pt_spans_recorded_total",
                "trace spans recorded, labeled {kind}")
    reg.gauge("pt_hbm_owner_bytes",
              "owner-attributed live device bytes from the memory "
              "census, labeled {owner}")
    reg.gauge("pt_hbm_live_bytes",
              "device bytes the allocator holds at the last census")
    # the serving engine (inference/serving/)
    reg.gauge("pt_serve_queue_depth",
              "requests waiting in the serving admission queue")
    reg.gauge("pt_serve_batch_occupancy",
              "live sequences in the last serving dispatch, labeled "
              "{phase} (prefill / decode)")
    reg.histogram("pt_serve_request_seconds",
                  "request latency, submit to completion")
    reg.counter("pt_serve_tokens_total",
                "tokens generated by the serving engine, labeled "
                "{tenant}")
    reg.gauge("pt_serve_tokens_per_second",
              "generated tokens per wall second over the engine's last "
              "window")
    reg.gauge("pt_serve_kv_pages_in_use",
              "KV-cache pages allocated to live sequences")
    reg.counter("pt_serve_kv_evictions_total",
                "sequences preempted under KV memory pressure")
    reg.counter("pt_serve_rejections_total",
                "requests rejected at admission, labeled {reason} "
                "(quota / queue_full / too_long)")
    reg.counter("pt_serve_requests_total",
                "serving requests retired, labeled {status}")
    reg.counter("pt_serve_step_errors_total",
                "ServingEngine.step() exceptions contained by "
                "serve_loop (nonzero means a scheduler invariant broke)")
    reg.register_collector(_rpc_families)


# FLAGS_telemetry set in the environment before this import
from ..core.flags import FLAGS as _FLAGS  # noqa: E402

if _FLAGS.telemetry:
    enable_telemetry(True)
