"""Retries and circuit breakers (counterpart of
paddle_tpu/distributed/resilience.py, the part that the RPC framing and
the serving engine use).

* `RetryPolicy` — exponential backoff with jitter under a total
  deadline, from ``FLAGS_rpc_*``;
* `CircuitBreaker` / `HealthRegistry` / `endpoint_health` — per
  endpoint, closed -> (N consecutive failures) -> open -> (cooldown) ->
  half-open (one probe) -> closed or open again, so a dead peer fails
  fast. The serving engine guards its model runner under the
  pseudo-endpoint ``serve:runner``;
* `retry_stats` — the retry accounting the metrics collector reads.

The trainer liveness registry, heartbeat and step watchdog wait for the
parameter server (ROADMAP.md A.9). Clocks are injectable (``clock=``).
"""
from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.flags import FLAGS

__all__ = ["RetryPolicy", "CircuitBreaker", "CircuitOpenError",
           "HealthRegistry", "endpoint_health", "retry_stats",
           "consume_retry", "reset_retry_stats"]

_log = logging.getLogger(__name__)

_stats_lock = threading.Lock()
_retry_stats: Dict[str, int] = {"retries": 0, "breaker_fast_fails": 0}


def consume_retry(kind: str = "retries") -> None:
    with _stats_lock:
        _retry_stats[kind] = _retry_stats.get(kind, 0) + 1


def retry_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_retry_stats)


def reset_retry_stats() -> None:
    with _stats_lock:
        for k in list(_retry_stats):
            _retry_stats[k] = 0


class RetryPolicy:
    """Exponential backoff with jitter under a total deadline: retry i
    sleeps min(cap, base * multiplier**i) * U[1, 1 + jitter]."""

    def __init__(self, deadline_s: float = 60.0, max_retries: int = 5,
                 base_s: float = 0.1, multiplier: float = 2.0,
                 max_backoff_s: float = 2.0, jitter: float = 0.5,
                 rng=None, clock: Callable[[], float] = time.monotonic):
        self.deadline_s = float(deadline_s)
        self.max_retries = max(0, int(max_retries))
        self.base_s = float(base_s)
        self.multiplier = float(multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = float(jitter)
        self._rng = rng
        self._clock = clock

    @classmethod
    def from_flags(cls, deadline_s: Optional[float] = None,
                   max_retries: Optional[int] = None) -> "RetryPolicy":
        return cls(
            deadline_s=(FLAGS.rpc_deadline_s if deadline_s is None
                        else deadline_s),
            max_retries=(FLAGS.rpc_max_retries if max_retries is None
                         else max_retries),
            base_s=FLAGS.rpc_backoff_base_s,
            max_backoff_s=FLAGS.rpc_backoff_max_s,
            jitter=FLAGS.rpc_backoff_jitter)

    def delays(self) -> List[float]:
        """The backoff schedule, one entry a retry."""
        u = self._rng.random if self._rng is not None else random.random
        return [min(self.max_backoff_s, self.base_s * self.multiplier ** i)
                * (1.0 + self.jitter * u())
                for i in range(self.max_retries)]

    def sleep_budgeted(self, delay: float, start: float) -> bool:
        """Sleep `delay` within the deadline; False when it is spent."""
        remaining = self.deadline_s - (self._clock() - start)
        if remaining <= 0:
            return False
        time.sleep(min(delay, remaining))
        return True

    def attempt_timeout(self, start: float,
                        per_attempt: Optional[float] = None) -> float:
        """The next attempt's socket timeout: `per_attempt` clipped to
        what is left of the deadline."""
        remaining = self.deadline_s - (self._clock() - start)
        cap = per_attempt if per_attempt is not None else self.deadline_s
        return max(0.001, min(cap, remaining))


class CircuitOpenError(ConnectionError):
    """Fast fail: the endpoint's breaker is open, no connection was
    tried. An OSError, so transport handling treats it as transient."""


class CircuitBreaker:
    """closed -> (failure_threshold consecutive failures) -> open ->
    (cooldown_s) -> half-open (one probe) -> closed on success, open on
    failure."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5,
                 cooldown_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False

    def allow(self) -> bool:
        """May a request go now? Half-open lets exactly one caller (the
        probe) through until it reports."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self.state = self.HALF_OPEN
                self._probe_inflight = False
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self.state = self.CLOSED
            self.consecutive_failures = 0
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if self.state == self.HALF_OPEN or \
                    self.consecutive_failures >= self.failure_threshold:
                if self.state != self.OPEN:
                    _log.warning(
                        "circuit breaker OPEN after %d consecutive "
                        "failures (cooldown %.1fs)",
                        self.consecutive_failures, self.cooldown_s)
                self.state = self.OPEN
                self._opened_at = self._clock()
                self._probe_inflight = False


class HealthRegistry:
    """One breaker an endpoint, process-wide; thresholds from
    ``FLAGS_rpc_breaker_*`` at an endpoint's first use."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._clock = clock

    def get(self, endpoint: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(endpoint)
            if br is None:
                br = self._breakers[endpoint] = CircuitBreaker(
                    failure_threshold=int(FLAGS.rpc_breaker_failures),
                    cooldown_s=float(FLAGS.rpc_breaker_cooldown_s),
                    clock=self._clock)
            return br

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {ep: {"state": b.state,
                         "consecutive_failures": b.consecutive_failures}
                    for ep, b in self._breakers.items()}

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()


# the process-wide registry async_ps._rpc and the serving engine consult
endpoint_health = HealthRegistry()
