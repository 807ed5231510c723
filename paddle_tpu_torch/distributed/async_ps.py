"""The RPC framing (counterpart of paddle_tpu/distributed/async_ps.py,
its transport: ``_send_msg`` / ``_recv_exact`` / ``_recv_msg`` /
``_parse_ep`` / ``_rpc``). The serving server (inference/serving/
server.py) speaks it; the parameter server that the JAX module also
holds waits for ROADMAP.md A.9.

A message is an 8-byte little-endian length, then a pickle. Trust
boundary: the wire has no authentication or encryption and is meant
for a private network. Two mitigations bound a reachable port: an
endpoint with an empty host binds loopback (``_parse_ep``), and a
message is unpickled by a restricted Unpickler that builds only numpy
array, scalar and dtype machinery and builtin containers (an arbitrary
``__reduce__`` payload is refused before any object is built), and a
length prefix above ``FLAGS_rpc_max_message_mb`` is refused before
anything is allocated. The two ends of one wire are always this module
(or the JAX package's, which frames the same way).
"""
from __future__ import annotations

import io as _io
import pickle
import socket
import struct
import time
from typing import Optional

from ..core.flags import FLAGS
from ..observability import metrics as _obs_metrics
from ..observability import tracing as _obs_tracing
from . import faults
from .resilience import (CircuitOpenError, RetryPolicy, consume_retry,
                         endpoint_health)

__all__ = ["MessageTooLargeError"]

_LEN = struct.Struct("<Q")


class MessageTooLargeError(RuntimeError):
    """A length prefix above FLAGS_rpc_max_message_mb, refused before
    allocation. No OSError: the RPC layer must not retry it."""


# every global a wire payload may construct: numpy's array, scalar and
# dtype reconstruction (numpy 1.x "numpy.core" and 2.x "numpy._core")
# and builtin containers
_SAFE_PICKLE_GLOBALS = {
    "builtins": {"dict", "list", "tuple", "set", "frozenset", "str",
                 "bytes", "bytearray", "int", "float", "bool",
                 "complex", "slice", "range", "NoneType"},
    "numpy": {"ndarray", "dtype"},
    "numpy.core.multiarray": {"_reconstruct", "scalar"},
    "numpy._core.multiarray": {"_reconstruct", "scalar"},
    "numpy.core.numeric": {"_frombuffer"},
    "numpy._core.numeric": {"_frombuffer"},
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in _SAFE_PICKLE_GLOBALS.get(module, ()):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: not on the wire "
            f"allowlist (see paddle_tpu_torch/distributed/async_ps.py)")


def _safe_loads(payload: bytes):
    return _RestrictedUnpickler(_io.BytesIO(payload)).load()


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    data = _LEN.pack(len(payload)) + payload
    plan = faults.current()
    if plan is not None:
        action = plan.on_send(len(data))
        if action is not None:
            kind, n = action
            try:
                sock.sendall(data[:n])
            finally:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            if kind == "drop":
                raise ConnectionResetError(
                    "fault-injected mid-message drop")
            return      # "truncate": the sender reports success
    sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket):
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    cap = int(FLAGS.rpc_max_message_mb) * 1024 * 1024
    if cap > 0 and n > cap:
        raise MessageTooLargeError(
            f"refusing to allocate a {n}-byte wire message (> "
            f"FLAGS_rpc_max_message_mb={FLAGS.rpc_max_message_mb}); "
            f"corrupted or hostile length prefix")
    return _safe_loads(_recv_exact(sock, n))


def _parse_ep(endpoint: str):
    """(host, port) of "host:port"; an empty host is loopback, never
    0.0.0.0."""
    host, port = endpoint.rsplit(":", 1)
    return host or "127.0.0.1", int(port)


def _rpc(endpoint: str, msg, timeout: Optional[float] = None,
         retries: Optional[int] = None, track_health: bool = True):
    """One request and its reply under the resilience policy: a total
    deadline (FLAGS_rpc_deadline_s), FLAGS_rpc_max_retries retries with
    exponential backoff and jitter, and the endpoint's circuit breaker,
    which fast-fails while the endpoint is known dead. At least once: a
    request whose reply is lost may be handled twice.

    `timeout` caps one attempt's socket operations (clipped to the
    deadline); track_health=False keeps a liveness poll out of the
    breaker's books. While tracing is on, the client span id rides the
    message as ``tctx`` (str values: it passes the restricted
    unpickler), so the server parents its span under it; the client
    span is recorded on every exit, with the retries, the outcome and
    the breaker's state."""
    host, port = _parse_ep(endpoint)
    policy = RetryPolicy.from_flags()
    if retries is not None:
        policy.max_retries = max(0, int(retries) - 1)
    breaker = endpoint_health.get(endpoint) if track_health else None
    plan = faults.current()
    tctx = parent = None
    t0 = retried = 0
    if _obs_metrics._HOT[0] and isinstance(msg, dict):
        ctx = _obs_tracing.current_context()
        trace = (ctx["trace"] if ctx
                 else f"{_obs_tracing.worker_id()}-detached")
        parent = ctx["span"] if ctx else None
        tctx = {"trace": trace, "span": _obs_tracing.new_span_id(),
                "worker": _obs_tracing.worker_id()}
        msg = dict(msg)
        msg["tctx"] = tctx
        t0 = time.time()
    start = time.monotonic()
    delays = iter(policy.delays())
    last: Optional[OSError] = None
    outcome = "error"
    try:
        while True:
            if breaker is not None and not breaker.allow():
                consume_retry("breaker_fast_fails")
                outcome = "breaker_fast_fail"
                raise CircuitOpenError(
                    f"circuit breaker open for {endpoint} after "
                    f"{breaker.consecutive_failures} consecutive "
                    f"failures; next probe after "
                    f"FLAGS_rpc_breaker_cooldown_s") from last
            try:
                if plan is not None:
                    plan.on_connect(endpoint)
                with socket.create_connection(
                        (host, port),
                        timeout=policy.attempt_timeout(start, timeout)) as s:
                    _send_msg(s, msg)
                    rep = _recv_msg(s)
                if breaker is not None:
                    breaker.record_success()
                outcome = "ok"
                return rep
            except OSError as exc:
                last = exc
                if breaker is not None:
                    breaker.record_failure()
                delay = next(delays, None)
                if delay is None:
                    consume_retry("retries_exhausted")
                    outcome = "retries_exhausted"
                    raise
                if not policy.sleep_budgeted(delay, start):
                    consume_retry("deadline_exhausted")
                    outcome = "deadline_exhausted"
                    raise
                consume_retry()
                retried += 1
    finally:
        if tctx is not None:
            _obs_tracing.record_span(
                f"rpc.{msg.get('t')}", t0, (time.time() - t0) * 1e3,
                kind="rpc.client", trace=tctx["trace"],
                span_id=tctx["span"], parent=parent,
                ann={"endpoint": endpoint, "type": str(msg.get("t")),
                     "retries": retried, "outcome": outcome,
                     "breaker": (breaker.state if breaker is not None
                                 else None)})
