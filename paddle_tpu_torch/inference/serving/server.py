"""The multi-tenant serving front end on the RPC framing (counterpart
of paddle_tpu/inference/serving/server.py).

One ``ServeServer`` wraps one ``ServingEngine``: the accept loop and a
bounded handler pool reuse the async_ps idiom (length-prefixed
restricted-pickle framing — ``_send_msg``/``_recv_msg`` — so the wire
hardening of distributed/async_ps.py applies unchanged), while a
dedicated thread runs
the engine's ``serve_loop``. Handlers block on ``Request.done`` — the
scheduler, not the transport, decides batching.

Tenancy lives in the engine's ``TenantQuota`` map (per-tenant
concurrency cap + token budget); the server's job is routing the
``tenant`` field, the trace context, and graceful shutdown: SIGTERM
(``install_signal_handlers``) flips the engine to draining — new
submissions reject with ``queue_full``, every in-flight request
finishes, then the accept loop exits. Clients use ``generate``/
``serve_rpc``, which ride ``_rpc`` and therefore inherit retries,
per-endpoint circuit breakers, and client-side trace spans for free.
The messages are the reference's (ping, gen, stats, drain) but
``metrics``: the exposition endpoint is not ported (ROADMAP.md A.11).
"""
from __future__ import annotations

import signal
import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ...distributed import faults
from ...distributed.async_ps import (_parse_ep, _recv_msg, _rpc,
                                     _send_msg)
from ...observability import tracing as _obs_tracing
from .scheduler import ServingEngine

__all__ = ["ServeServer", "generate", "serve_rpc"]


class ServeServer:
    """Socket front-end for a ServingEngine. ``serve()`` blocks;
    ``start()`` runs it on a daemon thread and returns."""

    def __init__(self, endpoint: str, engine: ServingEngine,
                 handler_threads: int = 8,
                 drain_timeout: float = 30.0):
        self.endpoint = endpoint
        self.engine = engine
        self.drain_timeout = float(drain_timeout)
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, int(handler_threads)),
            thread_name_prefix="serve-handler")
        host, port = _parse_ep(endpoint)
        try:
            _obs_tracing.default_worker(f"serve{port}")
        except Exception:
            pass
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self._loop_thread: Optional[threading.Thread] = None
        self._serve_thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def install_signal_handlers(self) -> bool:
        """SIGTERM -> graceful drain (finish in-flight, reject new,
        exit the accept loop). Only possible from the main thread;
        returns False elsewhere so callers can fall back to calling
        ``shutdown()`` themselves."""
        try:
            signal.signal(
                signal.SIGTERM,
                lambda signum, frame: threading.Thread(
                    target=self.shutdown, name="serve-drain",
                    daemon=True).start())
            return True
        except ValueError:
            return False

    def serve(self) -> None:
        """Blocking accept loop; the engine's step loop runs on its own
        thread for the duration."""
        self._loop_thread = threading.Thread(
            target=self.engine.serve_loop, args=(self._stop,),
            name="serve-engine", daemon=True)
        self._loop_thread.start()
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                self._pool.submit(self._handle, conn)
        finally:
            try:
                self._srv.close()
            except OSError:
                pass
            self._pool.shutdown(wait=False)

    def start(self) -> "ServeServer":
        self._serve_thread = threading.Thread(
            target=self.serve, name="serve-accept", daemon=True)
        self._serve_thread.start()
        return self

    def shutdown(self) -> bool:
        """Graceful drain, then stop. Stops the engine loop thread
        FIRST so ``drain`` is the only stepper (two threads calling
        ``step()`` would race on the page tables), then steps every
        in-flight request to retirement. True when fully drained
        within ``drain_timeout``."""
        self._stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
        drained = self.engine.drain(timeout=self.drain_timeout)
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
        return drained

    # -- request handling ----------------------------------------------------

    def _handle(self, conn: socket.socket) -> None:
        try:
            with conn:
                plan = faults.current()
                if plan is not None:
                    plan.on_handle()
                msg = _recv_msg(conn)
                t = msg.get("t") if isinstance(msg, dict) else None
                tctx = msg.pop("tctx", None) \
                    if isinstance(msg, dict) else None
                # the error reply must go out while conn is still open
                # — outside this block the socket is closed and the
                # client would only ever see a dropped connection
                try:
                    with _obs_tracing.server_span(
                            tctx, f"serve.{t}", endpoint=self.endpoint):
                        self._dispatch(conn, t, msg, tctx)
                except (ConnectionError, OSError):
                    raise
                except Exception as exc:
                    _send_msg(conn,
                              {"err": f"{type(exc).__name__}: {exc}"})
        except (ConnectionError, OSError):
            pass

    def _dispatch(self, conn: socket.socket, t, msg,
                  tctx: Optional[dict]) -> None:
        if t == "ping":
            _send_msg(conn, "pong")
        elif t == "gen":
            # the client's trace id (if any) becomes the request's, so
            # admission/prefill/decode/completion spans correlate with
            # the caller's rpc.client span
            trace = tctx.get("trace") if isinstance(tctx, dict) else None
            req = self.engine.submit(
                msg["prompt"],
                max_new_tokens=int(msg.get("max_new_tokens", 8)),
                tenant=str(msg.get("tenant", "default")),
                priority=int(msg.get("priority", 0)),
                deadline_s=msg.get("deadline_s"),
                trace=trace)
            _send_msg(conn, req.result(
                timeout=msg.get("wait_s", 60.0)))
        elif t == "stats":
            eng = self.engine
            _send_msg(conn, {
                "pending": eng.pending(),
                "draining": eng._draining,
                "kv": eng.kv.stats(),
                "occupancy": list(eng.occupancy_history)[-16:],
            })
        elif t == "drain":
            _send_msg(conn, {"drained": self.shutdown()})
        else:
            _send_msg(conn, {"err": f"unknown message {t!r}"})


# -- client helpers ----------------------------------------------------------

def serve_rpc(endpoint: str, msg: dict, timeout: Optional[float] = None):
    """One serving RPC with the stack's full client treatment: trace
    context injection, retries, and the per-endpoint circuit breaker
    (async_ps._rpc)."""
    return _rpc(endpoint, msg, timeout=timeout)


def generate(endpoint: str, prompt: List[int],
             max_new_tokens: int = 8, tenant: str = "default",
             priority: int = 0, deadline_s: Optional[float] = None,
             timeout: Optional[float] = None) -> Dict:
    """Submit one generation request and block for its result dict
    (``{"id", "status", "tokens", "tenant"}``)."""
    return serve_rpc(endpoint, {
        "t": "gen", "prompt": [int(x) for x in prompt],
        "max_new_tokens": int(max_new_tokens), "tenant": tenant,
        "priority": int(priority), "deadline_s": deadline_s,
    }, timeout=timeout)
