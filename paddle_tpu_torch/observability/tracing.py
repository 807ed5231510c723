"""Spans correlated across threads and processes (counterpart of
paddle_tpu/observability/tracing.py, the part that serving and the RPC
layer call).

* Worker identity: ``PT_WORKER``, else ``trainer<PADDLE_TRAINER_ID>``,
  else ``pid<pid>``; it is part of every trace id and span id.
* Spans: one bounded ring of span dicts (``trace``, ``span``,
  ``parent``, ``name``, ``kind``, ``worker``, ``t0``, ``dur_ms`` and an
  ``ann`` dict). The serving engine records a request's admission,
  prefill, decode steps and completion under the request's trace id;
  the RPC client and server record one span each per call.
* The one-boolean contract: every entry point checks
  ``metrics._HOT[0]`` first, and ``span`` returns a shared no-op
  context manager while it is false, so with telemetry off nothing is
  recorded.
* Propagation: ``current_context()`` is a dict of str values that the
  RPC layer puts in the message header (it must pass the restricted
  unpickler); ``server_span`` parents the server's span under it.

Span dumps land as ``spans_<pid>_<reason>_<seq>.jsonl`` (a header line,
then one span a line) in recorder.default_dir(). The engine's per-step
spans and the fleet skew detection of the JAX module are not ported
(ROADMAP.md A.11).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import recorder as _recorder

__all__ = ["worker_id", "set_worker", "default_worker", "new_span_id",
           "begin_step", "end_step", "current_context", "span",
           "server_span", "record_span", "span_buffer", "spans_snapshot",
           "clear_spans", "dump_spans", "read_span_dump",
           "find_span_dumps"]

_WORKER: List[Optional[str]] = [None]


def worker_id() -> str:
    """This process's identity in the fleet; the same on every thread."""
    if _WORKER[0] is None:
        w = os.environ.get("PT_WORKER")
        if not w:
            tid = os.environ.get("PADDLE_TRAINER_ID")
            w = f"trainer{tid}" if tid not in (None, "") \
                else f"pid{os.getpid()}"
        _WORKER[0] = w
    return _WORKER[0]


def set_worker(name: Optional[str]) -> None:
    _WORKER[0] = str(name) if name else None


def default_worker(name: str) -> None:
    """Set the worker id only if nothing chose one yet (a server labels
    itself without overriding an explicit PT_WORKER)."""
    if _WORKER[0] is None and not os.environ.get("PT_WORKER") \
            and os.environ.get("PADDLE_TRAINER_ID") in (None, ""):
        _WORKER[0] = str(name)


_SEQ = itertools.count(1)


def new_span_id() -> str:
    return f"{worker_id()}.s{next(_SEQ)}"


class SpanBuffer:
    """Fixed-capacity ring of span dicts: appends without a lock (index
    arithmetic under the GIL), a locked snapshot."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._ring: List[Optional[dict]] = [None] * self.capacity
        self._idx = 0
        self._lock = threading.Lock()

    def append(self, rec: dict) -> None:
        self._ring[self._idx % self.capacity] = rec
        self._idx += 1

    def __len__(self) -> int:
        return min(self._idx, self.capacity)

    @property
    def total_appended(self) -> int:
        return self._idx

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._idx = 0

    def snapshot(self) -> List[dict]:
        """The retained spans, oldest first."""
        with self._lock:
            n, i = min(self._idx, self.capacity), self._idx
            return [self._ring[j % self.capacity]
                    for j in range(i - n, i)]


_BUFFER: Optional[SpanBuffer] = None


def span_buffer() -> SpanBuffer:
    """The process's ring, sized by ``PT_TRACE_SPANS`` (4096)."""
    global _BUFFER
    if _BUFFER is None:
        try:
            cap = int(os.environ.get("PT_TRACE_SPANS", "4096") or 4096)
        except ValueError:
            cap = 4096
        _BUFFER = SpanBuffer(cap)
    return _BUFFER


def spans_snapshot() -> List[dict]:
    return span_buffer().snapshot() if _BUFFER is not None else []


def clear_spans() -> None:
    if _BUFFER is not None:
        _BUFFER.clear()


# the trace context of this thread's current step
_TLS = threading.local()


def begin_step(step) -> Optional[str]:
    """Open the trace ``<worker>-<step>`` on this thread: spans and RPCs
    issued until end_step() inherit it. None while tracing is off."""
    if not _metrics._HOT[0]:
        _TLS.ctx = None
        return None
    ctx = {"trace": f"{worker_id()}-{int(step)}", "step": int(step),
           "root": new_span_id(), "stack": []}
    _TLS.ctx = ctx
    return ctx["trace"]


def end_step() -> None:
    _TLS.ctx = None


def _ctx() -> Optional[dict]:
    return getattr(_TLS, "ctx", None)


def current_context() -> Optional[Dict[str, str]]:
    """The context an RPC carries in its header (str values only), or
    None while tracing is off or outside a step."""
    if not _metrics._HOT[0]:
        return None
    ctx = _ctx()
    if ctx is None:
        return None
    parent = ctx["stack"][-1] if ctx["stack"] else ctx["root"]
    return {"trace": ctx["trace"], "span": parent, "worker": worker_id()}


def record_span(name: str, t0: float, dur_ms: float, kind: str = "host",
                trace: Optional[str] = None, span_id: Optional[str] = None,
                parent: Optional[str] = None,
                ann: Optional[dict] = None) -> Optional[dict]:
    """Append one finished span; returns it, or None while tracing is
    off. `trace` and `parent` default to this thread's step context."""
    if not _metrics._HOT[0]:
        return None
    ctx = _ctx()
    if trace is None:
        trace = ctx["trace"] if ctx else f"{worker_id()}-detached"
    if parent is None and ctx is not None:
        parent = ctx["stack"][-1] if ctx["stack"] else ctx["root"]
    rec = {"trace": trace, "span": span_id or new_span_id(),
           "parent": parent, "name": name, "kind": kind,
           "worker": worker_id(), "t0": round(float(t0), 6),
           "dur_ms": round(float(dur_ms), 3)}
    if ann:
        rec["ann"] = {k: v for k, v in ann.items() if v is not None}
    span_buffer().append(rec)
    _metrics.counter("pt_spans_recorded_total").inc(kind=kind)
    return rec


class _NoopSpan:
    """The shared context manager that span() gives while tracing is
    off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kw):
        return self


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "kind", "ann", "sid", "t0", "_pushed")

    def __init__(self, name: str, kind: str, ann: dict):
        self.name = name
        self.kind = kind
        self.ann = ann
        self.sid = new_span_id()
        self.t0 = 0.0
        self._pushed = False

    def annotate(self, **kw):
        self.ann.update(kw)
        return self

    def __enter__(self):
        self.t0 = time.time()
        ctx = _ctx()
        if ctx is not None:
            ctx["stack"].append(self.sid)
            self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb):
        ctx = _ctx()
        if self._pushed and ctx is not None and ctx["stack"] \
                and ctx["stack"][-1] == self.sid:
            ctx["stack"].pop()
        if exc_type is not None:
            self.ann.setdefault("error", exc_type.__name__)
        record_span(self.name, self.t0, (time.time() - self.t0) * 1e3,
                    kind=self.kind, span_id=self.sid, ann=self.ann)
        return False


def span(name: str, kind: str = "host", **ann):
    """``with span("prefill", kind="serve"): ...``; a no-op while
    tracing is off."""
    if not _metrics._HOT[0]:
        return _NOOP
    return _Span(name, kind, ann)


class _ServerSpan:
    """A server's span under a received context: its parent is the
    client's span id, and this thread's own context is left alone."""

    __slots__ = ("name", "kind", "ann", "trace", "parent", "t0")

    def __init__(self, tctx: dict, name: str, kind: str, ann: dict):
        self.name = name
        self.kind = kind
        self.ann = dict(ann)
        self.trace = str(tctx.get("trace") or "")
        self.parent = tctx.get("span")
        w = tctx.get("worker")
        if w:
            self.ann.setdefault("peer", str(w))
        self.t0 = 0.0

    def annotate(self, **kw):
        self.ann.update(kw)
        return self

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.ann.setdefault("error", exc_type.__name__)
        record_span(self.name, self.t0, (time.time() - self.t0) * 1e3,
                    kind=self.kind, trace=self.trace or None,
                    parent=self.parent, ann=self.ann)
        return False


def server_span(tctx: Optional[dict], name: str, kind: str = "rpc.server",
                **ann):
    """A span under a received context (a local span when the message
    carried none); a no-op while tracing is off."""
    if not _metrics._HOT[0]:
        return _NOOP
    if not isinstance(tctx, dict):
        return _Span(name, kind, ann)
    return _ServerSpan(tctx, name, kind, ann)


_DUMP_SEQ = itertools.count(1)


def dump_spans(reason: str, directory: Optional[str] = None,
               extra: Optional[dict] = None) -> Optional[str]:
    """Write the ring as ``spans_<pid>_<reason>_<seq>.jsonl``; the path,
    or None on an empty ring or a failed write (it never raises)."""
    buf = _BUFFER
    if buf is None or len(buf) == 0:
        return None
    try:
        d = directory or _recorder.default_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"spans_{os.getpid()}_{reason}_{next(_DUMP_SEQ)}.jsonl")
        header = {"kind": "span_header", "version": 1, "reason": reason,
                  "pid": os.getpid(), "worker": worker_id(),
                  "time": time.time(), "spans_retained": len(buf),
                  "spans_total": buf.total_appended}
        if extra:
            header.update(extra)
        with open(path, "w") as f:
            f.write(json.dumps(header, default=repr) + "\n")
            for s in buf.snapshot():
                f.write(json.dumps(s, default=repr) + "\n")
        return path
    except OSError:
        return None


def read_span_dump(path: str) -> Dict:
    """{"header": {...}, "spans": [...]} of one span dump."""
    header, spans = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            if obj.get("kind") == "span_header":
                header = obj
            else:
                spans.append(obj)
    return {"header": header or {}, "spans": spans}


def find_span_dumps(directory: Optional[str] = None) -> List[str]:
    d = directory or _recorder.default_dir()
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, n) for n in os.listdir(d)
                  if n.startswith("spans_") and n.endswith(".jsonl"))
