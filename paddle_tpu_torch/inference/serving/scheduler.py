"""The continuous-batching request scheduler (counterpart of
paddle_tpu/inference/serving/scheduler.py).

DynaFlow-style explicit scheduling (PAPERS.md): the schedule is an
inspectable object — an admission queue ordered by (priority, arrival),
plus two phase lists — not ad-hoc dispatch. One ``step()`` of the
engine is:

1. **expire** — queued requests past their deadline retire with status
   ``deadline_expired`` (distinct from quota rejection, acceptance d);
2. **admit** — highest-priority queued requests get their FULL page
   budget (prompt + max_new_tokens) from the paged KV-cache up front,
   so decode never fails an allocation mid-flight; under memory
   pressure a lower-priority running request is *preempted* — pages
   freed, request re-queued for recompute — before the admit fails;
3. **prefill** — admitted requests batch together (padded to the fixed
   batch ``B``, prompt bucket = max over the batch), their prompt KV
   rows scatter into cache pages, and their first token comes from the
   prompt's last-position logits;
4. **decode** — ALL live sequences step together: pages gather into a
   dense bucketed cache feed, one executable produces every sequence's
   next token, finished sequences retire (pages freed) while the rest
   continue — requests JOIN and RETIRE at step granularity, which is
   the whole point of continuous batching.

Every dispatch uses a captured (batch, bucket) signature
(FrozenServingModel.warmup), so a join never plans or captures.
Prefill's first tokens come from each prompt's last-position logits,
picked on the device before the host copy (FrozenServingModel.
prefill_rows); every argmax is numpy's on the host, with its tie
rule, as in the reference. Failure containment: an injected runner
death mid-decode (``PT_FAULT_PLAN`` ``serve_kill_decode``,
distributed/faults.py) fails ONLY the in-flight batch's requests (status ``failed``), records the
failure on the ``serve:runner`` circuit breaker, and the engine keeps
serving queued and new requests — the breaker fast-fails dispatch while
open, so a persistently-dying runner degrades to rejection, not a
crash loop.
"""
from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from .export import (FrozenServingModel, bucket_for, decode_feeds,
                     prefill_feeds)
from .kv_cache import PagedKVCache

__all__ = ["Request", "TenantQuota", "ServingEngine", "RunnerKilled",
           "STATUS_OK", "STATUS_DEADLINE", "STATUS_QUOTA",
           "STATUS_FAILED", "STATUS_QUEUE_FULL", "RUNNER_ENDPOINT"]

STATUS_OK = "ok"
STATUS_DEADLINE = "deadline_expired"
STATUS_QUOTA = "quota_exceeded"
STATUS_FAILED = "failed"
STATUS_QUEUE_FULL = "queue_full"

# pseudo-endpoint the decode dispatch is breaker-guarded under
# (distributed/resilience.py endpoint_health)
RUNNER_ENDPOINT = "serve:runner"

# request lifecycle states (terminal state is always request.status)
_QUEUED, _ADMITTED, _RUNNING, _DONE = range(4)


class RunnerKilled(RuntimeError):
    """The model runner died mid-dispatch (real crash or an injected
    ``serve_kill_decode`` fault)."""


class Request:
    """One generation request; ``done.wait()`` then read ``status`` +
    ``tokens``."""

    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt: List[int], max_new_tokens: int,
                 tenant: str, priority: int,
                 deadline: Optional[float], now: float,
                 trace: Optional[str] = None):
        with Request._ids_lock:
            self.id = next(Request._ids)
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline = deadline          # absolute engine-clock time
        self.submitted_at = now
        self.admitted_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.tokens: List[int] = []
        self.status: Optional[str] = None  # terminal only
        self.state = _QUEUED
        self.preemptions = 0
        self.done = threading.Event()
        from ...observability import tracing as _tr
        # a client-supplied trace id (RPC tctx) wins, so one id follows
        # the request admission -> prefill -> decode -> completion even
        # across the wire (observability/tracing.py)
        self.trace = trace or f"{_tr.worker_id()}-req{self.id}"

    @property
    def total_budget(self) -> int:
        """Max tokens this request can ever hold in cache."""
        return len(self.prompt) + self.max_new_tokens

    def result(self, timeout: Optional[float] = None) -> dict:
        self.done.wait(timeout)
        return {"id": self.id, "status": self.status,
                "tokens": list(self.tokens), "tenant": self.tenant}


class TenantQuota:
    """Per-tenant admission policy: ``max_concurrent`` in-flight
    requests (excess waits in the queue — backpressure, not an error)
    and a hard ``token_budget`` (prompt + max_new_tokens charged at
    submit; exhaustion REJECTS with ``quota_exceeded``). Requests that
    end in any non-``ok`` terminal status — deadline-expired, runner
    failure — are refunded, so only completed work consumes budget."""

    def __init__(self, max_concurrent: int = 8,
                 token_budget: Optional[int] = None):
        self.max_concurrent = int(max_concurrent)
        self.token_budget = token_budget
        self.used_tokens = 0


class ServingEngine:
    """Continuous-batching scheduler over a FrozenServingModel and a
    PagedKVCache. Thread-safe ``submit``; ``step()`` runs one schedule
    iteration (call from a single loop thread — ``serve_loop``)."""

    def __init__(self, model: FrozenServingModel,
                 kv: Optional[PagedKVCache] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 max_queue: int = 64,
                 clock=time.monotonic):
        """`kv` None: a cache on the model's device with pages for a
        full batch of max-context sequences (page 16)."""
        self.model = model
        bk = model.buckets
        if kv is None:
            # default capacity: enough pages for a full batch of
            # max-context sequences, page = 16 slots
            page = 16
            pages = bk.batch * (-(-bk.max_context // page)) + 1
            kv = PagedKVCache(model.num_layers, model.hidden,
                              num_pages=pages + 1, page_size=page,
                              device=model.device)
        self.kv = kv
        self.quotas = dict(quotas or {})
        self.default_quota = TenantQuota()
        self.max_queue = int(max_queue)
        self.clock = clock
        self._lock = threading.Lock()
        self._queue: List[Request] = []      # waiting for admission
        self._admitted: List[Request] = []   # pages held, no prefill yet
        self._running: List[Request] = []    # decoding
        self._draining = False
        self._decode_dispatches = 0
        # bounded: the stats RPC reads a short tail and serve_bench a
        # whole run's worth; unbounded growth would leak on a
        # long-running server
        self.occupancy_history: Deque[int] = deque(maxlen=4096)
        self._win_tokens = 0
        self._win_t0 = clock()
        from ...observability import metrics as _m
        from ...observability import tracing as _tr
        self._m, self._tr = _m, _tr

    # -- submission (any thread) --------------------------------------------

    def _quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def submit(self, prompt: List[int], max_new_tokens: int = 8,
               tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None,
               trace: Optional[str] = None) -> Request:
        now = self.clock()
        req = Request(prompt, max_new_tokens, tenant, priority,
                      None if deadline_s is None else now + deadline_s,
                      now, trace=trace)
        # bucket_for raises past the largest declared signature, so
        # admission must reject BOTH overlong prompts (prefill bucket)
        # and overlong total budgets (cache bucket) up front — an
        # accepted request must never make a phase raise mid-step
        bk = self.model.buckets
        if len(req.prompt) > bk.prefill_lens[-1] or \
                req.total_budget > bk.max_context:
            return self._reject(req, STATUS_QUEUE_FULL, "too_long")
        with self._lock:
            if self._draining or len(self._queue) >= self.max_queue:
                return self._reject(req, STATUS_QUEUE_FULL,
                                    "queue_full")
            q = self._quota(tenant)
            if q.token_budget is not None and \
                    q.used_tokens + req.total_budget > q.token_budget:
                return self._reject(req, STATUS_QUOTA, "quota")
            q.used_tokens += req.total_budget
            self._queue.append(req)
            self._m.gauge("pt_serve_queue_depth").set(
                len(self._queue))
        return req

    def _reject(self, req: Request, status: str, reason: str
                ) -> Request:
        req.status = status
        req.finished_at = self.clock()
        req.state = _DONE
        self._m.counter("pt_serve_rejections_total").inc(
            1.0, reason=reason)
        self._m.counter("pt_serve_requests_total").inc(
            1.0, status=status)
        req.done.set()
        return req

    # -- retirement (step thread) -------------------------------------------

    def _retire(self, req: Request, status: str) -> None:
        self.kv.free(req.id)
        req.status = status
        req.finished_at = self.clock()
        req.state = _DONE
        if status != STATUS_OK:
            # the budget charged at submit bought no completed work —
            # refund it so a failing/expiring tenant isn't permanently
            # locked out of its token_budget
            with self._lock:
                q = self._quota(req.tenant)
                q.used_tokens = max(0, q.used_tokens - req.total_budget)
        wall = req.finished_at - req.submitted_at
        m = self._m
        m.counter("pt_serve_requests_total").inc(1.0, status=status)
        m.histogram("pt_serve_request_seconds").observe(wall)
        m.gauge("pt_serve_kv_pages_in_use").set(self.kv.pages_in_use)
        self._tr.record_span(
            "serve.complete", time.time() - wall, wall * 1e3,
            kind="serve", trace=req.trace,
            ann={"status": status, "tenant": req.tenant,
                 "tokens": len(req.tokens)})
        req.done.set()

    # -- one schedule iteration ---------------------------------------------

    def step(self) -> bool:
        """Expire -> admit -> prefill -> decode. Returns True when any
        phase did work (the serve loop sleeps when idle)."""
        did = False
        now = self.clock()
        with self._lock:
            queue = list(self._queue)
        # 1. deadline expiry (queued requests only; running requests
        #    are checked at their own decode step)
        for req in queue:
            if req.deadline is not None and now > req.deadline:
                with self._lock:
                    if req in self._queue:
                        self._queue.remove(req)
                self._retire(req, STATUS_DEADLINE)
                did = True
        did = self._admit() or did
        did = self._prefill_phase() or did
        did = self._decode_phase() or did
        m = self._m
        with self._lock:
            m.gauge("pt_serve_queue_depth").set(len(self._queue))
        m.gauge("pt_serve_kv_pages_in_use").set(self.kv.pages_in_use)
        dt = self.clock() - self._win_t0
        if dt >= 0.5:
            m.gauge("pt_serve_tokens_per_second").set(
                self._win_tokens / dt)
            self._win_tokens, self._win_t0 = 0, self.clock()
        return did

    # -- admission ----------------------------------------------------------

    def _concurrency(self, tenant: str) -> int:
        return sum(1 for r in self._admitted + self._running
                   if r.tenant == tenant)

    def _admit(self) -> bool:
        did = False
        while True:
            with self._lock:
                order = sorted(
                    self._queue,
                    key=lambda r: (-r.priority, r.submitted_at))
                # SKIP (not stall on) requests whose tenant is at its
                # concurrency cap: one saturated tenant backpressures
                # only itself, never other tenants' queued work
                req = next(
                    (r for r in order
                     if self._concurrency(r.tenant) <
                     self._quota(r.tenant).max_concurrent), None)
            if req is None:
                return did       # empty, or every tenant at its cap
            if not self.kv.can_allocate(req.total_budget) and \
                    not self._preempt_for(req):
                return did       # memory pressure, stays queued
            if not self.kv.allocate(req.id, req.total_budget):
                return did
            with self._lock:
                self._queue.remove(req)
                self._admitted.append(req)
            req.admitted_at = self.clock()
            req.state = _ADMITTED
            wait = req.admitted_at - req.submitted_at
            self._tr.record_span(
                "serve.admission", time.time() - wait, wait * 1e3,
                kind="serve", trace=req.trace,
                ann={"tenant": req.tenant,
                     "priority": req.priority})
            did = True

    def _preempt_for(self, req: Request) -> bool:
        """Memory pressure: evict the lowest-priority running/admitted
        request strictly below ``req``'s priority. The victim's pages
        free, its generated tokens reset, and it re-queues for
        recompute (re-prefill regenerates the same tokens — greedy
        decode is deterministic, so preemption costs latency, never
        correctness)."""
        with self._lock:
            victims = sorted(
                (r for r in self._admitted + self._running
                 if r.priority < req.priority),
                key=lambda r: (r.priority, -r.submitted_at))
            if not victims:
                return False
            v = victims[0]
            if v in self._running:
                self._running.remove(v)
            if v in self._admitted:
                self._admitted.remove(v)
            v.tokens = []
            v.state = _QUEUED
            v.preemptions += 1
            self._queue.append(v)
        self.kv.free(v.id)
        self._m.counter("pt_serve_kv_evictions_total").inc()
        return True

    # -- prefill phase ------------------------------------------------------

    def _prefill_phase(self) -> bool:
        with self._lock:
            batch = self._admitted[:self.model.buckets.batch]
        if not batch:
            return False
        B = self.model.buckets.batch
        Sp = max(bucket_for(len(r.prompt),
                            self.model.buckets.prefill_lens)
                 for r in batch)
        t0 = time.perf_counter()
        tokens, pos, mask = prefill_feeds(
            [r.prompt for r in batch], Sp, B)
        rows = [len(r.prompt) - 1 for r in batch] + [0] * (B - len(batch))
        try:
            logits, k, v = self._dispatch(
                "prefill", self.model.prefill_rows, tokens, pos, mask,
                rows)
        except RunnerKilled:
            self._fail_batch(batch, self._admitted)
            return True
        seq_ids = [r.id for r in batch] + [None] * (B - len(batch))
        self.kv.write_rows(seq_ids, k, v,
                           [len(r.prompt) for r in batch]
                           + [0] * (B - len(batch)))
        dur = (time.perf_counter() - t0) * 1e3
        for b, req in enumerate(batch):
            first = int(np.argmax(logits[b]))
            req.tokens.append(first)
            req.state = _RUNNING
            self._tr.record_span(
                "serve.prefill", time.time() - dur / 1e3, dur,
                kind="serve", trace=req.trace,
                ann={"prompt_len": len(req.prompt), "bucket": Sp,
                     "batch": len(batch)})
        self._note_tokens(batch, 1)
        with self._lock:
            for req in batch:
                self._admitted.remove(req)
                self._running.append(req)
        self._m.gauge("pt_serve_batch_occupancy").set(
            len(batch), phase="prefill")
        return True

    # -- decode phase --------------------------------------------------------

    def _decode_phase(self) -> bool:
        with self._lock:
            live = [r for r in self._running
                    if len(r.tokens) < r.max_new_tokens]
        B = self.model.buckets.batch
        batch = sorted(live, key=lambda r: r.submitted_at)[:B]
        # deadline check at step granularity: an expired request
        # retires with its partial tokens before costing another step
        now = self.clock()
        expired = [r for r in batch
                   if r.deadline is not None and now > r.deadline]
        for r in expired:
            with self._lock:
                self._running.remove(r)
            self._retire(r, STATUS_DEADLINE)
        batch = [r for r in batch if r not in expired]
        if not batch:
            # requests that already hold all their tokens retire here
            self._sweep_finished()
            return bool(expired)
        S = max(bucket_for(self.kv.seq_len(r.id),
                           self.model.buckets.cache_lens)
                for r in batch)
        seq_ids = [r.id for r in batch] + [None] * (B - len(batch))
        lens = [self.kv.seq_len(r.id) for r in batch] \
            + [0] * (B - len(batch))
        last = [r.tokens[-1] for r in batch] \
            + [None] * (B - len(batch))
        token, pos, mask = decode_feeds(last, lens, S, B)
        ck, cv = self.kv.gather(seq_ids, S)
        t0 = time.perf_counter()
        step_idx = self._decode_dispatches
        try:
            logits, k_new, v_new = self._dispatch(
                "decode", self.model.decode, token, pos, mask, ck, cv)
        except RunnerKilled:
            self._fail_batch(batch, self._running)
            return True
        self._decode_dispatches += 1
        self.kv.append(seq_ids, k_new, v_new)
        dur = (time.perf_counter() - t0) * 1e3
        for b, req in enumerate(batch):
            req.tokens.append(int(np.argmax(logits[b])))
            self._tr.record_span(
                "serve.decode_step", time.time() - dur / 1e3, dur,
                kind="serve", trace=req.trace,
                ann={"step": step_idx, "batch": len(batch),
                     "bucket": S})
        self._note_tokens(batch, 1)
        self.occupancy_history.append(len(batch))
        self._m.gauge("pt_serve_batch_occupancy").set(
            len(batch), phase="decode")
        self._sweep_finished()
        return True

    def _sweep_finished(self) -> None:
        with self._lock:
            done = [r for r in self._running
                    if len(r.tokens) >= r.max_new_tokens]
            for r in done:
                self._running.remove(r)
        for r in done:
            self._retire(r, STATUS_OK)

    # -- dispatch under fault plan + circuit breaker -------------------------

    def _dispatch(self, phase, fn, *args):
        from ...distributed import faults
        from ...distributed.resilience import endpoint_health
        br = endpoint_health.get(RUNNER_ENDPOINT)
        if not br.allow():
            raise RunnerKilled(
                f"circuit breaker open for {RUNNER_ENDPOINT}; "
                "fast-failing the batch until the cooldown probe")
        plan = faults.current()
        try:
            if phase == "decode" and plan is not None and \
                    plan.on_serve_decode(self._decode_dispatches):
                raise RunnerKilled(
                    f"fault-injected runner death at decode dispatch "
                    f"{self._decode_dispatches} (serve_kill_decode)")
            out = fn(*args)
        except RunnerKilled:
            br.record_failure()
            raise
        except Exception as exc:
            br.record_failure()
            raise RunnerKilled(
                f"model runner failed during {phase}: "
                f"{type(exc).__name__}: {exc}") from exc
        br.record_success()
        return out

    def _fail_batch(self, batch: List[Request],
                    from_list: List[Request]) -> None:
        """Contain a runner death to the in-flight batch: ONLY these
        requests fail; queued/admitted work and new submissions keep
        flowing (acceptance e)."""
        with self._lock:
            for r in batch:
                if r in from_list:
                    from_list.remove(r)
        for r in batch:
            self._retire(r, STATUS_FAILED)

    def _note_tokens(self, batch: List[Request], n: int) -> None:
        self._win_tokens += n * len(batch)
        c = self._m.counter("pt_serve_tokens_total")
        for r in batch:
            c.inc(n, tenant=r.tenant)

    # -- loop / drain --------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._admitted) \
                + len(self._running)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown: stop admitting new submissions (they
        reject ``queue_full``), keep stepping until every in-flight
        request retires. True when fully drained."""
        with self._lock:
            self._draining = True
        t0 = self.clock()
        while self.pending():
            self.step()
            if timeout is not None and self.clock() - t0 > timeout:
                return False
        return True

    def serve_loop(self, stop: threading.Event,
                   idle_sleep: float = 0.002) -> None:
        """Run ``step()`` until ``stop`` is set; sleeps when idle.

        A ``step()`` exception must not silently kill this thread —
        every in-flight and queued request would hang forever on
        ``done.wait()``. Admission validates everything the phases
        assume, so this is a last-resort containment: warn, back off,
        keep serving."""
        while not stop.is_set():
            try:
                did = self.step()
            except Exception:
                import traceback
                warnings.warn(
                    "ServingEngine.step() raised; engine continues:\n"
                    + traceback.format_exc(), RuntimeWarning)
                self._m.counter("pt_serve_step_errors_total").inc()
                stop.wait(max(idle_sleep, 0.05))
                continue
            if not did:
                stop.wait(idle_sleep)
