"""Deterministic fault injection (counterpart of
paddle_tpu/distributed/faults.py, the part that serving and its RPC
framing honour).

A `FaultPlan` is a process-local, seeded source of injected faults:

* ``connect_refuse`` — probability an outgoing connection is refused
  before the socket opens (a dead or partitioned peer);
* ``drop`` — probability a send aborts mid-message (both ends see the
  failure);
* ``truncate`` — probability a send delivers a prefix and closes (the
  sender "succeeds", the receiver sees a short stream);
* ``delay`` — probability a server sleeps ``delay_s`` before handling a
  request;
* ``serve_kill_decode`` — the serving engine's model runner dies at
  decode dispatch N, at most ``serve_kill_attempts`` times: the engine
  must contain it to the in-flight batch and keep serving.

One ``random.Random(seed)`` stream, consumed in hook-call order, so two
runs of the same plan over the same operations inject the same faults.
``FaultPlan.from_spec("seed=7,serve_kill_decode=3")`` or the
``PT_FAULT_PLAN`` environment variable (installed when this module is
imported) configure it; ``install`` / ``current`` / ``scoped`` manage
the active plan, and the hooks are no-ops without one. The JAX
package's training faults (kill_at_step, nan, grad_spike, bitflip_step,
device_loss_step, data_dup_step) belong to the engine loop and the
stability guard, which are not ported (ROADMAP.md A.9): a spec naming
one raises rather than injecting nothing.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

__all__ = ["FaultPlan", "install", "current", "uninstall", "scoped"]

_lock = threading.Lock()
_active: Optional["FaultPlan"] = None

_FLOAT_KEYS = ("connect_refuse", "drop", "truncate", "delay", "delay_s")
_INT_KEYS = ("seed", "serve_kill_decode", "serve_kill_attempts")
# keys of the JAX package's plan whose hooks are not ported
_UNPORTED_KEYS = ("kill_at_step", "kill_attempts", "nan", "grad_spike",
                  "spike_mag", "bitflip_step", "bitflip_bit",
                  "bitflip_param", "data_dup_step", "device_loss_step",
                  "device_loss_attempts")


class FaultPlan:
    """Seeded, deterministic fault decisions; thread-safe counters."""

    def __init__(self, seed: int = 0, connect_refuse: float = 0.0,
                 drop: float = 0.0, truncate: float = 0.0,
                 delay: float = 0.0, delay_s: float = 0.05,
                 serve_kill_decode: Optional[int] = None,
                 serve_kill_attempts: int = 1):
        self.seed = int(seed)
        self.connect_refuse = float(connect_refuse)
        self.drop = float(drop)
        self.truncate = float(truncate)
        self.delay = float(delay)
        self.delay_s = float(delay_s)
        self.serve_kill_decode = (None if serve_kill_decode is None
                                  else int(serve_kill_decode))
        self.serve_kill_attempts = int(serve_kill_attempts)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {
            "connect_refuse": 0, "drop": 0, "truncate": 0, "delay": 0,
            "serve_kill": 0}

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse ``"seed=7,connect_refuse=0.1,serve_kill_decode=3"``. An
        unknown key raises: a typo that injected nothing would make a
        chaos run vacuous."""
        kw = {}
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            k, _, v = item.partition("=")
            k = k.strip()
            if k in _INT_KEYS:
                kw[k] = int(v)
            elif k in _FLOAT_KEYS:
                kw[k] = float(v)
            elif k in _UNPORTED_KEYS:
                raise NotImplementedError(
                    f"fault-plan key {k!r} in {spec!r}: its hook belongs "
                    f"to the training loop, which paddle_tpu_torch does "
                    f"not inject into yet (ROADMAP.md A.9)")
            else:
                raise ValueError(
                    f"unknown fault-plan key {k!r} in {spec!r}; known: "
                    f"{sorted(_INT_KEYS + _FLOAT_KEYS)}")
        return cls(**kw)

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        """The plan ``PT_FAULT_PLAN`` names, or None."""
        spec = os.environ.get("PT_FAULT_PLAN", "").strip()
        return cls.from_spec(spec) if spec else None

    def _roll(self, prob: float) -> bool:
        # one draw a decision, whatever the probability, so the stream
        # stays aligned across plans
        with self._lock:
            u = self._rng.random()
        return u < prob

    def _count(self, key: str) -> None:
        with self._lock:
            self.counts[key] += 1

    # -- transport hooks (async_ps framing) -------------------------------

    def on_connect(self, endpoint: str) -> None:
        """Before an outgoing connection; raises to refuse it."""
        if self._roll(self.connect_refuse):
            self._count("connect_refuse")
            raise ConnectionRefusedError(
                f"fault-injected connection refusal to {endpoint} "
                f"(FaultPlan seed={self.seed})")

    def on_send(self, nbytes: int):
        """Before a send of `nbytes` framed bytes: None (send), ("drop",
        n) (send n bytes, then fail) or ("truncate", n) (send n bytes,
        close, report success)."""
        if self._roll(self.drop):
            self._count("drop")
            with self._lock:
                n = self._rng.randrange(max(1, nbytes))
            return ("drop", n)
        if self._roll(self.truncate):
            self._count("truncate")
            with self._lock:
                n = self._rng.randrange(max(1, nbytes))
            return ("truncate", n)
        return None

    def on_handle(self) -> None:
        """Server side, before handling a request: the injected delay."""
        if self._roll(self.delay):
            self._count("delay")
            time.sleep(self.delay_s)

    # -- serving hook -----------------------------------------------------

    def on_serve_decode(self, decode_step: int) -> bool:
        """True when the serving runner should die at this decode
        dispatch: from index ``serve_kill_decode`` on, at most
        ``serve_kill_attempts`` times. Draws nothing from the stream.
        The process lives on: the serving engine is the supervisor."""
        if self.serve_kill_decode is None:
            return False
        with self._lock:
            if (int(decode_step) >= self.serve_kill_decode
                    and self.counts["serve_kill"]
                    < self.serve_kill_attempts):
                self.counts["serve_kill"] += 1
                return True
        return False


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Make `plan` the process's active plan; returns the previous."""
    global _active
    with _lock:
        prev, _active = _active, plan
    return prev


def uninstall() -> None:
    install(None)


def current() -> Optional[FaultPlan]:
    return _active


class scoped:
    """``with faults.scoped(plan): ...`` installs `plan` for a block."""

    def __init__(self, plan: Optional[FaultPlan]):
        self._plan = plan
        self._prev: Optional[FaultPlan] = None

    def __enter__(self) -> Optional[FaultPlan]:
        self._prev = install(self._plan)
        return self._plan

    def __exit__(self, *exc) -> None:
        install(self._prev)


# the plan PT_FAULT_PLAN names arms every process of a chaos run
_env_plan = FaultPlan.from_env()
if _env_plan is not None:
    install(_env_plan)
