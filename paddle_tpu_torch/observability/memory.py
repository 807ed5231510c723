"""Device-memory census: which owner holds the bytes (counterpart of
paddle_tpu/observability/memory.py, the part that serving calls).

Owners register weakly and pay nothing per step: the census pulls from
them when it runs. Two are ported, the serving ones:

* ``kv_cache`` — a PagedKVCache's two page slabs
  (``_census_arrays() -> [(label, tensor)]``);
* ``predictor`` — an AnalysisPredictor's persistables and the static
  tensors of its captured signatures (its ``_census_arrays()``).

Tensors are deduplicated by their storage, so a tensor two owners
claim counts once, for the first. On a card the census reconciles the
tagged bytes against ``torch.cuda.memory_allocated``: what no owner
claims is reported as owner ``orphan`` (a CUDA graph's pool and the
caching allocator's blocks in use), and ``coverage_frac`` says how much
of the allocated bytes the owners explain. On the CPU nothing counts the
live bytes, so the census covers the tagged tensors alone. The
scope, ghost-ring, checkpoint and prefetch owners, the leak sentinel,
the watermark and OOM dumps are not ported (ROADMAP.md A.11).
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Any, Dict, Iterator, Tuple

import torch

from . import metrics as _metrics

__all__ = ["track_kv_cache", "track_predictor", "census", "last_census"]

_LOCK = threading.Lock()
_KV_CACHES: "weakref.WeakSet" = weakref.WeakSet()
_PREDICTORS: "weakref.WeakSet" = weakref.WeakSet()
_LAST = [None]
_OWNERS_SEEN: set = set()


def track_kv_cache(cache) -> None:
    """Tag a serving PagedKVCache's page slabs as owner ``kv_cache``."""
    with _LOCK:
        _KV_CACHES.add(cache)


def track_predictor(pred) -> None:
    """Tag an AnalysisPredictor's device tensors as owner
    ``predictor``."""
    with _LOCK:
        _PREDICTORS.add(pred)


def _iter_owned() -> Iterator[Tuple[str, str, Any]]:
    with _LOCK:
        caches, preds = list(_KV_CACHES), list(_PREDICTORS)
    for kv in caches:
        for label, t in kv._census_arrays():
            yield "kv_cache", str(label), t
    for pred in preds:
        for label, t in pred._census_arrays():
            yield "predictor", str(label), t


def census(top_n: int = 8) -> Dict[str, Any]:
    """Walk the registered owners, count each storage once, reconcile
    with the allocator of each card the tensors lie on, set the
    ``pt_hbm_owner_bytes{owner}`` and ``pt_hbm_live_bytes`` gauges and
    return owners, top buffers, orphan bytes and coverage."""
    t0 = time.perf_counter()
    owners: Dict[str, Dict[str, int]] = {}
    seen = set()
    devices = set()
    buffers = []
    for owner, label, t in _iter_owned():
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            continue
        key = (str(t.device), t.untyped_storage().data_ptr())
        if key in seen:
            continue
        seen.add(key)
        nb = t.untyped_storage().nbytes()
        rec = owners.setdefault(owner, {"bytes": 0, "count": 0})
        rec["bytes"] += nb
        rec["count"] += 1
        if t.device.type == "cuda":
            devices.add(t.device)
        buffers.append({"owner": owner, "label": label, "bytes": nb,
                        "shape": list(t.shape), "dtype": str(t.dtype)[6:],
                        "device": str(t.device)})
    tagged = sum(r["bytes"] for r in owners.values())
    tagged_cuda = sum(b["bytes"] for b in buffers
                      if b["device"].startswith("cuda"))
    live = tagged - tagged_cuda + sum(torch.cuda.memory_allocated(d)
                                      for d in devices)
    orphan = max(0, live - tagged)
    if orphan:
        owners["orphan"] = {"bytes": orphan, "count": 0}
    buffers.sort(key=lambda b: b["bytes"], reverse=True)
    out = {"t": time.time(), "owners": owners, "tagged_bytes": tagged,
           "live_bytes": live, "orphan_bytes": orphan,
           "coverage_frac": (live - orphan) / live if live else 1.0,
           "top_buffers": buffers[:max(0, int(top_n))],
           "census_ms": (time.perf_counter() - t0) * 1e3}
    g = _metrics.gauge("pt_hbm_owner_bytes")
    for owner in _OWNERS_SEEN - set(owners):
        g.set(0.0, owner=owner)      # an owner that went away reads 0
    for owner, rec in owners.items():
        g.set(float(rec["bytes"]), owner=owner)
    _OWNERS_SEEN.update(owners)
    _metrics.gauge("pt_hbm_live_bytes").set(float(live))
    _LAST[0] = out
    return out


def last_census():
    return _LAST[0]
