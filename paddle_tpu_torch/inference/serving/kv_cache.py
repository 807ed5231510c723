"""The paged KV cache of the serving engine (counterpart of
paddle_tpu/inference/serving/kv_cache.py).

Two slabs, one for keys and one for values, each one tensor
``[num_layers, num_pages * page_size, kv_dim]`` on the device, carved
into fixed-size pages that sequences take on demand (the vLLM
PagedAttention layout):

* page table: on the host, ``seq_id -> [page_id, ...]``; token ``t`` of
  a sequence lives at flat slot ``pages[t // page_size] * page_size +
  t % page_size``. Each sequence's slots are worked out once, when its
  pages are allocated;
* page 0 is the scratch page: never allocated, it takes the writes of
  dead batch rows so that every dispatch keeps its shape, and its stale
  contents are masked to -1e30 before the softmax, so they cannot touch
  a live row. Live rows never share a slot; dead rows all write slot
  0, in an order the card leaves open, which no live row reads.

``gather`` builds a decode batch's dense ``[L, B, width, kv_dim]``
cache feeds with one ``index_select`` a slab; ``append`` and
``write_rows`` are one ``index_copy_`` a slab, fed by the slot vector
the host builds. The slabs register with the memory census as owner
``kv_cache`` (observability/memory.py). Eviction is the scheduler's
call; the cache exposes ``free`` / ``can_allocate``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Fixed-size device pages for the serving engine's per-sequence
    key/value history, on `device` (None: the card, as default_place()
    gives it)."""

    def __init__(self, num_layers: int, kv_dim: int, num_pages: int,
                 page_size: int = 16, dtype=torch.float32, device=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        if device is None:
            from ...core.place import default_place
            device = default_place().torch_device()
        self.device = torch.device(device)
        self.num_layers = int(num_layers)
        self.kv_dim = int(kv_dim)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        shape = (self.num_layers, self.num_pages * self.page_size,
                 self.kv_dim)
        self._k = torch.zeros(shape, dtype=dtype, device=self.device)
        self._v = torch.zeros(shape, dtype=dtype, device=self.device)
        # page 0 is the scratch sink for dead rows' writes
        self._free: List[int] = list(range(1, self.num_pages))
        self._tables: Dict[int, List[int]] = {}
        self._slots: Dict[int, np.ndarray] = {}
        self._lens: Dict[int, int] = {}
        from ...observability import memory as _obs_memory
        _obs_memory.track_kv_cache(self)

    # -- accounting ----------------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, -(-int(n_tokens) // self.page_size))

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    def seq_len(self, seq_id: int) -> int:
        return self._lens.get(seq_id, 0)

    def live_seqs(self) -> List[int]:
        return list(self._tables)

    # -- allocation ----------------------------------------------------------

    def allocate(self, seq_id: int, n_tokens: int) -> bool:
        """Reserve pages for `n_tokens` up front (the scheduler admits a
        request only when its prompt and max_new_tokens fit, so decode
        never fails an allocation). False when the free list is short."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        need = self.pages_needed(n_tokens)
        if need > len(self._free):
            return False
        pages = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = pages
        ps = self.page_size
        self._slots[seq_id] = (np.repeat(np.asarray(pages, np.int64) * ps,
                                         ps) + np.tile(np.arange(ps), need))
        self._lens[seq_id] = 0
        return True

    def free(self, seq_id: int) -> int:
        """Return a sequence's pages to the free list; the number
        freed. The slabs keep their stale contents (masked, harmless)."""
        pages = self._tables.pop(seq_id, None)
        self._slots.pop(seq_id, None)
        self._lens.pop(seq_id, None)
        if not pages:
            return 0
        self._free.extend(pages)
        return len(pages)

    # -- slot math -----------------------------------------------------------

    def slot_matrix(self, seq_ids: List[Optional[int]],
                    width: int) -> np.ndarray:
        """``[B, width]`` int64 flat slots for a batch gather: row b
        column t is sequence b's slot of token t, or 0 (the scratch
        page) past its length and for None rows."""
        out = np.zeros((len(seq_ids), width), np.int64)
        for b, sid in enumerate(seq_ids):
            if sid is None or sid not in self._tables:
                continue
            n = min(self._lens[sid], width)
            out[b, :n] = self._slots[sid][:n]
        return out

    def _index(self, slots: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(slots.reshape(-1)).to(self.device,
                                                      non_blocking=True)

    # -- device ops ----------------------------------------------------------

    def gather(self, seq_ids: List[Optional[int]], width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense ``[L, B, width, kv_dim]`` (keys, values) cache feeds
        of a decode batch."""
        idx = self._index(self.slot_matrix(seq_ids, width))
        shape = (self.num_layers, len(seq_ids), width, self.kv_dim)
        return (self._k.index_select(1, idx).view(shape),
                self._v.index_select(1, idx).view(shape))

    def _scatter(self, slots: np.ndarray, k, v) -> None:
        live = slots[slots != 0]
        if len(np.unique(live)) != len(live):
            raise RuntimeError("two live rows write one cache slot")
        idx = self._index(slots)
        self._k.index_copy_(1, idx, torch.as_tensor(k, device=self.device))
        self._v.index_copy_(1, idx, torch.as_tensor(v, device=self.device))

    def append(self, seq_ids: List[Optional[int]], k_new, v_new) -> None:
        """Write one new token's k/v a live row and advance the lengths.
        ``k_new`` / ``v_new``: ``[L, B, kv_dim]`` (dead rows' writes land
        on the scratch page)."""
        slots = np.zeros((len(seq_ids),), np.int64)
        for b, sid in enumerate(seq_ids):
            if sid is None or sid not in self._tables:
                continue
            t = self._lens[sid]
            cap = len(self._slots[sid])
            if t >= cap:
                raise RuntimeError(
                    f"seq {sid} overflowed its {cap}-slot reservation")
            slots[b] = self._slots[sid][t]
        self._scatter(slots, k_new, v_new)
        for sid in seq_ids:
            if sid is not None and sid in self._lens:
                self._lens[sid] += 1

    def write_rows(self, seq_ids: List[Optional[int]], k_rows, v_rows,
                   lens: List[int]) -> None:
        """Prefill's bulk write: ``k_rows`` / ``v_rows`` ``[L, B, S,
        kv_dim]``; row b's first ``lens[b]`` tokens go to sequence b's
        slots, the padded tail to scratch. Sets each length to
        ``lens[b]``."""
        L, B, S, D = k_rows.shape
        idx = np.zeros((B, S), np.int64)
        for b, sid in enumerate(seq_ids):
            if sid is None or sid not in self._tables:
                continue
            n = min(int(lens[b]), S)
            idx[b, :n] = self._slots[sid][:n]
        self._scatter(idx, torch.as_tensor(k_rows).reshape(L, B * S, D),
                      torch.as_tensor(v_rows).reshape(L, B * S, D))
        for b, sid in enumerate(seq_ids):
            if sid is not None and sid in self._lens:
                self._lens[sid] = int(lens[b])

    # -- census contract (observability/memory.py) ---------------------------

    def _census_arrays(self):
        return [("k_pages", self._k), ("v_pages", self._v)]

    def stats(self) -> dict:
        return {"num_pages": self.num_pages,
                "page_size": self.page_size,
                "pages_in_use": self.pages_in_use,
                "pages_free": self.pages_free,
                "live_seqs": len(self._tables),
                "slab_bytes": int(self._k.nbytes + self._v.nbytes)}
