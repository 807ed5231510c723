"""The comm scheduler's planning half (counterpart of the planner in
paddle_tpu/parallel/comm_scheduler.py): parameter gradients grouped into
size-capped, dtype-homogeneous buckets in the order the backward
produces them, last layer first (FLAGS_allreduce_bucket_mb). A bucket's
flat view, its members concatenated in that order, is what
kernels.fused_optimizer.bucket_sweep updates. The collectives, the
CommScheduler and the mesh are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.flags import FLAGS
from ..core.types import dtype_to_np

__all__ = ["GradBucket", "plan_named_buckets", "plan_program_buckets",
           "grad_production_order", "plan_stats",
           "bucket_bytes_from_flags", "should_quantize", "MIN_QUANT_BYTES"]

GRAD_SUFFIX = "@GRAD"

# buckets smaller than this keep their dtype even when a quantized
# all-reduce is asked for (the reference's small-tensor exemption)
MIN_QUANT_BYTES = 64 * 1024


def bucket_bytes_from_flags() -> int:
    """FLAGS_allreduce_bucket_mb as a byte cap; <= 0 disables."""
    try:
        mb = float(FLAGS.allreduce_bucket_mb)
    except (TypeError, ValueError):
        return 0
    return int(mb * 1024 * 1024) if mb > 0 else 0


class GradBucket:
    """One fused-collective unit: an ordered run of same-dtype grads.
    `names` keeps their production order (reverse-backward);
    `last_op_idx` is the index of the block op whose completion makes
    the bucket ready."""

    __slots__ = ("names", "shapes", "dtype", "bytes", "last_op_idx")

    def __init__(self, names, shapes, dtype, nbytes, last_op_idx=-1):
        self.names = tuple(names)
        self.shapes = tuple(tuple(int(d) for d in s) for s in shapes)
        self.dtype = np.dtype(dtype)
        self.bytes = int(nbytes)
        self.last_op_idx = int(last_op_idx)

    @property
    def size(self) -> int:
        return sum(int(np.prod(s)) if s else 1 for s in self.shapes)

    def key(self) -> Tuple:
        """The bucket's identity across shards."""
        return (self.names, self.shapes, str(self.dtype))

    def __repr__(self):
        return (f"GradBucket({len(self.names)} grads, "
                f"{self.bytes} B, dtype={self.dtype}, "
                f"last_op={self.last_op_idx})")


def plan_named_buckets(items: Sequence[Tuple[Any, Sequence[int], Any]],
                       bucket_bytes: int,
                       last_idx: Optional[Dict[Any, int]] = None
                       ) -> List[GradBucket]:
    """Greedy bucketing of ordered (name, shape, dtype) triples:
    consecutive same-dtype entries pack into one bucket until the byte
    cap; a dtype change or a cap overflow seals it. A tensor larger than
    the cap gets a bucket of its own (never split). The same items give
    the same plan on every shard."""
    if bucket_bytes <= 0:
        bucket_bytes = 0
    buckets: List[GradBucket] = []
    cur: List[Tuple[Any, Tuple[int, ...]]] = []
    cur_dtype = None
    cur_bytes = 0

    def seal():
        nonlocal cur, cur_bytes
        if cur:
            lidx = -1
            if last_idx:
                lidx = max(last_idx.get(n, -1) for n, _ in cur)
            buckets.append(GradBucket(
                [n for n, _ in cur], [s for _, s in cur], cur_dtype,
                cur_bytes, lidx))
        cur, cur_bytes = [], 0

    for name, shape, dtype in items:
        dt = np.dtype(dtype)
        shape = tuple(int(d) for d in shape)
        nbytes = int(np.prod(shape)) * dt.itemsize if shape \
            else dt.itemsize
        if cur and (dt != cur_dtype or
                    (bucket_bytes and cur_bytes + nbytes > bucket_bytes)):
            seal()
        if not cur:
            cur_dtype = dt
        cur.append((name, shape))
        cur_bytes += nbytes
        if bucket_bytes and cur_bytes >= bucket_bytes:
            seal()
    seal()
    return buckets


def grad_production_order(program, block_idx: int = 0, param_filter=None
                          ) -> List[Tuple[str, int, Tuple[int, ...], Any]]:
    """(grad name, index of the op that produces it, shape, numpy dtype)
    of every parameter gradient the block produces, ordered by the last
    backward op that writes it (a gradient accumulated from @RENAME@
    parts is keyed on its final write). Shapes and dtypes are the
    parameters'."""
    block = program.block(block_idx)
    params = {p.name: p for p in program.all_parameters()
              if param_filter is None or param_filter(p)}
    produced: Dict[str, int] = {}
    for idx, op in enumerate(block.ops):
        if not (op.attr("op_role", "forward") == "backward" or
                op.type.endswith("_grad")):
            continue
        for slot in op.output_slots():
            for name in op.output(slot):
                if name.endswith(GRAD_SUFFIX) and \
                        name[:-len(GRAD_SUFFIX)] in params:
                    produced[name] = idx  # the last write wins
    out = []
    for name, idx in sorted(produced.items(), key=lambda kv: kv[1]):
        p = params[name[:-len(GRAD_SUFFIX)]]
        out.append((name, idx, tuple(p.shape), dtype_to_np(p.dtype)))
    return out


def plan_program_buckets(program, block_idx: int = 0,
                         bucket_bytes: Optional[int] = None,
                         param_filter=None) -> List[GradBucket]:
    """The bucket plan of a Program's parameter gradients (cap:
    FLAGS_allreduce_bucket_mb unless given)."""
    if bucket_bytes is None:
        bucket_bytes = bucket_bytes_from_flags()
    order = grad_production_order(program, block_idx, param_filter)
    items = [(n, shape, dt) for n, _, shape, dt in order]
    last = {n: idx for n, idx, _, _ in order}
    return plan_named_buckets(items, bucket_bytes, last)


def should_quantize(dtype, nbytes: int, mode: str) -> bool:
    """Whether a bucket's payload would be quantized under `mode`
    ('' off, 'int8', 'bf16'): float buckets of MIN_QUANT_BYTES and
    more."""
    if not mode or nbytes < MIN_QUANT_BYTES:
        return False
    return bool(np.issubdtype(np.dtype(dtype), np.floating))


def plan_stats(buckets: Sequence[GradBucket], last_backward_idx: int = -1,
               quantize_mode: str = "") -> Dict[str, Any]:
    """Total gradient bytes, bucket (fused collective) count, quantized
    buckets, and the share of buckets whose collective could overlap the
    rest of the backward (their last gradient lands before op
    `last_backward_idx`)."""
    n = len(buckets)
    total = sum(b.bytes for b in buckets)
    quant = sum(1 for b in buckets
                if should_quantize(b.dtype, b.bytes, quantize_mode))
    overlap = sum(1 for b in buckets
                  if 0 <= b.last_op_idx < last_backward_idx)
    return {"bytes": total, "buckets": n, "quantized": quant,
            "overlap_frac": (overlap / n) if n else 0.0}
