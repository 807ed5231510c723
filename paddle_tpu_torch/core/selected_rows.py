"""SelectedRows: the sparse row-slice gradient value.

Counterpart of paddle_tpu/core/selected_rows.py, with its design: the
number of looked-up ids a step is static (batch x slots), so a
SelectedRows is two tensors of fixed length and a height:

  rows   [n]     int64 row indices; duplicates allowed; an index equal
                 to `height` marks a parked slot (a padding_idx row,
                 merge slack) that no update may touch
  values [n, d]  the gradient slices of those rows

It is a plain class, not torch.sparse_coo_tensor: coalescing one syncs
the host and its duplicate semantics differ. Nothing here reads a value
back to the host: the merge sorts and segment-sums at the same static
length, as the JAX package does.

JAX gathers with mode="fill" and scatters with mode="drop", so a parked
index reads zero and writes nothing. torch has neither, and on the card
an index equal to `height` fires a device-side assert. So no index that
reaches a torch kernel here is out of range: `parked_to_row0` sends a
parked slot to row 0 with a value of -0.0, which adds nothing (x + -0.0
is x for every x, signed zeros included).
"""
from __future__ import annotations

import torch


class SelectedRows:
    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def astype(self, dtype):
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    def map_values(self, fn):
        return SelectedRows(self.rows, fn(self.values), self.height)

    def to_dense(self):
        """The dense [height, ...] tensor: the slices added at their
        rows (duplicates summed, parked slots dropped)."""
        rows, values = parked_to_row0(self.rows, self.values, self.height)
        out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, rows, values)

    def merged(self) -> "SelectedRows":
        rows, values = merge_rows(self.rows, self.values, self.height)
        return SelectedRows(rows, values, self.height)

    def __repr__(self):
        return (f"SelectedRows(rows={tuple(self.rows.shape)}, "
                f"values={tuple(self.values.shape)}, "
                f"height={self.height})")


def parked_to_row0(rows, values, height):
    """(rows, values) with each parked slot (row == height) sent to row
    0 with a value of -0.0: an index_add_ of the result adds what the
    JAX package's drop-mode scatter adds, and reads no index out of
    range."""
    parked = rows == height
    mask = parked.reshape((-1,) + (1,) * (values.ndim - 1))
    return (rows.masked_fill(parked, 0),
            values.masked_fill(mask, -0.0))


def merge_rows(rows, values, height):
    """Duplicate rows summed into one slot each, at the same static
    length: a stable sort of the rows, a segment sum over runs of equal
    rows, and every slot past the last segment parked at `height` (a
    parked row sorts last and stays parked as its segment's row)."""
    n = rows.shape[0]
    if n == 0:
        return rows, values
    order = torch.argsort(rows, stable=True)
    r = rows.index_select(0, order)
    v = values.index_select(0, order)
    first = torch.ones_like(r, dtype=torch.bool)
    first[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(first, 0) - 1                 # [n] segment index
    merged_values = torch.zeros_like(v).index_add_(0, seg, v)
    # every slot of a segment writes the segment's row: equal values
    merged_rows = torch.full_like(r, height).scatter_(0, seg, r)
    return merged_rows, merged_values


def is_selected_rows(v) -> bool:
    return isinstance(v, SelectedRows)


def maybe_to_dense(v):
    return v.to_dense() if isinstance(v, SelectedRows) else v
