"""Metric ops (counterpart of paddle_tpu/ops/metrics.py: accuracy)."""
from __future__ import annotations

import torch

from ..core.registry import register_no_grad_op


@register_no_grad_op("accuracy")
def accuracy(ctx):
    """Share of rows whose label is among their top-k Indices: Accuracy
    float32 [1], Correct and Total int32 scalars."""
    indices = ctx.input("Indices")
    lbl = ctx.input("Label").long()
    if not (lbl.ndim == 2 and lbl.shape[-1] == 1):
        lbl = lbl[:, None]
    correct = (indices == lbl).any(dim=-1).float().sum()
    n = indices.shape[0]
    ctx.set_output("Correct", correct.to(torch.int32))
    # a fill on the device, not a copy from the host (a CUDA graph
    # captures no host-to-card copy)
    ctx.set_output("Total", torch.full((), n, dtype=torch.int32,
                                       device=indices.device))
    ctx.set_output("Accuracy", (correct / n).reshape(1))
