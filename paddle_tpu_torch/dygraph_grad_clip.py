"""Dygraph gradient clipping (counterpart of
paddle_tpu/dygraph_grad_clip.py: the reference's GradClipByValue,
GradClipByNorm and GradClipByGlobalNorm). A clip called on parameters
rewrites each one's .grad in place; Optimizer.minimize(grad_clip=clip)
calls it in dygraph mode before the update."""
from __future__ import annotations

import torch

__all__ = ["GradClipByValue", "GradClipByNorm", "GradClipByGlobalNorm"]


def _grad_of(p):
    return getattr(p, "grad", None)


class GradClipBase:
    def __call__(self, params):
        """Clip every parameter's .grad in place; returns params."""
        self._apply([p for p in params if _grad_of(p) is not None])
        return params


class GradClipByValue(GradClipBase):
    def __init__(self, min_value, max_value=None):
        if max_value is None:
            max_value = abs(min_value)
            min_value = -max_value
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def _apply(self, params):
        for p in params:
            p.grad = torch.clamp(p.grad, self.min_value, self.max_value)


class GradClipByNorm(GradClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _apply(self, params):
        for p in params:
            g = p.grad
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            p.grad = g * scale


class GradClipByGlobalNorm(GradClipBase):
    def __init__(self, max_global_norm):
        self.max_global_norm = float(max_global_norm)

    def _apply(self, params):
        grads = [p.grad for p in params]
        if not grads:
            return
        global_sq = sum(torch.sum(torch.square(g)) for g in grads)
        norm = torch.sqrt(global_sq)
        scale = torch.clamp(
            self.max_global_norm / torch.clamp(norm, min=1e-12), max=1.0)
        for p, g in zip(params, grads):
            p.grad = g * scale
