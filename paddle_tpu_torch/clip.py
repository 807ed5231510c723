"""Gradient clipping (counterpart of paddle_tpu/clip.py: the reference's
GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
ErrorClipByValue, set_gradient_clip and append_gradient_clip_ops).

A clip set by set_gradient_clip applies to every (param, grad) pair that
Optimizer.apply_gradients passes; without one, each parameter's own
ParamAttr(gradient_clip=...) applies to its gradient. The ops are the
JAX package's, in its order: GradientClipByGlobalNorm appends a
squared_l2_norm a gradient, sums, sqrt, fill_constant(clip_norm),
elementwise_max, elementwise_div, then an elementwise_mul a gradient.
As in the JAX package, the clip set is one module-wide setting, and
ErrorClipByValue only holds its bounds."""
from __future__ import annotations

from . import layers
from .layer_helper import LayerHelper

__all__ = ["GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm", "ErrorClipByValue",
           "set_gradient_clip", "append_gradient_clip_ops"]

_clip_attr = [None]


class BaseGradientClipAttr:
    def _process(self, params_grads):
        raise NotImplementedError


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    """Each gradient clipped elementwise to [min, max] (min: -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _process(self, params_grads):
        return [(p, g if g is None else layers.clip(g, self.min, self.max))
                for p, g in params_grads]


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to an L2 norm of at most clip_norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process(self, params_grads):
        return [(p, g if g is None else
                 layers.clip_by_norm(g, self.clip_norm))
                for p, g in params_grads]


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every gradient times clip_norm / max(global_norm, clip_norm),
    global_norm the L2 norm of all of them together."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process(self, params_grads):
        sq_sums = []
        for _, g in params_grads:
            if g is None:
                continue
            helper = LayerHelper("global_norm")
            sq = helper.create_variable_for_type_inference(g.dtype)
            g.block.append_op("squared_l2_norm", inputs={"X": g},
                              outputs={"Out": sq}, infer_shape=False)
            sq_sums.append(sq)
        if not sq_sums:
            return params_grads
        global_norm = layers.sqrt(layers.tensor.sums(sq_sums))
        clip_var = layers.tensor.fill_constant([1], "float32",
                                               self.clip_norm)
        scale = layers.elementwise_div(
            clip_var, layers.elementwise_max(global_norm, clip_var))
        return [(p, g if g is None else layers.elementwise_mul(g, scale))
                for p, g in params_grads]


def set_gradient_clip(clip, param_list=None, program=None):
    """Set (None: clear) the clip of every parameter's gradient."""
    _clip_attr[0] = clip


def append_gradient_clip_ops(params_grads):
    """The clipped (param, grad) pairs: the clip set, else each
    parameter's own gradient_clip_attr; unchanged without either."""
    clip = _clip_attr[0]
    if clip is not None:
        return clip._process(params_grads)
    out = []
    for p, g in params_grads:
        attr = getattr(p, "gradient_clip_attr", None)
        out.append((p, g) if attr is None or g is None
                   else attr._process([(p, g)])[0])
    return out
