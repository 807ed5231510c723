"""Weight regularization (counterpart of paddle_tpu/regularizer.py):
L1Decay and L2Decay, and the pass Optimizer.apply_gradients calls. A
parameter's own regularizer (ParamAttr(regularizer=...)) takes precedence
over the optimizer's `regularization`; the decay term, coeff*param (L2)
or coeff*sign(param) (L1), is added to the gradient by a `sum` op, which
the update then reads. Dygraph mode applies none, as in the JAX
package."""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer",
           "L2DecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """The term regularization_coeff * param (a `scale` op)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("scale", inputs={"X": param},
                        outputs={"Out": decay},
                        attrs={"scale": self._coeff}, infer_shape=False)
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """The term regularization_coeff * sign(param) (`sign`, `scale`)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("sign", inputs={"X": param},
                        outputs={"Out": sign}, infer_shape=False)
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("scale", inputs={"X": sign},
                        outputs={"Out": decay},
                        attrs={"scale": self._coeff}, infer_shape=False)
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """(param, grad + its decay term) for each pair whose parameter or
    optimizer has a regularizer; the other pairs unchanged."""
    params_and_grads = []
    helper = LayerHelper("regularization")
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None:
            params_and_grads.append((param, grad))
            continue
        term = reg(param, grad, grad.block)
        new_grad = helper.create_variable_for_type_inference(grad.dtype)
        grad.block.append_op(
            "sum", inputs={"X": [grad, term]},
            outputs={"Out": new_grad}, infer_shape=False)
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
