"""Loss layers (counterpart of paddle_tpu/layers/loss.py:
label_smoothed_softmax_xent)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["label_smoothed_softmax_xent"]


def label_smoothed_softmax_xent(logits, label, epsilon=0.1):
    """Fused one_hot -> label_smooth -> soft-label softmax CE with a
    uniform prior, without the [batch, ..., vocab] one-hot."""
    helper = LayerHelper("label_smoothed_softmax_xent")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "label_smoothed_softmax_xent",
        inputs={"Logits": logits, "Label": label},
        outputs={"Loss": loss},
        attrs={"epsilon": float(epsilon)})
    return loss
