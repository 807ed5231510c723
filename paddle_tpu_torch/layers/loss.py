"""Loss layers (counterpart of paddle_tpu/layers/loss.py: cross_entropy,
softmax_with_cross_entropy, sigmoid_cross_entropy_with_logits,
label_smoothed_softmax_xent and square_error_cost)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits",
           "label_smoothed_softmax_xent", "square_error_cost"]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy",
                     inputs={"X": input, "Label": label},
                     outputs={"Y": out},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The loss, and with return_softmax also the softmax. The op always
    computes a numerically stable log-softmax, whatever
    numeric_stable_mode says."""
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        "softmax_with_cross_entropy",
        inputs={"Logits": logits, "Label": label},
        outputs={"Softmax": softmax, "Loss": loss},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "axis": axis})
    if return_softmax:
        return loss, softmax
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        "sigmoid_cross_entropy_with_logits",
        inputs={"X": x, "Label": label}, outputs={"Out": out},
        attrs={"ignore_index": ignore_index, "normalize": normalize})
    return out


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


def square_error_cost(input, label):
    """(input - label)^2, elementwise: an elementwise_sub, then square."""
    helper = LayerHelper("square_error_cost")
    minus_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("elementwise_sub",
                     inputs={"X": input, "Y": label},
                     outputs={"Out": minus_out})
    sq = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("square", inputs={"X": minus_out},
                     outputs={"Out": sq})
    return sq
