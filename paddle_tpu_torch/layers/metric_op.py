"""Metric layers (counterpart of paddle_tpu/layers/metric_op.py:
accuracy)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    """top_k of the input, then the share of rows whose label is among
    the k indices (float32 [1])."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int64", True)
    helper.append_op("top_k", inputs={"X": input},
                     outputs={"Out": topk_out, "Indices": topk_indices},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32", True)
    if correct is None:
        correct = helper.create_variable_for_type_inference("int32", True)
    if total is None:
        total = helper.create_variable_for_type_inference("int32", True)
    helper.append_op(
        "accuracy",
        inputs={"Out": topk_out, "Indices": topk_indices, "Label": label},
        outputs={"Accuracy": acc_out, "Correct": correct, "Total": total})
    return acc_out
