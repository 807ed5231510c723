"""Metric layers (counterpart of paddle_tpu/layers/metric_op.py:
accuracy and auc)."""
from __future__ import annotations

from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["accuracy", "auc"]


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


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """The streaming AUC of the positive-class probabilities input[:,
    1]: its stats are two float32 [num_thresholds + 1] parameters (not
    trained) that the auc op updates in place. Returns (auc, auc,
    [stat_pos, stat_neg]), as the JAX package does."""
    helper = LayerHelper("auc")
    stat_pos = helper.create_parameter(
        ParamAttr(initializer=Constant(0.0), trainable=False),
        [num_thresholds + 1], "float32")
    stat_neg = helper.create_parameter(
        ParamAttr(initializer=Constant(0.0), trainable=False),
        [num_thresholds + 1], "float32")
    auc_out = helper.create_variable_for_type_inference("float32", True)
    helper.append_op(
        "auc",
        inputs={"Predict": input, "Label": label, "StatPos": stat_pos,
                "StatNeg": stat_neg},
        outputs={"AUC": auc_out, "StatPosOut": stat_pos,
                 "StatNegOut": stat_neg},
        attrs={"num_thresholds": num_thresholds, "curve": curve})
    return auc_out, auc_out, [stat_pos, stat_neg]
