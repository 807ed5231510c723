"""Loss layers (counterpart of paddle_tpu/layers/loss.py: cross_entropy,
softmax_with_cross_entropy, sigmoid_cross_entropy_with_logits,
label_smoothed_softmax_xent, square_error_cost, mse_loss, log_loss,
huber_loss, kldiv_loss, smooth_l1, margin_rank_loss, rank_loss,
hinge_loss, bpr_loss, linear_chain_crf and crf_decoding)."""
from __future__ import annotations

import warnings

from ..layer_helper import LayerHelper

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "sigmoid_cross_entropy_with_logits",
           "label_smoothed_softmax_xent", "square_error_cost", "mse_loss",
           "log_loss", "huber_loss", "kldiv_loss", "smooth_l1",
           "margin_rank_loss", "rank_loss", "hinge_loss", "bpr_loss",
           "linear_chain_crf", "crf_decoding"]


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


def mse_loss(input, label):
    from .nn import reduce_mean
    return reduce_mean(square_error_cost(input, label))


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("log_loss",
                     inputs={"Predicted": input, "Labels": label},
                     outputs={"Loss": out}, attrs={"epsilon": epsilon})
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(input.dtype)
    residual = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op("huber_loss", inputs={"X": input, "Y": label},
                     outputs={"Out": out, "Residual": residual},
                     attrs={"delta": float(delta)})
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("kldiv_loss", inputs={"X": x, "Target": target},
                     outputs={"Loss": out},
                     attrs={"reduction": reduction})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    inputs = {"X": x, "Y": y}
    if inside_weight is not None:
        inputs["InsideWeight"] = inside_weight
    if outside_weight is not None:
        inputs["OutsideWeight"] = outside_weight
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Out": out, "Diff": diff},
                     attrs={"sigma": sigma or 1.0})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype, True)
    helper.append_op("margin_rank_loss",
                     inputs={"Label": label, "X1": left, "X2": right},
                     outputs={"Out": out, "Activated": act},
                     attrs={"margin": float(margin)})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op("rank_loss",
                     inputs={"Label": label, "Left": left,
                             "Right": right},
                     outputs={"Out": out})
    return out


def hinge_loss(input, label, name=None):
    helper = LayerHelper("hinge_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("hinge_loss",
                     inputs={"Logits": input, "Labels": label},
                     outputs={"Loss": out})
    return out


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("bpr_loss", inputs={"X": input, "Label": label},
                     outputs={"Y": out})
    return out


def linear_chain_crf(input, label, param_attr=None):
    """The linear-chain CRF's negative log-likelihood, one row a sequence
    (ops/nlp.py); creates the transition parameter [n_tags+2, n_tags]
    (rows 0 and 1: start and stop)."""
    helper = LayerHelper("linear_chain_crf")
    size = input.shape[-1]
    transition = helper.create_parameter(
        param_attr, [size + 2, size], input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    em_exps = helper.create_variable_for_type_inference(input.dtype)
    tr_exps = helper.create_variable_for_type_inference(input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "linear_chain_crf",
        inputs={"Emission": input, "Transition": transition,
                "Label": label},
        outputs={"Alpha": alpha, "EmissionExps": em_exps,
                 "TransitionExps": tr_exps, "LogLikelihood": ll},
        infer_shape=False)
    return ll


def crf_decoding(input, param_attr, label=None):
    """Viterbi decoding with the CRF's transition parameter; with
    `label`, 1 where the path's tag is the label's, else 0."""
    helper = LayerHelper("crf_decoding")
    block = helper.main_program.global_block()
    if param_attr.name and \
            block._find_var_recursive(param_attr.name) is not None:
        transition = block.var(param_attr.name)
    else:
        # a decode program built on its own: the parameter is declared
        # here, and its trained value must already be in the scope
        warnings.warn(
            f"crf_decoding: transition parameter "
            f"{param_attr.name!r} not found in this program; declaring "
            f"it — its value must already exist in the scope")
        size = input.shape[-1]
        transition = helper.create_parameter(
            param_attr, [size + 2, size], input.dtype)
    path = helper.create_variable_for_type_inference("int32")
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    helper.append_op("crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": path}, infer_shape=False)
    return path
