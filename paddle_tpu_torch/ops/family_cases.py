"""One case or more a op type of the basic, reduce, elementwise,
activation and nn op families (ops/basic.py, reduce.py, elementwise.py,
activations.py, nn.py), the nine update ops that have no kernel
(optimizer_ops.py: lars_momentum ... lamb), the conv family
(conv.py), the value-dependent sequence
ops, SSD's detection ops and the one- and two-stage detectors' ops
(detection.py, on LoD inputs), slice 24's nlp, metric and
bilinear ops (nlp.py, metrics.py, misc.py's chunk_eval, matmul.py's
bilinear_tensor_product) and slice 25's fake-quantize and int8 ops
(quantize.py, misc.py's quantize, dequantize, requantize and fsp;
tests/test_torch_quantization.py holds them), on seeded
numpy inputs, and a runner of one op's lowering on a device: the cases
tests/test_torch_op_families.py holds against the JAX package's
lowerings on the CPU and chip_smoke.py's op sweep holds on the card
against the CPU.

A case is (op type, {slot: numpy array or list of them}, attrs,
{output slot: count}, [input slots to differentiate]). Inputs stay away
from the points where a function or its derivative jumps (clip and relu6
bounds, floor and round steps, ties of max and min).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.registry import OPS, ExecContext, _SlotView

__all__ = ["cases", "conv_cases", "sequence_cases", "detection_cases",
           "one_stage_cases", "two_stage_cases", "nlp_cases", "quant_cases",
           "run",
           "run_grad", "nce_numpy", "sample_logits_numpy", "drawn"]


def _f32(rng, *shape, lo=None, hi=None):
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _basic_cases():
    r = np.random.default_rng(0)
    x3 = _f32(r, 2, 3, 4)
    x2 = _f32(r, 5, 4)
    ids = np.array([[3], [0], [4]], np.int64)
    return [
        ("transpose", {"X": x3}, {"axis": [2, 0, 1]}, {"Out": 1}, ["X"]),
        ("transpose2", {"X": x3}, {"axis": [1, 2, 0]},
         {"Out": 1, "XShape": 1}, ["X"]),
        ("reshape", {"X": x3}, {"shape": [0, -1]}, {"Out": 1}, ["X"]),
        ("squeeze", {"X": _f32(r, 3, 1, 4, 1)}, {"axes": [1]}, {"Out": 1},
         ["X"]),
        ("squeeze", {"X": _f32(r, 1, 4, 1)}, {"axes": []}, {"Out": 1},
         ["X"]),
        ("split", {"X": _f32(r, 6, 4)}, {"axis": 0, "num": 3}, {"Out": 3},
         ["X"]),
        ("split", {"X": x3}, {"axis": 2, "sections": [1, 3]}, {"Out": 2},
         ["X"]),
        ("unstack", {"X": x3}, {"axis": 1}, {"Y": 3}, ["X"]),
        ("expand", {"X": _f32(r, 2, 1, 3)}, {"expand_times": [2, 3, 1]},
         {"Out": 1}, ["X"]),
        ("slice", {"Input": x3},
         {"axes": [0, 2], "starts": [-1, 1], "ends": [100, -1]},
         {"Out": 1}, ["Input"]),
        ("slice", {"Input": x3}, {"axes": [1], "starts": [0], "ends": [2]},
         {"Out": 1}, ["Input"]),
        ("strided_slice", {"Input": _f32(r, 7, 5)},
         {"axes": [0, 1], "starts": [1, 4], "ends": [7, 0],
          "strides": [2, -2]}, {"Out": 1}, ["Input"]),
        ("reverse", {"X": x3}, {"axis": [0, 2]}, {"Out": 1}, ["X"]),
        ("pad", {"X": x2}, {"paddings": [1, 0, 2, 3], "pad_value": 0.5},
         {"Out": 1}, ["X"]),
        ("pad2d", {"X": _f32(r, 1, 2, 4, 5)},
         {"paddings": [1, 2, 0, 3], "mode": "constant", "pad_value": -1.0},
         {"Out": 1}, ["X"]),
        ("pad2d", {"X": _f32(r, 1, 2, 4, 5)},
         {"paddings": [2, 1, 3, 1], "mode": "reflect"}, {"Out": 1}, ["X"]),
        ("pad2d", {"X": _f32(r, 1, 2, 4, 5)},
         {"paddings": [1, 1, 2, 0], "mode": "edge"}, {"Out": 1}, ["X"]),
        ("crop", {"X": x3}, {"offsets": [0, 1, 1], "shape": [2, 2, 2]},
         {"Out": 1}, ["X"]),
        ("scatter", {"X": x2, "Ids": np.array([3, 0], np.int32),
                     "Updates": _f32(r, 2, 4)}, {"overwrite": True},
         {"Out": 1}, ["X", "Updates"]),
        ("scatter", {"X": x2, "Ids": np.array([1, 4, 1], np.int64),
                     "Updates": _f32(r, 3, 4)}, {"overwrite": False},
         {"Out": 1}, ["X", "Updates"]),
        ("gather_nd", {"X": x3, "Index": np.array([[1, 2], [0, 0], [1, 0]],
                                                  np.int32)},
         {}, {"Out": 1}, ["X"]),
        ("one_hot", {"X": ids}, {"depth": 6}, {"Out": 1}, []),
        ("one_hot", {"X": np.array([1, 7, 2], np.int64)}, {"depth": 5},
         {"Out": 1}, []),
        ("label_smooth", {"X": np.eye(4, dtype=np.float32)[[1, 3, 0]]},
         {"epsilon": 0.1}, {"Out": 1}, ["X"]),
        ("label_smooth", {"X": np.eye(4, dtype=np.float32)[[1, 3, 0]],
                          "PriorDist": np.array([[.1, .2, .3, .4]],
                                                np.float32)},
         {"epsilon": 0.2}, {"Out": 1}, ["X"]),
        ("clip", {"X": x2}, {"min": -0.55, "max": 0.65}, {"Out": 1}, ["X"]),
        ("clip_by_norm", {"X": x2}, {"max_norm": 1.0}, {"Out": 1}, ["X"]),
        ("clip_by_norm", {"X": x2 * 0.01}, {"max_norm": 1.0}, {"Out": 1},
         ["X"]),
        ("cumsum", {"X": x3}, {"axis": 1}, {"Out": 1}, ["X"]),
        ("cumsum", {"X": x3}, {"axis": -1, "exclusive": True,
                               "reverse": True}, {"Out": 1}, ["X"]),
        ("cumsum", {"X": np.arange(12, dtype=np.int32).reshape(3, 4)},
         {"axis": 0}, {"Out": 1}, []),
        ("arg_max", {"X": x3}, {"axis": 1}, {"Out": 1}, []),
        ("arg_min", {"X": x3}, {"axis": -1}, {"Out": 1}, []),
        ("argsort", {"X": x3}, {"axis": 1}, {"Out": 1, "Indices": 1}, []),
        ("where", {"Condition": x3 > 0.3}, {}, {"Out": 1}, []),
        ("where_op_select", {"Condition": x2 > 0, "X": x2,
                             "Y": _f32(r, 5, 4)}, {}, {"Out": 1},
         ["X", "Y"]),
        ("multiplex", {"X": [_f32(r, 4, 3) for _ in range(3)],
                       "Ids": np.array([[2], [0], [1], [2]], np.int32)},
         {}, {"Out": 1}, ["X"]),
        ("range", {"Start": np.array(2, np.int32),
                   "End": np.array(13, np.int32),
                   "Step": np.array(3, np.int32)}, {}, {"Out": 1}, []),
        ("range", {"Start": np.array(0.5, np.float32),
                   "End": np.array(2.0, np.float32),
                   "Step": np.array(0.25, np.float32)}, {}, {"Out": 1},
         []),
        ("linspace", {"Start": np.array(-1.0, np.float32),
                      "Stop": np.array(2.0, np.float32),
                      "Num": np.array(7, np.int32)}, {}, {"Out": 1}, []),
        ("eye", {}, {"num_rows": 3, "num_columns": 5, "dtype": 5},
         {"Out": 1}, []),
        ("eye", {}, {"num_rows": 4, "dtype": 2}, {"Out": 1}, []),
        ("diag", {"Diagonal": _f32(r, 4)}, {}, {"Out": 1}, []),
        ("fill_any_like", {"X": x3}, {"value": 2.5}, {"Out": 1}, []),
        ("isfinite", {"X": x3}, {}, {"Out": 1}, []),
        ("isfinite", {"X": np.array([1.0, np.inf], np.float32)}, {},
         {"Out": 1}, []),
        ("shape", {"Input": x3}, {}, {"Out": 1}, []),
        ("size", {"Input": x3}, {}, {"Out": 1}, []),
        ("hash", {"X": r.integers(-5, 1000, (5, 2)).astype(np.int64)},
         {"num_hash": 3, "mod_by": 977}, {"Out": 1}, []),
        ("shard_index", {"X": r.integers(0, 20, (6, 1)).astype(np.int64)},
         {"index_num": 20, "nshards": 3, "shard_id": 1,
          "ignore_value": -1}, {"Out": 1}, []),
    ]


def _reduce_cases():
    r = np.random.default_rng(1)
    x = _f32(r, 3, 4, 5)
    pos = _f32(r, 2, 3, 4, lo=0.5, hi=1.5)
    cases = []
    for op in ("reduce_mean", "reduce_max", "reduce_min"):
        cases += [(op, {"X": x}, {"dim": [1], "keep_dim": False},
                   {"Out": 1}, ["X"]),
                  (op, {"X": x}, {"dim": [0, -1], "keep_dim": True},
                   {"Out": 1}, ["X"]),
                  (op, {"X": x}, {"reduce_all": True}, {"Out": 1}, ["X"])]
    cases += [
        ("reduce_prod", {"X": pos}, {"dim": [0, 2], "keep_dim": False},
         {"Out": 1}, ["X"]),
        ("reduce_prod", {"X": pos}, {"reduce_all": True, "keep_dim": True},
         {"Out": 1}, ["X"]),
        ("reduce_all", {"X": x > -1.5}, {"dim": [1]}, {"Out": 1}, []),
        ("reduce_all", {"X": x > -3}, {"reduce_all": True}, {"Out": 1}, []),
        ("reduce_any", {"X": x > 1.5}, {"dim": [0, 2], "keep_dim": True},
         {"Out": 1}, []),
        ("squared_l2_norm", {"X": x}, {}, {"Out": 1}, ["X"]),
        ("squared_l2_distance", {"X": _f32(r, 4, 3), "Y": _f32(r, 4, 3)},
         {}, {"Out": 1, "sub_result": 1}, ["X", "Y"]),
        ("l1_norm", {"X": x}, {}, {"Out": 1}, ["X"]),
        ("norm", {"X": x}, {"axis": 1, "epsilon": 1e-10},
         {"Out": 1, "Norm": 1}, ["X"]),
        ("frobenius_norm", {"X": x}, {"dim": [1, 2], "keep_dim": False},
         {"Out": 1}, ["X"]),
        ("frobenius_norm", {"X": x}, {"reduce_all": True}, {"Out": 1},
         ["X"]),
        ("minus", {"X": x, "Y": _f32(r, 3, 4, 5)}, {}, {"Out": 1},
         ["X", "Y"]),
    ]
    return cases


def _elementwise_cases():
    r = np.random.default_rng(2)
    x = _f32(r, 2, 3, 4)
    pos = _f32(r, 2, 3, 4, lo=0.5, hi=2.0)
    cases = []
    for op in ("elementwise_max", "elementwise_min"):
        cases += [(op, {"X": x, "Y": _f32(r, 2, 3, 4)}, {"axis": -1},
                   {"Out": 1}, ["X", "Y"]),
                  (op, {"X": x, "Y": _f32(r, 3)}, {"axis": 1}, {"Out": 1},
                   ["X", "Y"])]
    cases += [
        ("elementwise_pow", {"X": pos, "Y": _f32(r, 4)}, {"axis": -1},
         {"Out": 1}, ["X", "Y"]),
        ("elementwise_pow", {"X": pos, "Y": _f32(r, 2, 3, 4)},
         {"axis": -1, "Scale_out": 0.5}, {"Out": 1}, ["X", "Y"]),
        ("elementwise_mod", {"X": 5 * x, "Y": _f32(r, 4, lo=0.7, hi=1.9)},
         {"axis": -1}, {"Out": 1}, ["X", "Y"]),
        ("elementwise_mod", {"X": r.integers(-20, 20, (3, 4)).astype(
            np.int32), "Y": np.array([3, -4, 5, 7], np.int32)},
         {"axis": -1}, {"Out": 1}, []),
        ("elementwise_floordiv", {"X": 5 * x,
                                  "Y": _f32(r, 4, lo=0.7, hi=1.9)},
         {"axis": -1}, {"Out": 1}, ["X", "Y"]),
        ("elementwise_floordiv", {"X": r.integers(-20, 20, (3, 4)).astype(
            np.int64), "Y": np.array([3, -4, 5, 7], np.int64)},
         {"axis": -1}, {"Out": 1}, []),
    ]
    return cases


def _activation_cases():
    r = np.random.default_rng(3)
    x = _f32(r, 3, 5)
    unit = _f32(r, 3, 5, lo=-0.9, hi=0.9)
    pos = _f32(r, 3, 5, lo=0.2, hi=3.0)
    # away from the integer steps of floor / ceil / round
    steps = (r.integers(-4, 4, (3, 5)) + r.uniform(0.1, 0.4, (3, 5))) \
        .astype(np.float32)
    plain = {"abs": x, "acos": unit, "asin": unit, "atan": x, "ceil": steps,
             "cos": x, "exp": x, "floor": steps, "reciprocal": pos,
             "round": steps, "rsqrt": pos, "sin": x, "softsign": x,
             "sqrt": pos, "tanh_shrink": x, "logsigmoid": x,
             "softplus": 5 * x, "gelu": x}
    cases = [(op, {"X": v}, {}, {"Out": 1}, ["X"])
             for op, v in plain.items()]
    cases += [
        ("brelu", {"X": 10 * x}, {"t_min": -3.3, "t_max": 7.7}, {"Out": 1},
         ["X"]),
        ("relu6", {"X": 5 * x}, {"threshold": 4.2}, {"Out": 1}, ["X"]),
        ("soft_relu", {"X": 30 * x}, {"threshold": 20.5}, {"Out": 1},
         ["X"]),
        ("leaky_relu", {"X": x}, {"alpha": 0.1}, {"Out": 1}, ["X"]),
        ("elu", {"X": x}, {"alpha": 0.7}, {"Out": 1}, ["X"]),
        ("hard_sigmoid", {"X": 4 * x}, {"slope": 0.25, "offset": 0.45},
         {"Out": 1}, ["X"]),
        ("hard_shrink", {"X": x}, {"threshold": 0.45}, {"Out": 1}, ["X"]),
        ("softshrink", {"X": x}, {"lambda": 0.35}, {"Out": 1}, ["X"]),
        ("thresholded_relu", {"X": x}, {"threshold": 0.55}, {"Out": 1},
         ["X"]),
        ("stanh", {"X": x}, {"scale_a": 0.6, "scale_b": 1.5}, {"Out": 1},
         ["X"]),
        ("swish", {"X": x}, {"beta": 1.3}, {"Out": 1}, ["X"]),
        ("pow", {"X": pos}, {"factor": 2.5}, {"Out": 1}, ["X"]),
        ("prelu", {"X": _f32(r, 2, 3, 2, 2), "Alpha": np.array(
            [0.2], np.float32)}, {"mode": "all"}, {"Out": 1},
         ["X", "Alpha"]),
        ("prelu", {"X": _f32(r, 2, 3, 2, 2), "Alpha": _f32(r, 3)},
         {"mode": "channel"}, {"Out": 1}, ["X", "Alpha"]),
        ("prelu", {"X": _f32(r, 2, 3, 2), "Alpha": _f32(r, 3, 2)},
         {"mode": "element"}, {"Out": 1}, ["X", "Alpha"]),
        ("selu", {"X": x}, {}, {"Out": 1}, ["X"]),
        ("maxout", {"X": _f32(r, 2, 6, 3, 2)}, {"groups": 3}, {"Out": 1},
         ["X"]),
    ]
    return cases



def _nn_cases():
    """The nn family's log_softmax, cross_entropy2, losses and norms, and
    sign."""
    r = np.random.default_rng(5)
    probs = r.dirichlet(np.ones(5), 4).astype(np.float32)
    labels = np.array([[3], [0], [4], [1]], np.int64)
    bits = np.array([[1], [0], [0], [1], [1], [0]], np.float32)
    target = _f32(r, 3, 4, lo=0.05, hi=1.0)
    target[0, 1] = target[2, 3] = 0.0
    stats = {"BatchSize": _f32(r, 3, lo=5.0, hi=10.0),
             "BatchSum": _f32(r, 3), "BatchSquareSum": _f32(r, 3, lo=4.0,
                                                           hi=9.0)}
    cases = [
        ("log_softmax", {"X": _f32(r, 3, 5)}, {"axis": -1}, {"Out": 1},
         ["X"]),
        ("cross_entropy2", {"X": probs, "Label": labels}, {},
         {"Y": 1, "XShape": 1, "MatchX": 1}, ["X"]),
        ("log_loss", {"Predicted": _f32(r, 6, 1, lo=0.05, hi=0.95),
                      "Labels": bits}, {"epsilon": 1e-4}, {"Loss": 1},
         ["Predicted"]),
        ("huber_loss", {"X": _f32(r, 6, 1), "Y": _f32(r, 6, 1)},
         {"delta": 0.8}, {"Out": 1, "Residual": 1}, ["X"]),
        ("smooth_l1_loss", {"X": _f32(r, 4, 3), "Y": _f32(r, 4, 3),
                            "InsideWeight": _f32(r, 4, 3, lo=0.5, hi=1.5),
                            "OutsideWeight": _f32(r, 4, 3, lo=0.5,
                                                  hi=1.5)},
         {"sigma": 1.5}, {"Out": 1, "Diff": 1}, ["X"]),
        ("smooth_l1_loss", {"X": _f32(r, 3, 2, 2), "Y": _f32(r, 3, 2, 2)},
         {"sigma": 1.0}, {"Out": 1, "Diff": 1}, ["X"]),
        ("hinge_loss", {"Logits": _f32(r, 6, 1), "Labels": bits}, {},
         {"Loss": 1}, ["Logits"]),
        ("rank_loss", {"Label": bits[:5], "Left": _f32(r, 5, 1),
                       "Right": _f32(r, 5, 1)}, {}, {"Out": 1},
         ["Left", "Right"]),
        ("margin_rank_loss", {"Label": 2 * bits[:5] - 1,
                              "X1": _f32(r, 5, 1), "X2": _f32(r, 5, 1)},
         {"margin": 0.1}, {"Out": 1, "Activated": 1}, ["X1", "X2"]),
        ("bpr_loss", {"X": _f32(r, 4, 5), "Label": labels}, {}, {"Y": 1},
         ["X"]),
        ("group_norm", {"X": _f32(r, 2, 6, 3, 3), "Scale": _f32(r, 6),
                        "Bias": _f32(r, 6)}, {"groups": 3,
                                              "epsilon": 1e-5},
         {"Y": 1, "Mean": 1, "Variance": 1}, ["X", "Scale", "Bias"]),
        ("instance_norm", {"X": _f32(r, 2, 3, 4, 4), "Scale": _f32(r, 3),
                           "Bias": _f32(r, 3)}, {"epsilon": 1e-5},
         {"Y": 1}, ["X", "Scale", "Bias"]),
        ("lrn", {"X": _f32(r, 2, 6, 3, 3)},
         {"n": 5, "alpha": 1e-2, "beta": 0.75, "k": 1.0},
         {"Out": 1, "MidOut": 1}, ["X"]),
        ("l2_normalize", {"X": _f32(r, 3, 4)}, {"axis": 1,
                                                "epsilon": 1e-10},
         {"Out": 1}, ["X"]),
        ("l2_normalize", {"X": _f32(r, 2, 3, 4)}, {"axis": -1,
                                                   "epsilon": 1e-12},
         {"Out": 1}, ["X"]),
        ("data_norm", dict({"X": _f32(r, 4, 3)}, **stats),
         {"epsilon": 1e-5}, {"Y": 1, "Means": 1, "Scales": 1},
         ["X", "BatchSize", "BatchSum", "BatchSquareSum"]),
        ("sign", {"X": np.array([[-1.5, 0.0, 2.0], [0.3, -0.2, 0.0]],
                                np.float32)}, {}, {"Out": 1}, ["X"]),
    ]
    for red in ("mean", "sum", "batchmean", "none"):
        cases.append(("kldiv_loss", {"X": _f32(r, 3, 4), "Target": target},
                      {"reduction": red}, {"Loss": 1}, ["X"]))
    return cases


def _optimizer_cases():
    """The nine update ops with no kernel (rmsprop centered and not), on
    state a few updates could have left."""
    r = np.random.default_rng(6)

    def base(shape=(4, 5)):
        return {"Param": _f32(r, *shape), "Grad": _f32(r, *shape),
                "LearningRate": np.array([0.01], np.float32)}

    def pos(shape=(4, 5)):
        return _f32(r, *shape, lo=0.01, hi=0.5)

    b1p = np.array([0.9 ** 3], np.float32)
    b2p = np.array([0.999 ** 3], np.float32)
    cases = [
        ("lars_momentum", dict(base(), Velocity=_f32(r, 4, 5)),
         {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005},
         {"ParamOut": 1, "VelocityOut": 1}, []),
        ("adamax", dict(base(), Moment=_f32(r, 4, 5), InfNorm=pos(),
                        Beta1Pow=b1p),
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
         {"ParamOut": 1, "MomentOut": 1, "InfNormOut": 1}, []),
        ("decayed_adagrad", dict(base(), Moment=pos()),
         {"decay": 0.95, "epsilon": 1e-6}, {"ParamOut": 1, "MomentOut": 1},
         []),
        ("proximal_adagrad", dict(base(), Moment=pos()),
         {"l1": 0.01, "l2": 0.02}, {"ParamOut": 1, "MomentOut": 1}, []),
        ("proximal_gd", base(), {"l1": 0.01, "l2": 0.02},
         {"ParamOut": 1}, []),
        ("adadelta", {"Param": _f32(r, 4, 5), "Grad": _f32(r, 4, 5),
                      "AvgSquaredGrad": pos(), "AvgSquaredUpdate": pos()},
         {"rho": 0.95, "epsilon": 1e-6},
         {"ParamOut": 1, "AvgSquaredGradOut": 1,
          "AvgSquaredUpdateOut": 1}, []),
        ("ftrl", dict(base(), SquaredAccumulator=pos(),
                      LinearAccumulator=_f32(r, 4, 5)),
         {"l1": 0.01, "l2": 0.02, "lr_power": -0.5},
         {"ParamOut": 1, "SquaredAccumOut": 1, "LinearAccumOut": 1}, []),
        ("lamb", dict(base(), Moment1=_f32(r, 4, 5), Moment2=pos(),
                      Beta1Pow=b1p, Beta2Pow=b2p),
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
          "weight_decay": 0.01},
         {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
          "Beta1PowOut": 1, "Beta2PowOut": 1}, []),
    ]
    for centered in (False, True):
        ms = pos()
        cases.append(("rmsprop", dict(base(), MeanSquare=ms,
                                      Moment=_f32(r, 4, 5),
                                      MeanGrad=0.1 * _f32(r, 4, 5)),
                      {"epsilon": 1e-6, "decay": 0.95, "momentum": 0.9,
                       "centered": centered},
                      {"ParamOut": 1, "MeanSquareOut": 1, "MomentOut": 1,
                       "MeanGradOut": 1} if centered else
                      {"ParamOut": 1, "MeanSquareOut": 1, "MomentOut": 1},
                      []))
    return cases


def cases() -> Dict[str, List[tuple]]:
    """The cases by family."""
    return {"basic": _basic_cases(), "reduce": _reduce_cases(),
            "elementwise": _elementwise_cases(),
            "activations": _activation_cases(), "nn": _nn_cases(),
            "optimizer": _optimizer_cases()}


def conv_cases() -> List[tuple]:
    """One case or more a op type of the conv family (ops/conv.py):
    transposed convolutions (groups 2, depthwise, the pose head's 4x4
    stride-2 padding-1 deconvolution), conv3d and pool3d (ceil_mode,
    exclusive and not, global), adaptive pool2d / pool3d, unfold, spp,
    both interpolations with align_corners both ways, a scale and an
    OutSize input, max_pool2d_with_index and the layout ops. No ties of
    a max and no window wholly in the padding."""
    r = np.random.default_rng(21)
    img = _f32(r, 2, 3, 4, 6)
    vol = _f32(r, 1, 2, 5, 6, 7)
    out = {"Output": 1}
    return [
        ("conv2d_transpose", {"Input": _f32(r, 2, 4, 5, 5),
                              "Filter": _f32(r, 4, 3, 3, 3)},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 1}, out, ["Input", "Filter"]),
        ("conv2d_transpose", {"Input": _f32(r, 2, 4, 4, 5),
                              "Filter": _f32(r, 4, 3, 3, 2)},
         {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1],
          "groups": 2}, out, ["Input", "Filter"]),
        ("conv2d_transpose", {"Input": _f32(r, 1, 3, 4, 3),
                              "Filter": _f32(r, 3, 2, 4, 4)},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 1}, out, ["Input", "Filter"]),
        ("depthwise_conv2d_transpose", {"Input": _f32(r, 2, 4, 4, 4),
                                        "Filter": _f32(r, 4, 1, 3, 3)},
         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
          "groups": 4}, out, ["Input", "Filter"]),
        ("conv3d", {"Input": _f32(r, 1, 2, 4, 5, 5),
                    "Filter": _f32(r, 3, 2, 3, 3, 3)},
         {"strides": [1, 2, 2], "paddings": [1, 1, 1],
          "dilations": [1, 1, 1], "groups": 1}, out, ["Input", "Filter"]),
        ("conv3d", {"Input": _f32(r, 1, 4, 4, 4, 4),
                    "Filter": _f32(r, 4, 2, 2, 2, 2)},
         {"strides": [1, 1, 1], "paddings": [0, 1, 0],
          "dilations": [1, 1, 2], "groups": 2}, out, ["Input", "Filter"]),
        ("conv3d_transpose", {"Input": _f32(r, 1, 3, 3, 4, 4),
                              "Filter": _f32(r, 3, 2, 2, 3, 3)},
         {"strides": [2, 2, 2], "paddings": [0, 1, 1],
          "dilations": [1, 1, 1], "groups": 1}, out, ["Input", "Filter"]),
        ("conv3d_transpose", {"Input": _f32(r, 1, 4, 2, 3, 3),
                              "Filter": _f32(r, 4, 1, 2, 2, 2)},
         {"strides": [1, 2, 1], "paddings": [0, 0, 1],
          "dilations": [1, 1, 1], "groups": 2}, out, ["Input", "Filter"]),
        ("pool3d", {"X": vol}, {"pooling_type": "max", "ksize": [2, 3, 3],
                                "strides": [2, 2, 2], "paddings": [0, 1, 1],
                                "ceil_mode": True}, {"Out": 1}, ["X"]),
        ("pool3d", {"X": vol}, {"pooling_type": "avg", "ksize": [3, 3, 3],
                                "strides": [2, 2, 2], "paddings": [1, 1, 1],
                                "exclusive": True}, {"Out": 1}, ["X"]),
        ("pool3d", {"X": vol}, {"pooling_type": "avg", "ksize": [3, 2, 3],
                                "strides": [1, 2, 2], "paddings": [1, 0, 1],
                                "exclusive": False}, {"Out": 1}, ["X"]),
        ("pool3d", {"X": vol}, {"pooling_type": "avg", "ksize": [2, 2, 2],
                                "strides": [2, 2, 2], "paddings": [0, 0, 0],
                                "exclusive": False, "ceil_mode": True},
         {"Out": 1}, ["X"]),
        ("pool3d", {"X": vol}, {"pooling_type": "max",
                                "global_pooling": True}, {"Out": 1},
         ["X"]),
        ("pool2d", {"X": img}, {"pooling_type": "max", "ksize": [2, 3],
                                "adaptive": True}, {"Out": 1}, ["X"]),
        ("pool2d", {"X": img}, {"pooling_type": "avg", "ksize": [4, 2],
                                "adaptive": True}, {"Out": 1}, ["X"]),
        ("pool2d", {"X": img}, {"pooling_type": "avg", "ksize": [1, 1],
                                "adaptive": True}, {"Out": 1}, ["X"]),
        ("pool3d", {"X": _f32(r, 1, 2, 4, 4, 6)},
         {"pooling_type": "avg", "ksize": [2, 1, 3], "adaptive": True},
         {"Out": 1}, ["X"]),
        ("pool3d", {"X": _f32(r, 1, 2, 4, 4, 6)},
         {"pooling_type": "max", "ksize": [2, 2, 2], "adaptive": True},
         {"Out": 1}, ["X"]),
        ("max_pool2d_with_index", {"X": _f32(r, 2, 3, 6, 7)},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
         {"Out": 1, "Mask": 1}, ["X"]),
        ("max_pool2d_with_index", {"X": _f32(r, 1, 2, 5, 6)},
         {"ksize": [2, 3], "strides": [1, 2], "paddings": [0, 1]},
         {"Out": 1, "Mask": 1}, ["X"]),
        ("unfold", {"X": _f32(r, 2, 3, 5, 6)},
         {"kernel_sizes": [2, 3], "strides": [1, 2],
          "paddings": [1, 0, 2, 1], "dilations": [1, 1]}, {"Y": 1}, ["X"]),
        ("unfold", {"X": _f32(r, 1, 2, 6, 6)},
         {"kernel_sizes": [3, 2], "strides": [2, 1],
          "paddings": [1, 1, 1, 1], "dilations": [2, 2]}, {"Y": 1}, ["X"]),
        ("spp", {"X": _f32(r, 2, 3, 5, 7)},
         {"pyramid_height": 3, "pooling_type": "max"}, {"Out": 1}, ["X"]),
        ("spp", {"X": _f32(r, 2, 3, 5, 6)},
         {"pyramid_height": 2, "pooling_type": "avg"}, {"Out": 1}, ["X"]),
        ("bilinear_interp", {"X": img},
         {"out_h": 7, "out_w": 5, "align_corners": True}, {"Out": 1},
         ["X"]),
        ("bilinear_interp", {"X": img},
         {"out_h": 9, "out_w": 4, "align_corners": False}, {"Out": 1},
         ["X"]),
        ("bilinear_interp", {"X": img},
         {"scale": 1.5, "align_corners": False}, {"Out": 1}, ["X"]),
        ("bilinear_interp", {"X": img, "OutSize": np.array([8, 3],
                                                           np.int32)},
         {"out_h": 2, "out_w": 2, "align_corners": True}, {"Out": 1},
         ["X"]),
        ("nearest_interp", {"X": img},
         {"out_h": 7, "out_w": 5, "align_corners": True}, {"Out": 1},
         ["X"]),
        ("nearest_interp", {"X": img},
         {"out_h": 8, "out_w": 12, "align_corners": False}, {"Out": 1},
         ["X"]),
        ("nearest_interp", {"X": img},
         {"scale": 2.0, "align_corners": False}, {"Out": 1}, ["X"]),
        ("nearest_interp", {"X": img, "OutSize": np.array([3, 9],
                                                          np.int32)},
         {"align_corners": True}, {"Out": 1}, ["X"]),
        ("pixel_shuffle", {"X": _f32(r, 2, 8, 3, 2)},
         {"upscale_factor": 2}, {"Out": 1}, ["X"]),
        ("space_to_depth", {"X": _f32(r, 2, 3, 4, 6)}, {"blocksize": 2},
         {"Out": 1}, ["X"]),
        ("shuffle_channel", {"X": _f32(r, 2, 6, 3, 2)}, {"group": 3},
         {"Out": 1}, ["X"]),
        ("affine_channel", {"X": img, "Scale": _f32(r, 3),
                            "Bias": _f32(r, 3)},
         {"data_layout": "NCHW"}, {"Out": 1}, ["X", "Scale", "Bias"]),
        ("affine_channel", {"X": _f32(r, 2, 4, 5, 3), "Scale": _f32(r, 3),
                            "Bias": _f32(r, 3)},
         {"data_layout": "NHWC"}, {"Out": 1}, ["X", "Scale", "Bias"]),
        ("temporal_shift", {"X": _f32(r, 6, 8, 3, 2)},
         {"seg_num": 3, "shift_ratio": 0.25}, {"Out": 1}, ["X"]),
        ("temporal_shift", {"X": _f32(r, 4, 10, 2, 2)},
         {"seg_num": 2, "shift_ratio": 0.2}, {"Out": 1}, ["X"]),
    ]


LOD = [[0, 2, 2, 5, 6]]     # four sequences, the second empty


def sequence_cases() -> List[tuple]:
    """(op type, inputs, {input name: LoD}, attrs, output slots) of the
    three value-dependent sequence ops."""
    r = np.random.default_rng(4)
    return [
        ("sequence_erase", {"X": np.array([[2], [5], [3], [5], [5], [7]],
                                          np.int64)},
         {"x": LOD}, {"tokens": [5, 9]}, ["Out"]),
        ("sequence_slice", {"X": _f32(r, 6, 3),
                            "Offset": np.array([[1], [0], [2], [0]],
                                               np.int64),
                            "Length": np.array([[1], [0], [1], [1]],
                                               np.int64)},
         {"x": LOD}, {}, ["Out"]),
        ("edit_distance", {"Hyps": np.array([[1], [2], [3], [4], [4], [6]],
                                            np.int64),
                           "Refs": np.array([[1], [3], [3], [4], [5], [6],
                                             [7]], np.int64)},
         {"hyps": [[0, 3, 3, 6]], "refs": [[0, 2, 4, 7]]},
         {"normalized": True}, ["Out", "SequenceNum"]),
    ]


def _boxes(r, *lead):
    """Boxes (x1, y1, x2, y2) in the unit square, [*lead, 4] float32."""
    xy = r.uniform(0.0, 0.6, lead + (2,))
    wh = r.uniform(0.1, 0.4, lead + (2,))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


DET_LOD = [[0, 1, 5, 7]]    # three images: one box, then four, two


def detection_cases() -> List[tuple]:
    """(op type, inputs, {input name: LoD}, attrs, output slots) of SSD's
    eight detection ops, three images with 1-4 boxes where a LoD
    applies: a single-box image, ties, priors no box reaches, -1
    NegIndices padding, equal scores in NMS."""
    r = np.random.default_rng(8)
    gt = _boxes(r, 7)
    priors = _boxes(r, 6)
    dist = r.uniform(0.0, 0.9, (7, 6)).astype(np.float32)
    dist[:, 5] = 0.1                    # a prior no box reaches 0.5
    dist[2, 1] = dist[3, 1] = 0.8       # a tie across rows
    dist[1, 0] = dist[1, 4] = 0.85      # and along one row
    match = np.array([[0, -1, -1, 0, -1, -1], [3, 0, -1, 1, -1, 2],
                      [-1, 1, 0, -1, 1, -1]], np.int32)
    mdist = r.uniform(0.0, 0.8, (3, 6)).astype(np.float32)
    loss = r.uniform(0.0, 2.0, (3, 6)).astype(np.float32)
    loss[0, 2] = loss[0, 4]             # tied losses keep their order
    neg = np.full((18, 1), -1, np.int32)
    neg[[0, 1, 6, 12, 13, 14]] = [[2], [1], [5], [3], [0], [5]]
    labels = np.array([[3], [1], [2], [2], [4], [1], [3]], np.int32)
    nms_boxes = _boxes(r, 2, 6)
    nms_boxes[0, 3] = nms_boxes[0, 1]   # a duplicate box
    nms_scores = r.uniform(0.0, 1.0, (2, 3, 6)).astype(np.float32)
    nms_scores[1, 2, [0, 4]] = 0.7      # equal scores
    det = np.concatenate([
        r.integers(1, 4, (9, 1)).astype(np.float32),
        r.uniform(0.05, 1.0, (9, 1)).astype(np.float32),
        np.concatenate([gt[:3], gt[3:6] + 0.02, _boxes(r, 3)])], axis=1)
    lab = np.concatenate([r.integers(1, 4, (7, 1)), r.integers(0, 2, (7, 1)),
                          gt], axis=1).astype(np.float32)
    lab[1:4, 0] = det[3:6, 0]
    gt_lod = {"x": DET_LOD}
    return [
        ("prior_box", {"Input": np.zeros((1, 2, 3, 4), np.float32),
                       "Image": np.zeros((1, 3, 12, 16), np.float32)},
         {}, {"min_sizes": [4.0], "max_sizes": [8.0],
              "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True,
              "variances": [0.1, 0.1, 0.2, 0.2], "offset": 0.5},
         ["Boxes", "Variances"]),
        ("prior_box", {"Input": np.zeros((1, 2, 2, 3), np.float32),
                       "Image": np.zeros((1, 3, 10, 10), np.float32)},
         {}, {"min_sizes": [2.0, 5.0], "max_sizes": [4.0, 9.0],
              "aspect_ratios": [2.0], "flip": False, "clip": False,
              "min_max_aspect_ratios_order": True, "step_w": 3.0,
              "step_h": 4.0, "offset": 0.25}, ["Boxes", "Variances"]),
        ("iou_similarity", {"X": gt, "Y": priors}, gt_lod,
         {"box_normalized": True}, ["Out"]),
        ("box_coder", {"PriorBox": priors, "PriorBoxVar": np.full(
            (6, 4), 0.2, np.float32), "TargetBox": gt},
         {"targetbox": DET_LOD}, {"code_type": "encode_center_size"},
         ["OutputBox"]),
        ("box_coder", {"PriorBox": priors, "TargetBox": gt}, {},
         {"code_type": "encode_center_size", "box_normalized": False,
          "variance": [0.1, 0.1, 0.2, 0.2]}, ["OutputBox"]),
        ("box_coder", {"PriorBox": priors, "PriorBoxVar": np.full(
            (6, 4), 0.2, np.float32), "TargetBox": _f32(r, 2, 6, 4)}, {},
         {"code_type": "decode_center_size", "axis": 0}, ["OutputBox"]),
        ("box_coder", {"PriorBox": priors, "TargetBox": _f32(r, 6, 3, 4)},
         {}, {"code_type": "decode_center_size", "axis": 1,
              "box_normalized": False,
              "variance": [0.1, 0.1, 0.2, 0.2]}, ["OutputBox"]),
        ("bipartite_match", {"DistMat": dist}, {"distmat": DET_LOD},
         {"match_type": "bipartite", "dist_threshold": 0.5},
         ["ColToRowMatchIndices", "ColToRowMatchDist"]),
        ("bipartite_match", {"DistMat": dist}, {"distmat": DET_LOD},
         {"match_type": "per_prediction", "dist_threshold": 0.5},
         ["ColToRowMatchIndices", "ColToRowMatchDist"]),
        ("target_assign", {"X": labels, "MatchIndices": match}, gt_lod,
         {"mismatch_value": 0}, ["Out", "OutWeight"]),
        ("target_assign", {"X": _f32(r, 7, 6, 4), "MatchIndices": match},
         gt_lod, {"mismatch_value": 0}, ["Out", "OutWeight"]),
        ("target_assign", {"X": labels, "MatchIndices": match,
                           "NegIndices": neg},
         {"x": DET_LOD, "negindices": [[0, 6, 12, 18]]},
         {"mismatch_value": 0}, ["Out", "OutWeight"]),
        ("mine_hard_examples", {"ClsLoss": loss, "MatchIndices": match,
                                "MatchDist": mdist}, {},
         {"neg_pos_ratio": 3.0, "neg_dist_threshold": 0.5,
          "mining_type": "max_negative"},
         ["NegIndices", "UpdatedMatchIndices"]),
        ("mine_hard_examples", {"ClsLoss": loss, "LocLoss": 0.5 * loss,
                                "MatchIndices": match, "MatchDist": mdist},
         {}, {"neg_pos_ratio": 1.0, "neg_dist_threshold": 0.4,
              "mining_type": "max_negative"},
         ["NegIndices", "UpdatedMatchIndices"]),
        ("multiclass_nms", {"BBoxes": nms_boxes, "Scores": nms_scores}, {},
         {"score_threshold": 0.05, "nms_top_k": 4, "keep_top_k": 5,
          "nms_threshold": 0.3, "normalized": True, "nms_eta": 1.0,
          "background_label": 0}, ["Out"]),
        ("multiclass_nms", {"BBoxes": nms_boxes, "Scores": nms_scores}, {},
         {"score_threshold": 0.0, "nms_top_k": -1, "keep_top_k": -1,
          "nms_threshold": 0.8, "normalized": False, "nms_eta": 0.7,
          "background_label": 1}, ["Out"]),
        ("multiclass_nms", {"BBoxes": nms_boxes, "Scores": nms_scores}, {},
         {"score_threshold": 0.6, "nms_top_k": 4, "keep_top_k": 8,
          "nms_threshold": 0.5, "normalized": True, "nms_eta": 1.0,
          "background_label": 0}, ["Out"]),
        ("detection_map", {"DetectRes": det, "Label": lab},
         {"detectres": [[0, 2, 6, 9]], "label": DET_LOD},
         {"overlap_threshold": 0.5, "evaluate_difficult": False,
          "ap_type": "11point", "class_num": 4},
         ["MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos"]),
        ("detection_map", {"DetectRes": det, "Label": lab},
         {"detectres": [[0, 2, 6, 9]], "label": DET_LOD},
         {"overlap_threshold": 0.3, "evaluate_difficult": True,
          "ap_type": "integral", "class_num": 4},
         ["MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos"]),
    ]


# YOLOv3 at test size: 9 anchors of a 32-pixel input, this head's the
# middle three (downsample 8 on a 4x4 map), 3 classes
YOLO_ANCHORS = [2, 2, 3, 4, 4, 3, 6, 6, 8, 10, 10, 8, 14, 14, 18, 22, 24, 20]
YOLO_MASK = [3, 4, 5]


def _yolo_inputs(r):
    """(X [2, 24, 4, 4], GTBox [2, 6, 4], GTLabel [2, 6], GTScore [2, 6]):
    image 0 has a box on a cell edge (cx W = 2 exactly), two boxes on one
    cell and anchor, a box of another head's anchor and two padding
    rows; image 1 has no box. The third anchor of cell (2, 2) of image 0
    predicts the second box's shape: an ignored cell."""
    x = (0.5 * r.standard_normal((2, 24, 4, 4))).astype(np.float32)
    x[0, 16:20, 2, 2] = [0.0, 0.0, np.log(0.832), np.log(1.2)]
    box = np.zeros((2, 6, 4), np.float32)
    box[0, :4] = [[0.5, 0.3, 0.19, 0.19], [0.61, 0.62, 0.26, 0.30],
                  [0.63, 0.60, 0.25, 0.31], [0.4, 0.5, 0.7, 0.6]]
    label = np.array([[2, 0, 1, 1, 0, 0], [0] * 6], np.int32)
    score = np.array([[0.8, 0.5, 0.9, 0.7, 1.0, 1.0], [1.0] * 6],
                     np.float32)
    return x, box, label, score


def _pixel_boxes(r, n, lo=0.0, hi=40.0, side=(4.0, 20.0)):
    """n boxes (x1, y1, x2, y2) in pixels, [n, 4] float32."""
    xy = r.uniform(lo, hi, (n, 2))
    wh = r.uniform(side[0], side[1], (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def one_stage_cases() -> List[tuple]:
    """(op type, inputs, {input name: LoD}, attrs, {output slot: count},
    [input slots to differentiate]) of the one-stage detectors' ten ops:
    yolov3_loss with and without GTScore (a box on a cell edge, two on
    one cell and anchor, an image with no box; the last case's scores
    below 1, which the JAX lowering does not read), yolo_box, the
    anchors and priors (Python's half-to-even rounding, int(step /
    density)), sigmoid_focal_loss (an ignored label, FgNum 0), box_clip
    on a LoD, box_decoder_and_assign (a tie, a clipped delta),
    polygon_box_transform, retinanet_target_assign (a crowd box; an
    image with no box, which the JAX lowering cannot take) and
    retinanet_detection_output over two levels."""
    r = np.random.default_rng(22)
    x, box, label, score = _yolo_inputs(r)
    yolo = {"anchors": YOLO_ANCHORS, "anchor_mask": YOLO_MASK,
            "class_num": 3, "ignore_thresh": 0.5, "downsample_ratio": 8}
    y_out = {"Loss": 1, "ObjectnessMask": 1, "GTMatchMask": 1}
    anchors = _pixel_boxes(r, 12)
    gt = _pixel_boxes(r, 5, side=(8.0, 24.0))
    gt[1] = anchors[3] + 1.0            # one box over an anchor
    gt_labels = np.array([[1], [3], [2], [1], [2]], np.int32)
    crowd = np.array([[0], [0], [1], [0], [0]], np.int32)
    im_info = np.array([[48.0, 48.0, 1.0], [64.0, 64.0, 2.0],
                        [50.0, 40.0, 1.0]], np.float32)
    det_scores = [r.uniform(0, 1, (2, 6, 3)).astype(np.float32),
                  r.uniform(0, 1, (2, 3, 3)).astype(np.float32)]
    det_scores[0][0, 2, 1] = det_scores[0][0, 4, 0]        # a tie
    det_scores[0][:, :2, 1] = [[0.95, 0.93]]   # overlapping, one class
    det_anchors = [_pixel_boxes(r, 6), _pixel_boxes(r, 3)]
    det_anchors[0][1] = det_anchors[0][0] + 0.5            # overlapping
    prior = _pixel_boxes(r, 4)
    deltas = (0.3 * r.standard_normal((4, 12))).astype(np.float32)
    deltas[1, 2] = 9.0                  # past box_clip
    bscore = r.uniform(0, 1, (4, 3)).astype(np.float32)
    bscore[2, 0] = bscore[2, 2]         # a tie: the first class
    clip_in = _pixel_boxes(r, 5, lo=-10.0, hi=50.0)
    return [
        ("yolov3_loss", {"X": x, "GTBox": box, "GTLabel": label}, {},
         dict(yolo, use_label_smooth=True), y_out, ["X"]),
        ("yolov3_loss", {"X": x, "GTBox": box, "GTLabel": label,
                         "GTScore": np.ones_like(score)}, {},
         dict(yolo, use_label_smooth=False), y_out, ["X"]),
        ("yolov3_loss", {"X": x, "GTBox": box, "GTLabel": label,
                         "GTScore": score}, {},
         dict(yolo, use_label_smooth=True), y_out, ["X"]),
        ("yolo_box", {"X": (r.standard_normal((2, 16, 3, 4))
                            .astype(np.float32)),
                      "ImgSize": np.array([[60, 80], [40, 50]], np.int32)},
         {}, {"anchors": [4, 5, 10, 12], "class_num": 3,
              "conf_thresh": 0.5, "downsample_ratio": 16},
         {"Boxes": 1, "Scores": 1}, []),
        ("anchor_generator", {"Input": np.zeros((1, 4, 3, 5), np.float32)},
         {}, {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
              "variances": [0.1, 0.1, 0.2, 0.2], "stride": [16.0, 16.0],
              "offset": 0.5}, {"Anchors": 1, "Variances": 1}, []),
        ("anchor_generator", {"Input": np.zeros((1, 4, 2, 3), np.float32)},
         {}, {"anchor_sizes": [10.0], "aspect_ratios": [0.5, 2.0],
              "variances": [1.0, 1.0, 1.0, 1.0], "stride": [6.0, 7.0],
              "offset": 0.0}, {"Anchors": 1, "Variances": 1}, []),
        ("density_prior_box", {"Input": np.zeros((1, 2, 3, 3), np.float32),
                               "Image": np.zeros((1, 3, 30, 30),
                                                 np.float32)},
         {}, {"densities": [2, 1], "fixed_sizes": [8.0, 16.0],
              "fixed_ratios": [1.0, 2.0], "variances": [0.1, 0.1, 0.2, 0.2],
              "clip": True, "step_w": 0.0, "step_h": 0.0, "offset": 0.5},
         {"Boxes": 1, "Variances": 1}, []),
        ("density_prior_box", {"Input": np.zeros((1, 2, 2, 4), np.float32),
                               "Image": np.zeros((1, 3, 16, 28),
                                                 np.float32)},
         {}, {"densities": [3], "fixed_sizes": [6.0],
              "fixed_ratios": [0.5], "variances": [0.1, 0.1, 0.2, 0.2],
              "clip": False, "step_w": 7.0, "step_h": 8.0, "offset": 0.5},
         {"Boxes": 1, "Variances": 1}, []),
        ("sigmoid_focal_loss", {"X": _f32(r, 6, 4),
                                "Label": np.array([[1], [0], [-1], [4], [2],
                                                   [0]], np.int32),
                                "FgNum": np.array([3], np.int32)}, {},
         {"gamma": 2.0, "alpha": 0.25}, {"Out": 1}, ["X"]),
        ("sigmoid_focal_loss", {"X": _f32(r, 3, 2),
                                "Label": np.array([[0], [2], [1]], np.int32),
                                "FgNum": np.array([0], np.int32)}, {},
         {"gamma": 1.5, "alpha": 0.5}, {"Out": 1}, ["X"]),
        ("box_clip", {"Input": clip_in,
                      "ImInfo": np.array([[20.0, 30.0, 1.0],
                                          [40.0, 20.0, 2.0]], np.float32)},
         {"input": [[0, 2, 5]]}, {}, {"Output": 1}, ["Input"]),
        ("box_clip", {"Input": np.concatenate(
            [clip_in[:3], clip_in[2:]], 1).reshape(3, 2, 4),
            "ImInfo": np.array([[33.0, 47.0, 1.0]], np.float32)}, {}, {},
         {"Output": 1}, ["Input"]),
        ("box_decoder_and_assign", {"PriorBox": prior,
                                    "PriorBoxVar": np.full((4, 4), 0.5,
                                                           np.float32),
                                    "TargetBox": deltas, "BoxScore": bscore},
         {}, {"box_clip": 4.135}, {"DecodeBox": 1, "OutputAssignBox": 1},
         []),
        ("polygon_box_transform", {"Input": _f32(r, 2, 8, 3, 4)}, {}, {},
         {"Output": 1}, []),
        ("retinanet_target_assign", {"Anchor": anchors, "GtBoxes": gt,
                                     "GtLabels": gt_labels,
                                     "IsCrowd": crowd,
                                     "ImInfo": im_info[:2]},
         {"gtboxes": [[0, 2, 5]]},
         {"positive_overlap": 0.5, "negative_overlap": 0.4},
         {"LocationIndex": 1, "ScoreIndex": 1, "TargetLabel": 1,
          "TargetBBox": 1, "BBoxInsideWeight": 1, "ForegroundNumber": 1},
         []),
        ("retinanet_target_assign", {"Anchor": anchors, "GtBoxes": gt,
                                     "GtLabels": gt_labels,
                                     "IsCrowd": crowd, "ImInfo": im_info},
         {"gtboxes": [[0, 2, 2, 5]]},
         {"positive_overlap": 0.3, "negative_overlap": 0.2},
         {"LocationIndex": 1, "ScoreIndex": 1, "TargetLabel": 1,
          "TargetBBox": 1, "BBoxInsideWeight": 1, "ForegroundNumber": 1},
         []),
        ("retinanet_detection_output", {
            "BBoxes": [(0.2 * r.standard_normal((2, 6, 4))).astype(
                np.float32), (0.2 * r.standard_normal((2, 3, 4))).astype(
                    np.float32)],
            "Scores": det_scores, "Anchors": det_anchors,
            "ImInfo": np.array([[40.0, 36.0, 1.0], [60.0, 60.0, 2.0]],
                               np.float32)}, {},
         {"score_threshold": 0.85, "nms_top_k": 5, "keep_top_k": 6,
          "nms_threshold": 0.4, "nms_eta": 1.0}, {"Out": 1}, []),
    ]


def _grid_anchors(fh, fw, stride, sizes):
    """[fh, fw, len(sizes), 4] square pixel anchors centred at (j + 0.5)
    stride, as anchor_generator lays them out."""
    c = (np.arange(max(fh, fw)) + 0.5) * stride
    half = np.asarray(sizes, np.float64) / 2
    cy = c[:fh, None, None]
    cx = c[None, :fw, None]
    a = np.stack(np.broadcast_arrays(cx - half, cy - half, cx + half,
                                     cy + half), axis=-1)
    return a.astype(np.float32)


# the RoI ops' maps: two images, 2 channels of 6 x 7
ROI_LOD = [[0, 1, 4]]       # one RoI in image 0, three in image 1


def _roi_inputs(r):
    """(X [2, 2, 6, 7], ROIs [4, 4] in pixels at scale 0.5): a RoI
    reaching past the map's right and bottom edges, one under a pixel
    wide, one beyond the map (roi_pool's empty bins); X holds a block of
    tied values under the first RoI's top-left bin."""
    x = _f32(r, 2, 2, 6, 7)
    x[0, :, 0:2, 0:2] = 0.75            # a tie in a bin
    rois = np.array([[0.4, 0.6, 5.2, 7.0], [6.4, 4.2, 13.8, 11.7],
                     [3.1, 2.2, 3.5, 9.4], [16.2, 15.3, 22.6, 20.1]],
                    np.float32)
    return x, rois


def two_stage_cases() -> List[tuple]:
    """(op type, inputs, {input name: LoD}, attrs, {output slot: count},
    [input slots to differentiate]) of the two-stage detectors' ten ops:
    roi_align (a RoI past the map's edge, one under a pixel, sampling
    ratio 2 and 1), roi_pool (an empty bin, a bin of tied values, one of
    relu zeros), psroi_pool, roi_perspective_transform, on a LoD of two
    images; generate_proposals (min_size filtering, eta 1 and eta < 1);
    rpn_target_assign (a single-box image, a crowd box, two boxes whose
    best anchor is the same; the last case a crowd and a non-crowd box on
    one anchor, which the JAX lowering leaves to its scatter's order);
    generate_proposal_labels (ImInfo scales 1 and 2, a crowd box);
    generate_mask_labels at one image and at two (the JAX lowering matches
    across the images there); distribute_fpn_proposals and
    collect_fpn_proposals (a tie). Sampling is use_random=False: the
    first samples in order."""
    r = np.random.default_rng(23)
    x, rois = _roi_inputs(r)
    relu = np.maximum(_f32(r, 2, 2, 6, 7), 0.0)
    ps = _f32(r, 2, 8, 5, 6)
    quads = np.array([[1.0, 1.5, 9.0, 0.5, 10.5, 8.0, 0.5, 9.5],
                      [4.0, 2.0, 12.0, 3.0, 11.0, 11.5, 3.5, 10.0],
                      [0.5, 0.5, 13.5, 0.5, 13.5, 11.5, 0.5, 11.5]],
                     np.float32)
    roi_lod = {"rois": ROI_LOD}
    # generate_proposals: 3 anchors a cell of a 3 x 4 map at stride 8
    anchors = _grid_anchors(3, 4, 8.0, [12.0, 18.0, 26.0])
    scores = r.uniform(0.05, 0.95, (2, 3, 3, 4)).astype(np.float32)
    deltas = (0.2 * r.standard_normal((2, 12, 3, 4))).astype(np.float32)
    info = np.array([[24.0, 30.0, 1.0], [20.0, 32.0, 2.0]], np.float32)
    ones = np.ones_like(anchors)
    gp = {"Scores": scores, "BboxDeltas": deltas, "ImInfo": info,
          "Anchors": anchors, "Variances": ones}
    gp_out = {"RpnRois": 1, "RpnRoiProbs": 1}
    # rpn_target_assign: 2 anchors a cell of a 4 x 5 map at stride 12
    ra = _grid_anchors(4, 5, 12.0, [10.0, 18.0]).reshape(-1, 4)
    gt = np.stack([ra[4] + [1.0, -1.0, 2.0, 1.0],       # image 0, alone
                   ra[13] + [0.5, 0.5, 1.0, 0.0],       # two boxes whose
                   ra[13] + [-2.0, -2.0, 2.0, 2.0],     # best anchor is 13
                   ra[20] + [0.0, 0.0, 3.0, 3.0]])      # a crowd box
    gt = gt.astype(np.float32)
    crowd = np.array([[0], [0], [0], [1]], np.int32)
    rinfo = np.array([[48.0, 60.0, 1.0], [44.0, 56.0, 1.0]], np.float32)
    ra_attrs = {"rpn_batch_size_per_im": 8, "rpn_straddle_thresh": 0.0,
                "rpn_fg_fraction": 0.5, "rpn_positive_overlap": 0.7,
                "rpn_negative_overlap": 0.3, "use_random": False}
    ra_out = {"LocationIndex": 1, "ScoreIndex": 1, "TargetLabel": 1,
              "TargetBBox": 1, "BBoxInsideWeight": 1}
    # the crowd box of image 1 (its IoUs all 0) picks the image's first
    # inside anchor, anchor 0; so does a non-crowd box at IoU 0.36
    conflict = gt.copy()
    conflict[2] = ra[0] + [3.0, 3.0, 3.0, 3.0]
    # generate_proposal_labels: RoIs around the boxes of two images, the
    # second's at ImInfo scale 2
    pgt = np.array([[4.0, 6.0, 20.0, 22.0], [2.0, 3.0, 14.0, 12.0],
                    [16.0, 10.0, 30.0, 26.0], [6.0, 14.0, 18.0, 28.0]],
                   np.float32)
    jitter = r.uniform(-3.0, 3.0, (12, 4)).astype(np.float32)
    prois = np.concatenate([pgt[[0, 0, 0]] + jitter[:3],
                            _pixel_boxes(r, 2, 0.0, 20.0, (4.0, 10.0)),
                            2 * (pgt[[1, 2, 2, 3]] + jitter[3:7]),
                            2 * _pixel_boxes(r, 3, 0.0, 20.0, (4.0, 10.0))])
    pl = {"RpnRois": prois, "GtClasses": np.array([[3], [1], [4], [2]],
                                                  np.int32),
          "IsCrowd": np.array([[0], [0], [0], [1]], np.int32),
          "GtBoxes": pgt, "ImInfo": np.array([[32.0, 32.0, 1.0],
                                              [64.0, 64.0, 2.0]],
                                             np.float32)}
    pl_lod = {"rpnrois": [[0, 5, 12]], "gtclasses": [[0, 1, 4]],
              "iscrowd": [[0, 1, 4]], "gtboxes": [[0, 1, 4]]}
    pl_attrs = {"batch_size_per_im": 8, "fg_fraction": 0.25,
                "fg_thresh": 0.5, "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
                "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2], "class_nums": 5,
                "use_random": False}
    pl_out = {"Rois": 1, "LabelsInt32": 1, "BboxTargets": 1,
              "BboxInsideWeights": 1, "BboxOutsideWeights": 1}
    # generate_mask_labels
    segs = np.array([[2.0, 2.0, 12.0, 14.0], [10.0, 4.0, 24.0, 16.0],
                     [4.0, 12.0, 20.0, 26.0]], np.float32)
    mrois = np.concatenate([segs[[0, 1, 2]] + jitter[:3],
                            segs[[2, 0]] + jitter[3:5]])
    mask = {"ImInfo": info[:1], "GtClasses": np.array([[1], [2], [3]],
                                                      np.int32),
            "IsCrowd": np.zeros((3, 1), np.int32), "GtSegms": segs,
            "Rois": mrois, "LabelsInt32": np.array([[1], [2], [0], [3],
                                                    [1]], np.int32)}
    mask_out = {"MaskRois": 1, "RoiHasMaskInt32": 1, "MaskInt32": 1}
    # FPN routing: sides from 20 to 600 pixels, away from the level
    # boundaries (224 * 2^k)
    side = np.array([20.0, 70.0, 150.0, 300.0, 600.0, 90.0, 40.0, 180.0],
                    np.float32)
    xy = r.uniform(0.0, 50.0, (8, 2)).astype(np.float32)
    fpn = np.concatenate([xy, xy + side[:, None] *
                          np.array([[1.0, 0.8]], np.float32)], axis=1)
    lv_scores = [r.uniform(0, 1, (n, 1)).astype(np.float32)
                 for n in (4, 3, 2)]
    lv_scores[1][0, 0] = lv_scores[0][2, 0]          # a tie
    return [
        ("roi_align", {"X": x, "ROIs": rois}, roi_lod,
         {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.5,
          "sampling_ratio": -1}, {"Out": 1}, ["X"]),
        ("roi_align", {"X": x, "ROIs": rois[:3]}, {},
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5,
          "sampling_ratio": 1}, {"Out": 1}, ["X"]),
        ("roi_pool", {"X": x, "ROIs": rois}, roi_lod,
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5},
         {"Out": 1, "Argmax": 1}, ["X"]),
        ("roi_pool", {"X": relu, "ROIs": rois}, roi_lod,
         {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 0.5},
         {"Out": 1, "Argmax": 1}, ["X"]),
        ("psroi_pool", {"X": ps, "ROIs": rois}, roi_lod,
         {"output_channels": 2, "pooled_height": 2, "pooled_width": 2,
          "spatial_scale": 0.5}, {"Out": 1}, ["X"]),
        ("roi_perspective_transform", {"X": x, "ROIs": quads},
         {"rois": [[0, 2, 3]]},
         {"transformed_height": 3, "transformed_width": 4,
          "spatial_scale": 0.5}, {"Out": 1}, ["X"]),
        ("generate_proposals", gp, {},
         {"pre_nms_topN": 20, "post_nms_topN": 8, "nms_thresh": 0.5,
          "min_size": 6.0, "eta": 1.0}, gp_out, []),
        ("generate_proposals", dict(gp, Variances=np.broadcast_to(
            np.array([0.5, 0.5, 1.0, 1.0], np.float32), anchors.shape)
            .copy()), {},
         {"pre_nms_topN": -1, "post_nms_topN": 30, "nms_thresh": 0.9,
          "min_size": 0.0, "eta": 0.8}, gp_out, []),
        ("rpn_target_assign", {"Anchor": ra, "GtBoxes": gt,
                               "IsCrowd": crowd, "ImInfo": rinfo},
         {"gtboxes": [[0, 1, 4]]}, ra_attrs, ra_out, []),
        ("rpn_target_assign", {"Anchor": ra, "GtBoxes": gt[:3],
                               "IsCrowd": crowd[:3], "ImInfo": rinfo[:1]},
         {}, dict(ra_attrs, rpn_batch_size_per_im=6,
                  rpn_positive_overlap=0.6, rpn_straddle_thresh=2.0),
         ra_out, []),
        ("rpn_target_assign", {"Anchor": ra, "GtBoxes": conflict,
                               "IsCrowd": np.array([[0], [0], [0], [1]],
                                                   np.int32),
                               "ImInfo": rinfo},
         {"gtboxes": [[0, 1, 4]]}, ra_attrs, ra_out, []),
        ("generate_proposal_labels", pl, pl_lod, pl_attrs, pl_out, []),
        ("generate_mask_labels", mask, {"rois": [[0, 5]],
                                        "gtsegms": [[0, 3]]},
         {"num_classes": 4, "resolution": 4}, mask_out, []),
        ("generate_mask_labels", dict(mask, ImInfo=info),
         {"rois": [[0, 3, 5]], "gtsegms": [[0, 2, 3]]},
         {"num_classes": 4, "resolution": 4}, mask_out, []),
        ("distribute_fpn_proposals", {"FpnRois": fpn}, {},
         {"min_level": 2, "max_level": 5, "refer_level": 4,
          "refer_scale": 224}, {"MultiFpnRois": 4, "RestoreIndex": 1},
         []),
        ("collect_fpn_proposals", {
            "MultiLevelRois": [fpn[:4], fpn[4:7], fpn[6:]],
            "MultiLevelScores": lv_scores}, {}, {"post_nms_topN": 6},
         {"FpnRois": 1}, []),
    ]


# CTC: four sequences of T = 4, 5, 2 and 6 steps over 5 classes (blank
# 0): a label of two, an empty one, a repeat in two steps (infeasible:
# it needs three) and a feasible repeat
CTC_T_LOD = [[0, 4, 9, 11, 17]]
CTC_L_LOD = [[0, 2, 2, 4, 7]]
CTC_LABEL = np.array([[1], [2], [3], [3], [1], [1], [3]], np.int32)
# chunk_eval: tags of three sequences, 3 chunk types
CHUNK_LOD = [[0, 6, 10, 15]]


def _chunk_case(r, scheme, excluded=()):
    n_tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]
    outside = 3 * n_tags
    lab = r.integers(0, outside + 1, (15, 1)).astype(np.int64)
    inf = lab.copy()
    flip = r.random(15) < 0.35
    inf[flip, 0] = r.integers(0, outside + 1, int(flip.sum()))
    return ("chunk_eval", {"Inference": inf, "Label": lab},
            {"inference": CHUNK_LOD, "label": CHUNK_LOD},
            {"num_chunk_types": 3, "chunk_scheme": scheme,
             "excluded_chunk_types": list(excluded)},
            {"Precision": 1, "Recall": 1, "F1-Score": 1,
             "NumInferChunks": 1, "NumLabelChunks": 1,
             "NumCorrectChunks": 1}, [])


# the random draws of nce and of sample_logits without
# CustomizedSamples: a case of these ops is held to nce_numpy /
# sample_logits_numpy on the samples its run drew
def drawn(case) -> bool:
    return case[0] == "nce" or (case[0] == "sample_logits" and
                                "CustomizedSamples" not in case[1])


def nlp_cases() -> List[tuple]:
    """(op type, inputs, {input name: LoD}, attrs, {output slot: count},
    [input slots to differentiate]) of slice 24's eleven ops: warpctc
    (a label of length 0, a repeat, an infeasible alignment;
    norm_by_times both ways), ctc_align (an all-blank sequence; a batch
    that decodes to nothing), nce (the uniform, log-uniform and custom
    samplers; SampleWeight), hierarchical_sigmoid (a label whose code is
    a power of two), sample_logits (CustomizedSamples with an
    accidental hit; log-uniform draws), bilinear_tensor_product,
    chunk_eval (each scheme, one type excluded), auc (stats that are
    not zero), mean_iou, precision_recall and positive_negative_pair
    (tied scores, two queries, accumulated pairs)."""
    r = np.random.default_rng(24)
    logits = _f32(r, 17, 5)
    ctc_lods = {"logits": CTC_T_LOD, "label": CTC_L_LOD}
    ids = np.array([[1], [1], [0], [2], [2], [0], [0], [0], [3], [3], [0],
                    [3]], np.int64)
    x, lab = _f32(r, 6, 4), np.array([[2], [0], [5], [3], [2], [1]],
                                     np.int64)
    nce_w, nce_b = _f32(r, 7, 4), _f32(r, 7, 1)
    nce_in = {"Input": x, "Label": lab, "Weight": nce_w, "Bias": nce_b}
    nce_out = {"Cost": 1, "SampleLogits": 1, "SampleLabels": 1}
    probs = np.array([0.3, 0.05, 0.2, 0.1, 0.15, 0.12, 0.08], np.float32)
    sl_out = {"SampledLogits": 1, "Samples": 1, "Probabilities": 1,
              "SampledLabels": 1}
    sl_logits = _f32(r, 4, 9)
    sl_labels = np.array([[2], [7], [0], [4]], np.int64)
    # row 1 samples its own label 7 (an accidental hit), row 3 a repeat
    custom = np.array([[2, 5, 1, 8], [7, 3, 7, 0], [0, 6, 2, 2],
                       [4, 4, 1, 3]], np.int64)
    custom_p = r.uniform(0.05, 0.5, (4, 4)).astype(np.float32)
    score = r.uniform(0, 1, (8, 2)).astype(np.float32)
    score[3, 1] = score[5, 1]                    # a tie within query 0
    qid = np.array([[0], [0], [1], [0], [1], [0], [1], [1]], np.int64)
    rank = np.array([[2.0], [0.0], [1.0], [1.0], [0.0], [2.0], [2.0],
                     [1.0]], np.float32)
    stat = r.integers(0, 5, 16).astype(np.float32)
    auc_pred = np.stack([1 - (p := r.uniform(0, 1, 12)), p], 1).astype(
        np.float32)
    return [
        ("warpctc", {"Logits": logits, "Label": CTC_LABEL}, ctc_lods,
         {"blank": 0, "norm_by_times": False}, {"Loss": 1}, ["Logits"]),
        ("warpctc", {"Logits": logits, "Label": CTC_LABEL}, ctc_lods,
         {"blank": 0, "norm_by_times": True}, {"Loss": 1}, ["Logits"]),
        ("warpctc", {"Logits": logits[:9], "Label": CTC_LABEL[:2]},
         {"logits": [[0, 4, 9]], "label": [[0, 2, 2]]},
         {"blank": 4, "norm_by_times": False}, {"Loss": 1}, ["Logits"]),
        ("ctc_align", {"Input": ids}, {"input": [[0, 4, 8, 12]]},
         {"blank": 0, "merge_repeated": True}, {"Output": 1}, []),
        ("ctc_align", {"Input": np.zeros((5, 1), np.int64)},
         {"input": [[0, 2, 5]]}, {"blank": 0, "merge_repeated": True},
         {"Output": 1}, []),
        ("nce", dict(nce_in), {}, {"num_total_classes": 7,
                                   "num_neg_samples": 3, "sampler": 0},
         nce_out, ["Input", "Weight", "Bias"]),
        ("nce", dict(nce_in, SampleWeight=r.uniform(
            0.5, 2, (6, 1)).astype(np.float32)), {},
         {"num_total_classes": 7, "num_neg_samples": 4, "sampler": 1},
         nce_out, ["Input", "Weight", "Bias"]),
        ("nce", dict(nce_in, CustomDistProbs=probs), {},
         {"num_total_classes": 7, "num_neg_samples": 5, "sampler": 2},
         nce_out, ["Input", "Weight", "Bias"]),
        ("hierarchical_sigmoid", {"Input": x, "W": _f32(r, 5, 4),
                                  "Label": lab % 6, "Bias": _f32(r, 1, 5)},
         {}, {"num_classes": 6}, {"Out": 1, "PreOut": 1},
         ["Input", "W", "Bias"]),
        ("hierarchical_sigmoid", {"Input": x, "W": _f32(r, 7, 4),
                                  "Label": np.array([[0], [7], [3], [1],
                                                     [6], [4]], np.int64)},
         {}, {"num_classes": 8}, {"Out": 1, "PreOut": 1}, ["Input", "W"]),
        ("sample_logits", {"Logits": sl_logits, "Labels": sl_labels,
                           "CustomizedSamples": custom,
                           "CustomizedProbabilities": custom_p}, {},
         {"num_samples": 3, "remove_accidental_hits": True}, sl_out,
         ["Logits"]),
        ("sample_logits", {"Logits": sl_logits, "Labels": sl_labels}, {},
         {"num_samples": 6, "remove_accidental_hits": True}, sl_out,
         ["Logits"]),
        ("bilinear_tensor_product", {"X": _f32(r, 3, 4), "Y": _f32(r, 3, 5),
                                     "Weight": _f32(r, 2, 4, 5),
                                     "Bias": _f32(r, 1, 2)}, {}, {},
         {"Out": 1}, ["X", "Y", "Weight", "Bias"]),
        _chunk_case(r, "IOB"),
        _chunk_case(r, "IOE"),
        _chunk_case(r, "IOBES"),
        _chunk_case(r, "plain"),
        _chunk_case(r, "IOB", excluded=(1,)),
        ("auc", {"Predict": auc_pred,
                 "Label": (r.random((12, 1)) < 0.5).astype(np.int64),
                 "StatPos": stat, "StatNeg": stat[::-1].copy()}, {},
         {"num_thresholds": 15}, {"AUC": 1, "StatPosOut": 1,
                                  "StatNegOut": 1}, []),
        ("mean_iou", {"Predictions": r.integers(0, 4, (10,)).astype(
            np.int32), "Labels": r.integers(0, 4, (10,)).astype(np.int32)},
         {}, {"num_classes": 5}, {"OutMeanIou": 1, "OutWrong": 1,
                                  "OutCorrect": 1}, []),
        ("precision_recall", {
            "MaxProbs": r.uniform(0, 1, (9, 1)).astype(np.float32),
            "Indices": r.integers(0, 4, (9, 1)).astype(np.int32),
            "Labels": r.integers(0, 4, (9, 1)).astype(np.int32),
            "Weights": r.uniform(0.5, 2, (9, 1)).astype(np.float32),
            "StatesInfo": r.integers(0, 6, (4, 4)).astype(np.float32)},
         {}, {"class_number": 4}, {"BatchMetrics": 1, "AccumMetrics": 1,
                                   "AccumStatesInfo": 1}, []),
        ("positive_negative_pair", {"Score": score, "Label": rank,
                                    "QueryID": qid}, {}, {"column": -1},
         {"PositivePair": 1, "NegativePair": 1, "NeutralPair": 1}, []),
        ("positive_negative_pair", {
            "Score": score, "Label": rank, "QueryID": qid,
            "Weight": r.uniform(0.5, 2, (8, 1)).astype(np.float32),
            "AccumulatePositivePair": np.array([2.0], np.float32),
            "AccumulateNegativePair": np.array([1.0], np.float32),
            "AccumulateNeutralPair": np.array([0.5], np.float32)}, {},
         {"column": 0}, {"PositivePair": 1, "NegativePair": 1,
                         "NeutralPair": 1}, []),
    ]


def quant_cases() -> List[tuple]:
    """Slice 25's nine fake-quantize ops and misc.py's quantize,
    dequantize, requantize and fsp (fsp's inputs on a dyadic grid with
    H * W = 16: its sums are exact in any order)."""
    rng = np.random.default_rng(2024)
    x = _normal(rng, 4, 3, 5, 5)
    w = _normal(rng, 6, 3, 3, 3, scale=0.2)
    act = _normal(rng, 8, 16)
    grid = np.round(x * 40).astype(np.float32)
    wgrid = np.round(w * 300).astype(np.float32)
    ma = {"InScale": _scalar(0.4), "InAccum": _scalar(0.9), "InState": _scalar(2.1)}
    raw = [
        ("fake_quantize_abs_max", {"X": x}, ["Out", "OutScale"],
         {"bit_length": 8}, ["X"]),
        ("fake_quantize_abs_max", {"X": act}, ["Out", "OutScale"],
         {"bit_length": 4}, ["X"]),
        ("fake_quantize_dequantize_abs_max", {"X": x}, ["Out", "OutScale"],
         {"bit_length": 8}, ["X"]),
        ("fake_channel_wise_quantize_abs_max", {"X": w},
         ["Out", "OutScale"], {"bit_length": 8}, ["X"]),
        ("fake_channel_wise_quantize_abs_max", {"X": act},
         ["Out", "OutScale"], {"bit_length": 8}, ["X"]),
        ("fake_dequantize_max_abs", {"X": grid, "Scale": _scalar(2.5)},
         ["Out"], {"max_range": 127.0}, ["X"]),
        ("fake_channel_wise_dequantize_max_abs",
         {"X": wgrid, "Scales": [np.abs(w).max(axis=(1, 2, 3))]}, ["Out"],
         {"quant_bits": [8]}, ["X"]),
        ("fake_channel_wise_dequantize_max_abs",
         {"X": wgrid, "Scales": [np.abs(w).max(axis=(1, 2, 3)),
                                 _scalar(3.0)]}, ["Out"],
         {"quant_bits": [8, 8]}, ["X"]),
        ("fake_quantize_range_abs_max",
         {"X": x, "InScale": _scalar(0.3), "Iter": np.array([3], np.int64),
          "OutScales": np.abs(_normal(rng, 10))},
         ["Out", "OutScale", "OutScales", "IterOut"],
         {"bit_length": 8, "window_size": 10, "is_test": False}, ["X"]),
        ("fake_quantize_range_abs_max",
         {"X": x, "InScale": _scalar(1.7), "Iter": np.array([3], np.int64),
          "OutScales": np.zeros(10, np.float32)}, ["Out", "OutScale"],
         {"bit_length": 8, "window_size": 10, "is_test": True}, ["X"]),
        ("fake_quantize_moving_average_abs_max", dict(ma, X=x),
         ["Out", "OutScale", "OutAccum", "OutState"],
         {"bit_length": 8, "moving_rate": 0.9, "is_test": False}, ["X"]),
        ("fake_quantize_moving_average_abs_max", dict(ma, X=x),
         ["Out", "OutScale"],
         {"bit_length": 8, "moving_rate": 0.9, "is_test": True}, ["X"]),
        ("fake_quantize_dequantize_moving_average_abs_max", dict(ma, X=x),
         ["Out", "OutScale", "OutAccum", "OutState"],
         {"bit_length": 8, "moving_rate": 0.9, "is_test": False}, ["X"]),
        ("fake_quantize_dequantize_moving_average_abs_max", dict(ma, X=x),
         ["Out", "OutScale"],
         {"bit_length": 8, "moving_rate": 0.9, "is_test": True}, ["X"]),
        ("moving_average_abs_max_scale",
         {"X": x, "InAccum": _scalar(0.9), "InState": _scalar(2.1)},
         ["Out", "OutScale", "OutAccum", "OutState"],
         {"moving_rate": 0.9, "is_test": False}, ["X"]),
        ("quantize", {"Input": x}, ["Output"], {"Scale": 31.75}, []),
        ("dequantize", {"Input": np.round(x * 30).astype(np.int8)},
         ["Output"], {"Scale": 31.75}, []),
        ("requantize", {"Input": np.round(x * 30).astype(np.int8)},
         ["Output"], {"Scale_in": 31.75, "Scale_out": 12.5}, []),
        # a dyadic grid and H * W = 16: every product, sum and quotient
        # is exact
        ("fsp", {"X": np.round(x[..., :4, :4] * 4) / 4,
                 "Y": np.round(x[:, :2, :4, :4] * 8) / 8},
         ["Out"], {}, ["X", "Y"]),
    ]
    return [(t, ins, attrs, {s: 1 for s in outs}, diff)
            for t, ins, outs, attrs, diff in raw]


def _dyadic(rng, shape, per_channel=False):
    """Values on a grid of 1/16 in (-2, 2) whose abs max is 2 (a
    channel's, per channel): the products and sums of the gradients'
    scale terms are then exact in any order."""
    v = np.clip(np.round(rng.standard_normal(shape) * 16) / 16,
                -1.9375, 1.9375).astype(np.float32)
    flat = v.reshape(shape[0], -1) if per_channel else v.reshape(1, -1)
    flat[:, 0] = 2.0
    return v


def quant_grad_cases() -> List[tuple]:
    """The quant_cases with a gradient, on dyadic inputs (and a moving
    rate of 0.5 from a state of 2 and an accumulator of 0, so the
    moving-average scale is 1): the gradient of a scale reached from x
    is a sum over the tensor, exact in any order (XLA's, torch's on
    either device)."""
    rng = np.random.default_rng(11)
    x = _dyadic(rng, (4, 3, 5, 5))
    w = _dyadic(rng, (6, 3, 3, 3), per_channel=True)
    ma = {"InScale": _scalar(1.0), "InAccum": _scalar(0.0),
          "InState": _scalar(2.0)}
    out = []
    for op_type, inputs, attrs, outs, diff in quant_cases():
        if not diff:
            continue
        inputs = dict(inputs)
        attrs = dict(attrs)
        if "X" in inputs and op_type != "fsp" and \
                not op_type.startswith("fake_dequantize") and \
                not op_type.startswith("fake_channel_wise_dequantize"):
            inputs["X"] = w if op_type.startswith("fake_channel_wise") \
                else x
        if "moving_rate" in attrs:
            inputs.update({k: v for k, v in ma.items() if k in inputs})
            attrs["moving_rate"] = 0.5
        if op_type == "fake_quantize_range_abs_max":
            inputs["OutScales"] = np.minimum(inputs["OutScales"], 1.0)
        out.append((op_type, inputs, attrs, outs, diff))
    return out


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _scalar(a):
    return np.asarray([a], np.float32)


def _softplus(v):
    return np.logaddexp(v, np.float32(0)).astype(v.dtype)


def _sigmoid(v):
    return (1.0 / (1.0 + np.exp(-v))).astype(v.dtype)


def nce_numpy(inputs, attrs, samples, cot=None):
    """The nce cost ([B, 1] float32) of the JAX op's formula
    (paddle_tpu/ops/nlp.py's nce) on the samples `samples` ([B, nt + k]:
    the labels, then the noise), and with `cot` (the cost's cotangent)
    the gradients of Input, Weight and Bias."""
    x, w = inputs["Input"], inputs["Weight"]
    bias = inputs.get("Bias")
    C, k = int(attrs["num_total_classes"]), int(attrs["num_neg_samples"])
    sampler = int(attrs.get("sampler", 0))
    B = x.shape[0]
    nt = samples.shape[1] - k
    samples = samples.astype(np.int64)
    f = np.float32
    if sampler == 1:
        s = samples.astype(f)
        q = np.log(np.log((s + f(2)) / (s + f(1))) / np.log(f(C + 1)))
    elif sampler == 2:
        q = np.log(np.maximum(inputs["CustomDistProbs"][samples], f(1e-30)))
    else:
        q = np.full(samples.shape, -np.log(f(C)), f)
    logits = np.einsum("bd,bsd->bs", x, w[samples]).astype(f)
    if bias is not None:
        logits = logits + bias.reshape(-1)[samples]
    adj = logits - (q + np.log(f(k)))
    cost = (_softplus(-adj[:, :nt]).sum(1) +
            _softplus(adj[:, nt:]).sum(1)).reshape(B, 1)
    sw = inputs.get("SampleWeight")
    scale = sw.reshape(B, 1) if sw is not None else np.ones((B, 1), f)
    if cot is None:
        return cost * scale
    g = cot.reshape(B, 1) * scale * np.concatenate(
        [-_sigmoid(-adj[:, :nt]), _sigmoid(adj[:, nt:])], axis=1)
    gx = np.einsum("bs,bsd->bd", g, w[samples]).astype(f)
    gw = np.zeros_like(w)
    np.add.at(gw, samples.reshape(-1),
              (g[..., None] * x[:, None, :]).reshape(-1, x.shape[1]))
    grads = {"Input": gx, "Weight": gw}
    if bias is not None:
        gb = np.zeros(bias.size, f)
        np.add.at(gb, samples.reshape(-1), g.reshape(-1))
        grads["Bias"] = gb.reshape(bias.shape)
    return cost * scale, grads


def sample_logits_numpy(inputs, attrs, samples, cot=None):
    """sample_logits' SampledLogits and Probabilities (the JAX op's
    formula) on `samples` (log-uniform q), and with `cot` the gradient
    of Logits."""
    logits, labels = inputs["Logits"], inputs["Labels"].astype(np.int64)
    B, C = logits.shape
    nt = labels.shape[1]
    f = np.float32
    samples = samples.astype(np.int64)
    s = samples.astype(f)
    probs = (np.log((s + f(2)) / (s + f(1))) / np.log(f(C + 1))).astype(f)
    out = np.take_along_axis(logits, samples, 1) - \
        np.log(np.maximum(probs, f(1e-30)))
    if attrs.get("remove_accidental_hits", True):
        hit = (samples[:, None, :] == labels[:, :, None]).any(1)
        hit[:, :nt] = False
        out = np.where(hit, out + f(-1e30), out)
    if cot is None:
        return out.astype(f), probs
    g = np.zeros_like(logits)
    np.add.at(g, (np.repeat(np.arange(B), samples.shape[1]),
                  samples.reshape(-1)), cot.reshape(-1))
    return out.astype(f), probs, {"Logits": g}


def run_grad(op_type, inputs, attrs, out_slots, diff, device, lods,
             fwd, cot):
    """`<op_type>_grad`'s lowering on `device`: the generic vjp of the
    forward (which runs again, drawing what `fwd`'s run drew) under the
    cotangents `cot` ({output slot: numpy}) of the forward outputs
    `fwd` ({output name: tensor}, named as run() names them). Returns
    {input slot: gradient tensor} for the slots `diff`."""
    env, ins = {}, {}
    for s, v in inputs.items():
        ins[s] = _names(s, v)
        for n, a in zip(ins[s], v if isinstance(v, list) else [v]):
            env[n] = torch.from_numpy(np.array(a)).to(device)
    for s, n in out_slots.items():
        names = [f"{s.lower()}_out{i}" for i in range(n)]
        ins[s] = names
        env.update((m, fwd[m]) for m in names)
        if s in cot:
            ins[s + "@GRAD"] = [names[0] + "@g"]
            env[names[0] + "@g"] = torch.from_numpy(cot[s]).to(device)
    outs = {s + "@GRAD": [f"{s.lower()}@g"] for s in diff}
    view = _SlotView(op_type + "_grad", ins, outs, dict(attrs))
    OPS.get(op_type + "_grad").lowering(ExecContext(
        view, env, torch.device(device), None, dict(lods or {})))
    return {s: env[f"{s.lower()}@g"] for s in diff}


def _names(slot, value):
    if isinstance(value, list):
        return [f"{slot.lower()}{i}" for i in range(len(value))]
    return [slot.lower()]


def run(op_type, inputs, attrs, out_slots, device, lods=None):
    """Op `op_type`'s lowering on `device`, eagerly, on the inputs
    (numpy); returns ({output name: tensor}, {output name: LoD}). An
    output slot of count n is named <slot>_out0 .. n-1."""
    outs = {s: [f"{s.lower()}_out{i}" for i in range(n)]
            for s, n in out_slots.items()}
    env, ins = {}, {}
    for s, v in inputs.items():
        ins[s] = _names(s, v)
        for n, a in zip(ins[s], v if isinstance(v, list) else [v]):
            env[n] = torch.from_numpy(np.array(a)).to(device)
    lod_env = dict(lods or {})
    view = _SlotView(op_type, ins, outs, dict(attrs))
    OPS.get(op_type).lowering(ExecContext(view, env, torch.device(device),
                                          None, lod_env))
    names = [n for ns in outs.values() for n in ns]
    return {n: env[n] for n in names}, {n: lod_env.get(n) for n in names}
