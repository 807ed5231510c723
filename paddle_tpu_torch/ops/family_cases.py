"""One case or more a op type of the basic, reduce, elementwise,
activation and nn op families (ops/basic.py, reduce.py, elementwise.py,
activations.py, nn.py), the nine update ops that have no kernel
(optimizer_ops.py: lars_momentum ... lamb), the value-dependent sequence
ops and SSD's detection ops (detection.py, on LoD inputs), on seeded
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

__all__ = ["cases", "sequence_cases", "detection_cases", "run"]


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
