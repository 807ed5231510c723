"""One-op parity: each forward op type on Transformer inference's and
training's path (and the serving book LM's unsqueeze, the book models'
square and cos_sim, and the comparison, logical, fill, assign and
increment ops of the control-flow programs) runs through the JAX
package's lowering and the port's lowering on the same numpy inputs,
made from a seed. (The grad ops are
held against the JAX package in tests/test_torch_backward.py, adam in
tests/test_torch_training.py; dropout's random branch, which cannot draw
the JAX package's bits, in tests/test_torch_training.py too.)

Tolerance: float32 results agree to 1e-5 relative and 1e-6 absolute
(only the order of float32 sums differs between XLA and torch on the
CPU); integer and fill results are exact. gaussian_random cannot agree
bit for bit (jax.random and torch draw different numbers from one seed),
so both draws are held to the requested mean and std, each within five
standard errors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS

import paddle_tpu_torch  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.ops import family_cases

RTOL, ATOL = 1e-5, 1e-6


class _Op:
    """The op view both registries' ExecContexts read."""

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self._inputs = {s: [s.lower()] for s in inputs}
        self._outputs = {s: [s.lower() + "_out"] for s in outputs}
        self._attrs = dict(attrs)

    def input(self, slot):
        return self._inputs.get(slot, [])

    def output(self, slot):
        return self._outputs.get(slot, [])

    def input_slots(self):
        return list(self._inputs)

    def output_slots(self):
        return list(self._outputs)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)

    def has_attr(self, name):
        return name in self._attrs

    def all_attrs(self):
        return dict(self._attrs)

    def _all_attrs(self):
        return self._attrs.items()


def _run_both(op_type, inputs, outputs, attrs):
    """Returns {slot: (jax numpy result, port numpy result)}."""
    op = _Op(op_type, inputs, outputs, attrs)
    jenv = {s.lower(): jnp.asarray(a) for s, a in inputs.items()}
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv))
    penv = {s.lower(): torch.from_numpy(np.array(a))
            for s, a in inputs.items()}
    PT_OPS.get(op_type).lowering(PtContext(op, penv, torch.device("cpu")))
    return {s: (np.asarray(jenv[op.output(s)[0]]),
                penv[op.output(s)[0]].numpy()) for s in outputs}


def _rng():
    return np.random.default_rng(1234)


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _attn_inputs(rng, B=2, Sq=12, Sk=16, H=4, D=8):
    q, k, v = _f32(rng, B, Sq, H, D), _f32(rng, B, Sk, H, D), \
        _f32(rng, B, Sk, H, D)
    lens = np.array([Sk, Sk - 5])
    bias = np.where(np.arange(Sk)[None, :] < lens[:, None], 0.0,
                    -1e9).astype(np.float32)[:, None, None, :]
    return {"Q": q, "K": k, "V": v, "BiasQK": bias}


def _cases():
    rng = _rng()
    x3 = _f32(rng, 2, 3, 8)
    ids = rng.integers(0, 10, (3, 5)).astype(np.int32)
    attn = _attn_inputs(rng)
    return [
        ("fill_constant", {}, ["Out"],
         {"shape": [3, 4], "value": 2.5, "dtype": 9}),
        ("fill_constant", {}, ["Out"],
         {"shape": [5], "value": 7.0, "dtype": 5}),
        ("cast", {"X": x3 * 10}, ["Out"], {"in_dtype": 9, "out_dtype": 5}),
        ("cast", {"X": x3}, ["Out"], {"in_dtype": 9, "out_dtype": 7}),
        ("scale", {"X": x3}, ["Out"], {"scale": 1.5, "bias": 0.25}),
        ("scale", {"X": x3}, ["Out"],
         {"scale": 22.627, "bias": 0.5, "bias_after_scale": False}),
        ("reshape2", {"X": x3}, ["Out", "XShape"],
         {"shape": [0, 0, 2, 4]}),
        ("reshape2", {"X": x3}, ["Out", "XShape"], {"shape": [-1, 24]}),
        ("squeeze2", {"X": _f32(rng, 2, 5, 1)}, ["Out", "XShape"],
         {"axes": [-1]}),
        ("squeeze2", {"X": _f32(rng, 1, 5, 1)}, ["Out", "XShape"],
         {"axes": []}),
        ("lookup_table", {"W": _f32(rng, 10, 6), "Ids": ids}, ["Out"],
         {"padding_idx": -1}),
        ("lookup_table", {"W": _f32(rng, 10, 6), "Ids": ids[..., None]},
         ["Out"], {"padding_idx": 3}),
        ("mul", {"X": x3, "Y": _f32(rng, 8, 5)}, ["Out"],
         {"x_num_col_dims": 2, "y_num_col_dims": 1}),
        ("mul", {"X": _f32(rng, 4, 6), "Y": _f32(rng, 6, 3)}, ["Out"], {}),
        ("matmul", {"X": _f32(rng, 4, 6), "Y": _f32(rng, 5, 6)}, ["Out"],
         {"transpose_Y": True, "alpha": 0.5}),
        ("matmul", {"X": _f32(rng, 2, 6, 4), "Y": _f32(rng, 2, 6, 3)},
         ["Out"], {"transpose_X": True}),
        ("matmul", {"X": _f32(rng, 6), "Y": _f32(rng, 6, 3)}, ["Out"], {}),
        ("elementwise_add", {"X": x3, "Y": _f32(rng, 8)}, ["Out"],
         {"axis": 2}),
        ("elementwise_add", {"X": x3, "Y": _f32(rng, 2, 3, 8)}, ["Out"],
         {"axis": -1}),
        ("elementwise_mul", {"X": _f32(rng, 3, 5), "Y": _f32(rng, 3, 5)},
         ["Out"], {"axis": -1}),
        ("elementwise_mul", {"X": x3, "Y": _f32(rng, 3)}, ["Out"],
         {"axis": 1}),
        ("elementwise_div", {"X": np.float32(7.5),
                             "Y": np.float32(3.0)}, ["Out"], {"axis": -1}),
        ("elementwise_div", {"X": x3, "Y": _f32(rng, 8) + 3}, ["Out"],
         {"axis": -1}),
        ("relu", {"X": x3}, ["Out"], {}),
        ("reduce_sum", {"X": x3}, ["Out"],
         {"reduce_all": True, "dim": [0], "keep_dim": False}),
        ("reduce_sum", {"X": x3}, ["Out"],
         {"reduce_all": False, "dim": [1, -1], "keep_dim": True}),
        ("layer_norm", {"X": x3, "Scale": _f32(rng, 8),
                        "Bias": _f32(rng, 8)}, ["Y", "Mean", "Variance"],
         {"epsilon": 1e-5, "begin_norm_axis": 2}),
        ("layer_norm", {"X": x3}, ["Y", "Mean", "Variance"],
         {"epsilon": 1e-3, "begin_norm_axis": 1}),
        ("add_position_encoding", {"X": _f32(rng, 2, 7, 16)}, ["Out"],
         {"alpha": 1.0, "beta": 1.0}),
        ("add_position_encoding", {"X": _f32(rng, 1, 5, 6)}, ["Out"],
         {"alpha": 0.5, "beta": 2.0}),
        ("label_smoothed_softmax_xent",
         {"Logits": _f32(rng, 2, 5, 11),
          "Label": rng.integers(0, 11, (2, 5)).astype(np.int32)},
         ["Loss"], {"epsilon": 0.1}),
        ("label_smoothed_softmax_xent",
         {"Logits": _f32(rng, 6, 11),
          "Label": rng.integers(0, 11, (6, 1)).astype(np.int32)},
         ["Loss"], {"epsilon": 0.0}),
        ("fused_attention", attn, ["Out"],
         {"scale": 8 ** -0.5, "layout": "bshd", "dropout_prob": 0.1,
          "is_test": True, "causal": False}),
        ("fused_attention", attn, ["Out"],
         {"scale": -1.0, "layout": "bshd", "is_test": True,
          "causal": True}),
        ("dropout", {"X": x3}, ["Out"],
         {"dropout_prob": 0.3, "is_test": True,
          "dropout_implementation": "downgrade_in_infer"}),
        ("dropout", {"X": x3}, ["Out"],
         {"dropout_prob": 0.3, "is_test": True,
          "dropout_implementation": "upscale_in_train"}),
        ("dropout", {"X": x3}, ["Out", "Mask"],
         {"dropout_prob": 0.001, "is_test": False, "seed": 5,
          "dropout_implementation": "upscale_in_train"}),   # t = 256
        ("dropout", {"X": x3}, ["Out", "Mask"],
         {"dropout_prob": 0.999, "is_test": False, "seed": 5,
          "dropout_implementation": "upscale_in_train"}),   # t = 0
        ("fused_attention",
         {s: (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
              if s != "BiasQK" else a) for s, a in attn.items()},
         ["Out"], {"scale": 0.3, "layout": "bhsd", "causal": True}),
        # the serving book LM's decode program (inference/serving)
        ("unsqueeze2", {"X": _f32(rng, 4, 6)}, ["Out", "XShape"],
         {"axes": [1]}),
        ("unsqueeze2", {"X": _f32(rng, 3, 5)}, ["Out", "XShape"],
         {"axes": [0, -1]}),
        ("unsqueeze", {"X": _f32(rng, 2, 3)}, ["Out"], {"axes": [2, 0]}),
        ("tanh", {"X": 3 * _f32(rng, 4, 5)}, ["Out"], {}),
        # the book models' (fit_a_line, recommender_system) and the
        # control-flow programs' small ops
        ("square", {"X": x3}, ["Out"], {}),
        ("cos_sim", {"X": _f32(rng, 5, 7), "Y": _f32(rng, 5, 7)},
         ["Out", "XNorm", "YNorm"], {}),
        ("cos_sim", {"X": _f32(rng, 5, 7), "Y": _f32(rng, 1, 7)},
         ["Out", "XNorm", "YNorm"], {}),
        ("fill_constant_batch_size_like", {"Input": _f32(rng, 4, 3, 2)},
         ["Out"], {"shape": [-1, 6], "value": 1.5, "input_dim_idx": 1,
                   "output_dim_idx": 0, "dtype": 9}),
        ("fill_zeros_like", {"X": x3}, ["Out"], {}),
        ("assign", {"X": x3}, ["Out"], {}),
        ("assign_value", {}, ["Out"],
         {"shape": [2, 2], "dtype": 9, "fp32_values": [1.0, -2.0, 3.5, 0.0]}),
        ("assign_value", {}, ["Out"],
         {"shape": [3], "dtype": 5, "int32_values": [4, -1, 7]}),
        ("increment", {"X": np.array([2.0], np.float32)}, ["Out"],
         {"step": 1.5}),
        ("is_empty", {"X": x3}, ["Out"], {}),
        ("is_empty", {"X": np.zeros((0, 3), np.float32)}, ["Out"], {}),
    ] + [(op, {"X": a, "Y": b}, ["Out"], {"axis": -1})
         for op in ("less_than", "less_equal", "greater_than",
                    "greater_equal", "equal", "not_equal")
         for a, b in ((x3.round(), x3[0].round()),
                      (x3, _f32(rng, 8)))] + [
        (op, {"X": rng.standard_normal((3, 4)) > 0,
              "Y": rng.standard_normal((3, 4)) > 0}, ["Out"], {})
        for op in ("logical_and", "logical_or", "logical_xor")] + [
        ("logical_not", {"X": rng.standard_normal((3, 4)) > 0}, ["Out"],
         {})]


_CASES = _cases()


@pytest.mark.parametrize(
    "op_type,inputs,outputs,attrs", _CASES,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(_CASES)])
def test_op_matches_jax(op_type, inputs, outputs, attrs):
    for slot, (j, p) in _run_both(op_type, inputs, outputs,
                                  attrs).items():
        assert p.shape == j.shape, (slot, p.shape, j.shape)
        if np.issubdtype(j.dtype, np.floating):
            assert p.dtype == j.dtype
            np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL,
                                       err_msg=slot)
        else:
            np.testing.assert_array_equal(p, j, err_msg=slot)


def test_every_slice_op_type_is_covered():
    """Every forward op type the port registers has a case here, except
    the ones held elsewhere (see the module docstring; the ops of LeNet
    and SGD are held in test_torch_lenet.py, those of ResNet and Momentum
    in test_torch_resnet.py, those of the CTR models and Adagrad in
    test_torch_ctr.py, the sequence ops in test_torch_sequence.py, the
    recurrent ones in test_torch_rnn.py, the CRF ops in test_torch_crf.py,
    the beam-search decoder's in test_torch_beam_search.py, the basic,
    reduce, elementwise and activation families in
    test_torch_op_families.py, the nn family and the update ops without
    a kernel (the same file's cases, held in test_torch_nn_family.py and
    test_torch_optimizers.py), SSD's detection ops in
    test_torch_detection.py, the conv family in test_torch_conv_family.py,
    the one-stage detectors' ops in test_torch_one_stage_detection.py,
    the two-stage detectors' ops in test_torch_two_stage_detection.py
    slice 24's nlp and metric ops in test_torch_nlp_ops.py, and slice
    25's random ops in test_torch_random_ops.py and fake-quantize and
    int8 ops in test_torch_quantization.py)."""
    import test_torch_beam_search
    import test_torch_op_families
    import test_torch_sequence
    forward = {t for t in PT_OPS.types() if not PT_OPS.get(t).is_grad_op}
    lenet = {"conv2d", "depthwise_conv2d", "pool2d", "softmax",
             "cross_entropy", "mean", "top_k", "accuracy", "uniform_random",
             "sgd"}
    resnet = {"batch_norm", "softmax_with_cross_entropy", "momentum"}
    ctr = {"flatten", "flatten2", "concat", "sigmoid",
           "sigmoid_cross_entropy_with_logits", "elementwise_sub",
           "adagrad", "merge_selected_rows",
           "get_tensor_from_selected_rows"}
    sequence = {c[0] for c in test_torch_sequence._CASES}
    rnn = {"lstm", "gru", "lstm_unit", "gru_unit"}
    # held in test_torch_control_flow.py (the array ops, the rank-table
    # ops, and the programs of StaticRNN, DynamicRNN, IfElse, While,
    # Switch, conditional_block and Print)
    control_flow = {
        "print", "assert", "while", "conditional_block", "write_to_array",
        "read_from_array", "lod_array_length", "tensor_array_to_tensor",
        "max_sequence_len", "delete_var", "lod_rank_table",
        "lod_tensor_to_array", "array_to_lod_tensor",
        "reorder_lod_tensor_by_rank", "shrink_rnn_memory",
        "expand_to_rank_table_batch", "split_lod_tensor",
        "merge_lod_tensor", "recurrent", "py_func", "py_func_grad"}
    crf = {"linear_chain_crf", "crf_decoding"}
    beam = {c[0] for c in test_torch_beam_search._UNARY} | \
        {"beam_search", "beam_search_decode"}
    families = {c[0] for cases in test_torch_op_families.CASES.values()
                for c in cases}
    # held in test_torch_detection.py
    detection = {c[0] for c in family_cases.detection_cases()}
    # held in test_torch_conv_family.py
    conv = {c[0] for c in family_cases.conv_cases()}
    # held in test_torch_one_stage_detection.py
    one_stage = {c[0] for c in family_cases.one_stage_cases()}
    # held in test_torch_two_stage_detection.py
    two_stage = {c[0] for c in family_cases.two_stage_cases()}
    # held in test_torch_nlp_ops.py
    nlp = {c[0] for c in family_cases.nlp_cases()}
    # slice 25's: held in test_torch_random_ops.py and
    # test_torch_quantization.py
    import test_torch_quantization
    import test_torch_random_ops
    slice25 = set(test_torch_random_ops.SIX) | \
        set(test_torch_quantization.QUANT_OPS) | \
        set(test_torch_quantization.MISC_OPS)
    assert {c[0] for c in _CASES} | {"gaussian_random", "adam", "sum"} | \
        lenet | resnet | ctr | sequence | rnn | control_flow | crf | \
        beam | families | detection | conv | one_stage | two_stage | \
        nlp | slice25 == forward


@pytest.mark.parametrize("seed", [0, 11])
def test_gaussian_random_matches_jax_in_distribution(seed):
    attrs = {"shape": [64, 128], "mean": 0.5, "std": 2.0, "seed": seed,
             "dtype": 9, "__op_uid__": 3}
    outs = _run_both("gaussian_random", {}, ["Out"], attrs)["Out"]
    n = 64 * 128
    for draw in outs:
        assert draw.shape == (64, 128) and draw.dtype == np.float32
        assert abs(draw.mean() - 0.5) < 5 * 2.0 / np.sqrt(n)
        assert abs(draw.std() - 2.0) < 5 * 2.0 / np.sqrt(2 * n)
    # the port's draw is a function of (seed, program seed, op uid)
    again = _run_both("gaussian_random", {}, ["Out"], attrs)["Out"][1]
    np.testing.assert_array_equal(again, outs[1])
