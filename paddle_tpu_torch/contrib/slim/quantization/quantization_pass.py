"""Quantization-aware training passes (counterpart of
paddle_tpu/contrib/slim/quantization/quantization_pass.py). The Program
is the graph: the passes rewrite its global block in place and bump its
version, so the engine plans (and captures) it again.

* ``QuantizationTransformPass.apply(program)``: for every quantizable op
  (conv2d, depthwise_conv2d, mul) each input goes through a fake-quant
  (and dequant) op: weights through ``abs_max`` or
  ``channel_wise_abs_max``, activations through
  ``moving_average_abs_max`` (a running scale kept in the scope),
  ``range_abs_max`` or ``abs_max``. Apply it to the train program with
  ``for_test=False`` and to its ``clone(for_test=True)`` with
  ``for_test=True``: both share the scale state through the scope. The
  program is the JAX package's, op for op and name for name
  (``<x>.quant.dequant``, ``.quant_scale``, ``.quant_state``,
  ``.quant_accum``, ``.quant_iter``, ``.quant_scales``).
* ``QuantizationFreezePass.apply(test_program)``: after training, snaps
  the trained weights onto the int grid in the scope, drops the weights'
  quant ops, records each weight's scales as ``<w>.quant_scale``, and
  pins the activation quant ops to ``is_test`` so they use the trained
  running scales.
* ``ConvertToInt8Pass.apply(test_program)``: stores the int8 weights
  beside the float ones (``<w>@int8``) for export.

The passes compute in numpy on host copies of the scope's values, as the
JAX package's do (round half to even), and write back to the device the
values live on; new scale state is made on the device of the program's
parameters.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ....framework import Operator, Program
from .. import _state

__all__ = ["QuantizationTransformPass", "QuantizationFreezePass",
           "ConvertToInt8Pass"]

_QUANTIZABLE_DEFAULT = ("conv2d", "depthwise_conv2d", "mul")
# which input slots of each quantizable op carry (activation, weight)
_OP_SLOTS = {
    "conv2d": (("Input", False), ("Filter", True)),
    "depthwise_conv2d": (("Input", False), ("Filter", True)),
    "mul": (("X", False), ("Y", True)),
}
_ACT_TYPES = ("abs_max", "range_abs_max", "moving_average_abs_max")
_WEIGHT_TYPES = ("abs_max", "channel_wise_abs_max")


def _scale_name(var):
    return var + ".quant_scale"


class QuantizationTransformPass:
    """Insert fake-quant(/dequant) ops in front of quantizable ops."""

    def __init__(self, scope=None, weight_bits: int = 8,
                 activation_bits: int = 8,
                 activation_quantize_type: str = "moving_average_abs_max",
                 weight_quantize_type: str = "abs_max",
                 window_size: int = 10000, moving_rate: float = 0.9,
                 quantizable_op_type: Sequence[str] = _QUANTIZABLE_DEFAULT,
                 skip_pattern: str = "skip_quant"):
        if activation_quantize_type not in _ACT_TYPES:
            raise ValueError(
                f"activation_quantize_type must be one of {_ACT_TYPES}")
        if weight_quantize_type not in _WEIGHT_TYPES:
            raise ValueError(
                f"weight_quantize_type must be one of {_WEIGHT_TYPES}")
        self._scope = scope
        self._wbits = weight_bits
        self._abits = activation_bits
        self._act_type = activation_quantize_type
        self._w_type = weight_quantize_type
        self._window = window_size
        self._rho = moving_rate
        self._targets = tuple(quantizable_op_type)
        self._skip = skip_pattern

    # -- scope state helpers -------------------------------------------------
    def _scope_init(self, name, value):
        """Set a scale state to its start value unless the scope holds
        one (the train and test programs share it). An integer value
        (range_abs_max's iteration counter) stays int64; the JAX package
        stores it as float32, which counts exactly only to 2**24."""
        from ....executor import global_scope
        scope = self._scope or global_scope()
        v = scope.find_var(name)
        if v is None or not v.is_initialized():
            value = np.asarray(value)
            if value.dtype.kind != "i":
                value = value.astype(np.float32)
            _state.write(scope, name, value, self._device)

    def _make_var(self, block, name, shape, persistable=False):
        if block._find_var_recursive(name) is None:
            block.create_var(name=name, shape=list(shape),
                             dtype="float32", persistable=persistable)
        return name

    # -- quant-op builders ---------------------------------------------------
    def _quant_weight(self, block, name, var, for_test):
        qname = name + ".quant.dequant"
        scale = _scale_name(name)
        self._make_var(block, scale,
                       [var.shape[0]] if self._w_type ==
                       "channel_wise_abs_max" else [1], persistable=True)
        self._make_var(block, qname, var.shape)
        op_type = ("fake_channel_wise_quantize_abs_max"
                   if self._w_type == "channel_wise_abs_max"
                   else "fake_quantize_dequantize_abs_max")
        if self._w_type == "channel_wise_abs_max":
            # channel-wise has no fused quant-dequant variant: pair it
            # with the channel-wise dequantize op (the reference does the
            # same via a separate dequant node)
            qraw = name + ".quant"
            self._make_var(block, qraw, var.shape)
            q = Operator(block, op_type, {"X": [name]},
                         {"Out": [qraw], "OutScale": [scale]},
                         {"bit_length": self._wbits})
            dq = Operator(block, "fake_channel_wise_dequantize_max_abs",
                          {"X": [qraw], "Scales": [scale]},
                          {"Out": [qname]},
                          {"quant_bits": [self._wbits]})
            return [q, dq], qname
        q = Operator(block, op_type, {"X": [name]},
                     {"Out": [qname], "OutScale": [scale]},
                     {"bit_length": self._wbits})
        return [q], qname

    def _quant_act(self, block, name, var, for_test):
        qname = name + ".quant.dequant"
        scale = _scale_name(name)
        self._make_var(block, scale, [1], persistable=True)
        self._make_var(block, qname, var.shape)
        if self._act_type == "abs_max":
            op = Operator(block, "fake_quantize_dequantize_abs_max",
                          {"X": [name]},
                          {"Out": [qname], "OutScale": [scale]},
                          {"bit_length": self._abits})
            return [op], qname
        if self._act_type == "range_abs_max":
            it = name + ".quant_iter"
            scales = name + ".quant_scales"
            self._make_var(block, it, [1], persistable=True)
            self._make_var(block, scales, [self._window],
                           persistable=True)
            self._scope_init(scale, [0.001])
            self._scope_init(it, np.zeros((1,), np.int64))
            self._scope_init(scales, np.zeros((self._window,),
                                              np.float32))
            op = Operator(
                block, "fake_quantize_range_abs_max",
                {"X": [name], "InScale": [scale], "Iter": [it],
                 "OutScales": [scales]},
                {"Out": [qname], "OutScale": [scale],
                 "OutScales": [scales], "IterOut": [it]},
                {"bit_length": self._abits, "window_size": self._window,
                 "is_test": for_test})
            return [op], qname
        # moving_average_abs_max (reference default for QAT)
        state = name + ".quant_state"
        accum = name + ".quant_accum"
        self._make_var(block, state, [1], persistable=True)
        self._make_var(block, accum, [1], persistable=True)
        self._scope_init(scale, [0.001])
        self._scope_init(state, [1.0])
        self._scope_init(accum, [0.001])
        op = Operator(
            block, "fake_quantize_dequantize_moving_average_abs_max",
            {"X": [name], "InScale": [scale], "InAccum": [accum],
             "InState": [state]},
            {"Out": [qname], "OutScale": [scale], "OutAccum": [accum],
             "OutState": [state]},
            {"bit_length": self._abits, "moving_rate": self._rho,
             "is_test": for_test})
        return [op], qname

    # -- the pass -------------------------------------------------------------
    def apply(self, program: Program, for_test: bool = False):
        """Rewrite `program` in place; returns it for chaining."""
        from ....executor import global_scope
        self._device = _state.device_of(self._scope or global_scope(),
                                        program)
        block = program.global_block()
        quantized: Dict[str, str] = {}
        new_ops: List[Operator] = []
        param_names = {p.name for p in program.all_parameters()}
        for op in block.ops:
            if op.type in self._targets and \
                    not op.attr(self._skip, False):
                for slot, is_weight in _OP_SLOTS[op.type]:
                    names = op.input(slot)
                    if not names:
                        continue
                    name = names[0]
                    if name.endswith(".quant.dequant"):
                        continue  # already rewired (shared input)
                    if name in quantized:
                        op._inputs[slot] = [quantized[name]]
                        continue
                    var = block._find_var_recursive(name)
                    if var is None:
                        continue
                    is_w = is_weight and name in param_names
                    if is_weight and not is_w:
                        # weight slot fed by an activation (rare) —
                        # quantize as activation
                        ops, qname = self._quant_act(
                            block, name, var, for_test)
                    elif is_w:
                        ops, qname = self._quant_weight(
                            block, name, var, for_test)
                    else:
                        ops, qname = self._quant_act(
                            block, name, var, for_test)
                    new_ops.extend(ops)
                    quantized[name] = qname
                    op._inputs[slot] = [qname]
            new_ops.append(op)
        block.ops[:] = new_ops
        program._bump_version()
        return program


class QuantizationFreezePass:
    """Post-training freeze: snap weights to the int grid, strip the
    weights' quant ops, pin the activation quant ops to is_test."""

    def __init__(self, scope=None, weight_bits: int = 8,
                 weight_quantize_type: str = "abs_max"):
        self._scope = scope
        self._wbits = weight_bits
        self._w_type = weight_quantize_type

    def apply(self, program: Program):
        from ....executor import global_scope
        scope = self._scope or global_scope()
        block = program.global_block()
        bin_cnt = float((1 << (self._wbits - 1)) - 1)
        param_names = {p.name for p in program.all_parameters()}
        weight_q_types = {"fake_quantize_dequantize_abs_max",
                          "fake_channel_wise_quantize_abs_max",
                          "fake_channel_wise_dequantize_max_abs"}
        kept: List[Operator] = []
        rewire: Dict[str, str] = {}
        for op in block.ops:
            if op.type in weight_q_types:
                src = op.input("X")[0] if op.input("X") else ""
                root = src.split(".quant")[0]
                if root in param_names:
                    # snap the trained weight in scope; drop the op
                    if op.type != "fake_channel_wise_dequantize_max_abs":
                        w = np.asarray(_state.read(scope, root),
                                       np.float32)
                        if self._w_type == "channel_wise_abs_max":
                            red = tuple(range(1, w.ndim))
                            s = np.abs(w).max(axis=red, keepdims=True)
                        else:
                            s = np.abs(w).max()
                        s = np.maximum(s, 1e-8)
                        wq = np.round(np.clip(w, -s, s) / s * bin_cnt) \
                            * s / bin_cnt
                        _state.write(scope, root, wq.astype(np.float32))
                        _state.write(scope, _scale_name(root),
                                     np.asarray(s, np.float32).reshape(-1),
                                     _state.device_of(scope, program))
                    rewire[op.output("Out")[0]] = root
                    continue
            # activation quant ops: freeze their running scales
            if op.type.startswith("fake_quantize") or \
                    op.type == "moving_average_abs_max_scale":
                op.set_attr("is_test", True)
            for slot in op.input_slots():
                op._inputs[slot] = [rewire.get(n, n)
                                    for n in op.input(slot)]
            kept.append(op)
        block.ops[:] = kept
        program._bump_version()
        return program


class ConvertToInt8Pass:
    """Store int8 weights for export: ``<w>@int8`` beside the
    ``<w>.quant_scale`` the freeze pass recorded."""

    def __init__(self, scope=None, weight_bits: int = 8):
        self._scope = scope
        self._wbits = weight_bits

    def apply(self, program: Program):
        from ....executor import global_scope
        scope = self._scope or global_scope()
        bin_cnt = float((1 << (self._wbits - 1)) - 1)
        for p in program.all_parameters():
            sv = scope.find_var(_scale_name(p.name))
            if sv is None or not sv.is_initialized():
                continue
            w = np.asarray(_state.read(scope, p.name), np.float32)
            s = np.asarray(_state.read(scope, _scale_name(p.name)),
                           np.float32)
            if s.size > 1:
                s = s.reshape((-1,) + (1,) * (w.ndim - 1))
            q = np.clip(np.round(w / np.maximum(s, 1e-8) * bin_cnt),
                        -bin_cnt - 1, bin_cnt).astype(np.int8)
            _state.write(scope, p.name + "@int8", q,
                         _state.device_of(scope, program))
        return program
