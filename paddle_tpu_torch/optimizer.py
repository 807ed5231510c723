"""Optimizers: minimize() = append_backward + one update op per parameter.

Counterpart of paddle_tpu/optimizer.py (Optimizer and AdamOptimizer; the
other rules are not ported yet). The learning rate is a persistable
global var; accumulators are persistable vars initialized by fill ops in
the startup program; every op of the optimize phase (clip,
regularization, update) carries op_role "optimize". Update ops bind
ParamOut to Param, so the engine writes the new values back in place.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

from .backward import OP_ROLE_ATTR, append_backward
from .clip import append_gradient_clip_ops
from .framework import (Variable, default_main_program,
                        default_startup_program, program_guard, unique_name)
from .initializer import Constant
from .layer_helper import LayerHelper
from .layers import tensor as _tensor
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "Adam", "AdamOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map: Dict[int, Variable] = {}
        self._accumulators: Dict[str, Dict[str, Variable]] = \
            defaultdict(dict)
        self.helper = None

    # ---- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        prog = default_main_program()
        if id(prog) in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[id(prog)] = self._learning_rate
            return
        self._learning_rate_map[id(prog)] = _tensor.create_global_var(
            name=unique_name.generate("learning_rate"), shape=[1],
            value=float(self._learning_rate), dtype="float32",
            persistable=True)

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(id(program))

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = (getattr(param, "optimize_attr", None)
                    or {}).get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        return _tensor.scale(base, scale=float(param_lr))

    # ---- accumulators -----------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        cached = self._accumulators[name].get(param.name)
        if cached is not None:
            return cached
        shape = shape if shape is not None else list(param.shape)
        var_name = unique_name.generate(f"{param.name}_{name}")
        var = self.helper.create_global_variable(
            name=var_name, persistable=True, dtype=dtype or param.dtype,
            shape=shape)
        sb = default_startup_program().global_block()
        sv = sb.create_var(name=var_name, shape=shape,
                           dtype=dtype or param.dtype, persistable=True)
        Constant(float(fill_value))(sv, sb)
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # ---- to be implemented by subclasses ----------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # ---- the pass ---------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads):
        block = default_main_program().global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        return [self._append_optimize_op(block, pg)
                for pg in parameters_and_grads
                if pg[1] is not None and pg[0].trainable]

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return append_backward(loss, parameter_list, no_grad_set)

    def apply_gradients(self, params_grads):
        block = default_main_program().global_block()
        start = len(block.ops)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        ops = self._create_optimization_pass(params_grads)
        for op in block.ops[start:]:
            op._attrs[OP_ROLE_ATTR] = "optimize"
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program,
                                           params_grads)
        return optimize_ops, params_grads


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator("beta2_pow_acc", p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "adam",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)


Adam = AdamOptimizer
