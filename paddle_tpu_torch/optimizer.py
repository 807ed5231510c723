"""Optimizers: minimize() = append_backward + one update op per parameter.

Counterpart of paddle_tpu/optimizer.py (Optimizer, SGD, Momentum,
LarsMomentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp,
Ftrl and Lamb; ModelAverage, ExponentialMovingAverage, the pipeline and
DGC optimizers are not ported yet). The learning rate is
a persistable global var; accumulators are persistable vars initialized
by fill ops in the startup program; every op of the optimize phase (clip,
regularization, update) carries op_role "optimize". Update ops bind
ParamOut to Param, so the engine writes the new values back in place.

In dygraph mode minimize() takes the gradients loss.backward() left on
the tracer's parameters; the learning rate and the accumulators are
VarBases on the tracer's device, and the update ops run through the
tracer (the same lowerings as graph mode), all of one minimize at once
(Tracer.trace_ops): a run of sgd or adam ops sharing their
hyper-parameters goes to the group lowering the engine uses, so an eager
Adam step is one list launch, as a graph step is. A LearningRateDecay
rate is stepped by every minimize and written into the rate's tensor.
Clipping and regularization are not applied in dygraph mode, as in the
JAX package.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

from .backward import OP_ROLE_ATTR, append_backward
from .clip import append_gradient_clip_ops
from .core.types import dtype_to_torch
from .framework import (Variable, _dygraph_tracer, default_main_program,
                        default_startup_program, in_dygraph_mode,
                        program_guard, unique_name)
from .initializer import Constant
from .layer_helper import LayerHelper
from .layers import tensor as _tensor
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adagrad", "AdagradOptimizer", "Adam",
           "AdamOptimizer", "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
           "DecayedAdagradOptimizer", "Adadelta", "AdadeltaOptimizer",
           "RMSProp", "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb",
           "LambOptimizer", "LarsMomentum", "LarsMomentumOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self.regularization = regularization
        self._name = name
        self._learning_rate = learning_rate
        self._learning_rate_map: Dict[int, Variable] = {}
        self._accumulators: Dict[str, Dict[str, Variable]] = \
            defaultdict(dict)
        self.helper = None

    # ---- dygraph ----------------------------------------------------------
    class _EagerBlock:
        """The block the update ops go to in dygraph mode: it keeps them,
        and run() traces them all at once (Tracer.trace_ops)."""

        def __init__(self):
            self.ops = []

        def append_op(self, type=None, inputs=None, outputs=None,
                      attrs=None, infer_shape=True):
            self.ops.append((type, inputs or {}, outputs or {},
                             attrs or {}))
            return outputs

        def run(self):
            return _dygraph_tracer().trace_ops(self.ops)

    def _dygraph_params_grads(self, parameter_list=None):
        """(parameter, gradient) of every trainable parameter of the
        tracer (of `parameter_list`, by VarBase or name, when given) that
        holds a gradient, in creation order."""
        from .dygraph.tracer import VarBase
        wanted = None if parameter_list is None else {
            v if isinstance(v, str) else v.name for v in parameter_list}
        pgs = []
        for p in _dygraph_tracer()._params.values():
            if wanted is not None and p.name not in wanted:
                continue
            if not p.trainable or p.grad is None:
                continue
            pgs.append((p, VarBase(p.grad, stop_gradient=True)))
        return pgs

    # ---- learning rate ----------------------------------------------------
    def _create_global_learning_rate(self):
        if in_dygraph_mode():
            from .dygraph.learning_rate_scheduler import LearningRateDecay
            from .dygraph.tracer import VarBase
            holder = self._learning_rate_map.get("dygraph")
            decay = isinstance(self._learning_rate, LearningRateDecay)
            if holder is None:
                if isinstance(self._learning_rate, VarBase):
                    self._learning_rate_map["dygraph"] = self._learning_rate
                    return
                holder = VarBase(torch.full(
                    (1,), 0.0 if decay else float(self._learning_rate),
                    dtype=torch.float32, device=_dygraph_tracer().device),
                    stop_gradient=True)
                self._learning_rate_map["dygraph"] = holder
            if decay:
                # in place: a captured step bakes this write into its
                # graph, and the graph reads this tensor
                holder.value.fill_(float(self._learning_rate()))
            return
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
        if in_dygraph_mode():
            return self._learning_rate_map.get("dygraph")
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
            if in_dygraph_mode() or default_main_program().global_block() \
                    ._find_var_recursive(cached.name) is not None:
                return cached
            # one optimizer minimizing a second program (contrib.slim's
            # Compressor minimizes each rewritten graph): declare the
            # accumulator there too, with its fill in the new startup
            # program, as the JAX package does (running that startup
            # resets it)
            var = self.helper.create_global_variable(
                name=cached.name, persistable=True, dtype=cached.dtype,
                shape=list(cached.shape))
            sb = default_startup_program().global_block()
            sv = sb.create_var(name=cached.name, shape=list(cached.shape),
                               dtype=cached.dtype, persistable=True)
            Constant(float(fill_value))(sv, sb)
            self._accumulators[name][param.name] = var
            return var
        shape = shape if shape is not None else list(param.shape)
        if in_dygraph_mode():
            from .dygraph.tracer import VarBase
            acc = VarBase(torch.full(
                shape, float(fill_value),
                dtype=dtype_to_torch(dtype or param.dtype),
                device=_dygraph_tracer().device), stop_gradient=True)
            self._accumulators[name][param.name] = acc
            return acc
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

    def _finish_update(self, block, parameters_and_grads):
        """Ops after every update (Adamax's beta-power scale ops)."""

    # ---- the pass ---------------------------------------------------------
    def _create_optimization_pass(self, parameters_and_grads):
        block = Optimizer._EagerBlock() if in_dygraph_mode() else \
            default_main_program().global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        ops = [self._append_optimize_op(block, pg)
               for pg in parameters_and_grads
               if pg[1] is not None and pg[0].trainable]
        self._finish_update(block, parameters_and_grads)
        return block.run() if in_dygraph_mode() else ops

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        if in_dygraph_mode():
            # loss.backward() left the gradients on the parameters
            return self._dygraph_params_grads(parameter_list)
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return append_backward(loss, parameter_list, no_grad_set,
                                   callbacks)

    def apply_gradients(self, params_grads):
        if in_dygraph_mode():
            return self._create_optimization_pass(params_grads)
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
        if in_dygraph_mode():
            return self.apply_gradients(params_grads)
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        """append_backward, then the update ops. `grad_clip` (the
        reference's dygraph clip) raises NotImplementedError until the
        clip ops are ported (clip.py): a clip is never dropped."""
        if grad_clip is not None:
            raise NotImplementedError(
                "minimize(grad_clip=...): gradient clipping is not ported "
                "to paddle_tpu_torch yet")
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        optimize_ops = self.apply_optimize(loss, startup_program,
                                           params_grads)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "sgd",
            inputs={"Param": p, "Grad": g,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p}, infer_shape=False)


class MomentumOptimizer(Optimizer):
    """One velocity accumulator a parameter; the momentum op's attrs mu
    and use_nesterov."""

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self._momentum,
                   "use_nesterov": self._use_nesterov},
            infer_shape=False)


class AdagradOptimizer(Optimizer):
    """One moment accumulator a parameter, filled with
    initial_accumulator_value; the adagrad op's attr epsilon."""

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adagrad"
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"epsilon": self._epsilon}, infer_shape=False)


class AdamOptimizer(Optimizer):
    """`lazy_mode` is taken as the JAX package takes it: the adam op's
    update is the same either way (a SelectedRows gradient updates the
    touched rows only, as ops/optimizer_ops.py sets out)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kw):
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


class LarsMomentumOptimizer(Optimizer):
    """One velocity accumulator a parameter; the lars_momentum op's attrs
    mu, lars_coeff and lars_weight_decay."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": p, "Grad": g, "Velocity": v,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "VelocityOut": v},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay},
            infer_shape=False)


class AdamaxOptimizer(Optimizer):
    """Moment, infinity-norm and beta1-power accumulators; the beta1
    powers move in one `scale` op a parameter after all the updates."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            "adamax",
            inputs={"Param": p, "Grad": g,
                    "Moment": self._get_accumulator("moment", p),
                    "InfNorm": self._get_accumulator("inf_norm", p),
                    "Beta1Pow": self._get_accumulator("beta1_pow_acc", p),
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p,
                     "MomentOut": self._get_accumulator("moment", p),
                     "InfNormOut": self._get_accumulator("inf_norm", p)},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)

    def _finish_update(self, block, parameters_and_grads):
        for p, g in parameters_and_grads:
            if g is None:
                continue
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op("scale", inputs={"X": b1p},
                            outputs={"Out": b1p},
                            attrs={"scale": self._beta1},
                            infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": p, "Grad": g, "Moment": m,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": m},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    """The adadelta op reads no learning rate (as in the JAX package):
    `learning_rate` is kept, and its var made, all the same."""

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("_avg_squared_grad", p)
            self._add_accumulator("_avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("_avg_squared_grad", p)
        asu = self._get_accumulator("_avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": p, "Grad": g, "AvgSquaredGrad": asg,
                    "AvgSquaredUpdate": asu},
            outputs={"ParamOut": p, "AvgSquaredGradOut": asg,
                     "AvgSquaredUpdateOut": asu},
            attrs={"epsilon": self._epsilon, "rho": self._rho},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    """Momentum, mean-square and mean-gradient accumulators a parameter
    (the last read only when centered); rho is the op's decay."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "rmsprop"
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        mom = self._get_accumulator("momentum", p)
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        return block.append_op(
            "rmsprop",
            inputs={"Param": p, "Grad": g, "Moment": mom,
                    "MeanSquare": ms, "MeanGrad": mg,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "MomentOut": mom,
                     "MeanSquareOut": ms, "MeanGradOut": mg},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum,
                   "centered": self._centered}, infer_shape=False)


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": p, "Grad": g, "SquaredAccumulator": sq,
                    "LinearAccumulator": lin,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "SquaredAccumOut": sq,
                     "LinearAccumOut": lin},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power}, infer_shape=False)


class LambOptimizer(AdamOptimizer):
    """Adam's accumulators; the lamb op's trust ratio and weight decay."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            "lamb",
            inputs={"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2,
                    "Beta1Pow": b1p, "Beta2Pow": b2p,
                    "LearningRate": self._create_param_lr(param_and_grad)},
            outputs={"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon,
                   "weight_decay": self._weight_decay},
            infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
