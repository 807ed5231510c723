"""Evaluators (counterpart of paddle_tpu/evaluator.py: Evaluator,
EditDistance and DetectionMAP; ChunkEvaluator waits for the chunk_eval
op). An evaluator keeps persistable state vars in the main program,
accumulated by ops it appends there across minibatches; `reset` starts
them again and `eval` reads the epoch's metric. Deprecated in the
reference in favour of fluid.metrics, so each warns, as in the JAX
package."""
from __future__ import annotations

import warnings

import numpy as np

from . import layers
from .core.scope import global_scope
from .framework import Program, program_guard, unique_name
from .layer_helper import LayerHelper
from .ops.detection import DetectionMAPState

__all__ = ["EditDistance", "DetectionMAP"]


def _warn(cls):
    warnings.warn(
        f"fluid.evaluator.{cls} is deprecated in the reference too; "
        f"prefer fluid.metrics / the metric ops", stacklevel=3)


class Evaluator:
    """Base: persistable state vars, zeroed in the startup program,
    accumulated by ops appended to the main program."""

    def __init__(self, name, **kwargs):
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        """Run a program of fill_constant ops that zero the states."""
        if reset_program is None:
            reset_program = Program()
        with program_guard(main_program=reset_program):
            block = reset_program.global_block()
            for var in self.states:
                block.create_var(name=var.name, shape=var.shape,
                                 dtype=var.dtype, persistable=True)
                block.append_op(
                    "fill_constant", outputs={"Out": [var.name]},
                    attrs={"shape": [int(s) for s in var.shape],
                           "dtype": var.dtype, "value": 0.0},
                    infer_shape=False)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def _create_state(self, suffix, dtype, shape):
        name = unique_name.generate(f"{self.helper.name}_{suffix}_state")
        var = self.helper.main_program.global_block().create_var(
            name=name, persistable=True, dtype=dtype, shape=list(shape))
        sblock = self.helper.startup_program.global_block()
        sblock.create_var(name=name, persistable=True, dtype=dtype,
                          shape=list(shape))
        sblock.append_op(
            "fill_constant", outputs={"Out": [name]},
            attrs={"shape": [int(s) for s in shape], "dtype": var.dtype,
                   "value": 0.0}, infer_shape=False)
        self.states.append(var)
        return var

    def _accumulate(self, state, batch_value):
        """state += batch_value, appended to the main program."""
        block = self.helper.main_program.global_block()
        cast = layers.cast(batch_value, state.dtype) \
            if batch_value.dtype != state.dtype else batch_value
        resh = layers.reshape(cast, [int(s) for s in state.shape]) \
            if tuple(cast.shape) != tuple(state.shape) else cast
        block.append_op(
            "elementwise_add",
            inputs={"X": [state.name], "Y": [resh.name]},
            outputs={"Out": [state.name]}, attrs={"axis": -1},
            infer_shape=False)

    @staticmethod
    def _fetch_state(var):
        v = global_scope().find_var(var.name)
        return np.asarray(v.get_tensor())


class EditDistance(Evaluator):
    """The epoch's average edit distance and instance error rate."""

    def __init__(self, input, label, ignored_tokens=None):
        super().__init__("edit_distance")
        _warn("EditDistance")
        distances, seq_num = layers.edit_distance(
            input=input, label=label, ignored_tokens=ignored_tokens)
        self.total_distance = self._create_state(
            "total_distance", "float32", [1])
        self.seq_num = self._create_state("seq_num", "int32", [1])
        self.instance_error = self._create_state(
            "instance_error", "int32", [1])
        batch_sum = layers.reduce_sum(distances)
        wrong = layers.reduce_sum(layers.cast(
            layers.cast(distances, "bool"), "int32"))
        self._accumulate(self.total_distance, batch_sum)
        self._accumulate(self.seq_num, seq_num)
        self._accumulate(self.instance_error, wrong)
        self.metrics.append(layers.mean(distances))

    def eval(self, executor, eval_program=None):
        total = float(self._fetch_state(self.total_distance))
        n = int(self._fetch_state(self.seq_num))
        err = int(self._fetch_state(self.instance_error))
        avg = total / n if n else 0.0
        rate = err / n if n else 0.0
        return np.array(avg, np.float32), np.array(rate, np.float32)


class DetectionMAP(Evaluator):
    """The batch's mAP (cur_map) and the epoch's so far (accum_map): the
    state is a DetectionMAPState in a persistable var, which a second
    detection_map op reads and writes back (the op is eager, so a host
    object is scope content, as a SelectedRows is). The state is seeded
    in the global scope; `reset` seeds it anew."""

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        super().__init__("map_eval")
        _warn("DetectionMAP")
        label = layers.concat([gt_label, gt_difficult, gt_box], axis=1) \
            if gt_difficult is not None else \
            layers.concat([gt_label, gt_box], axis=1)
        cur_map = layers.detection_map(
            input, label, class_num, background_label, overlap_threshold,
            evaluate_difficult, ap_version=ap_version)
        block = self.helper.main_program.global_block()
        state = block.create_var(name=unique_name.generate(
            "map_eval_state"), persistable=True, dtype="float32",
            shape=[1])
        self._state_var = state
        self.states.append(state)
        accum_map = block.create_var(name=unique_name.generate(
            "map_eval_accum"), dtype="float32", shape=[1])
        tp = block.create_var(name=unique_name.generate("map_eval_tp"),
                              dtype="float32", shape=[-1, 2])
        fp = block.create_var(name=unique_name.generate("map_eval_fp"),
                              dtype="float32", shape=[-1, 2])
        block.append_op(
            "detection_map",
            inputs={"DetectRes": [input.name], "Label": [label.name],
                    "PosCount": [state.name]},
            outputs={"MAP": [accum_map.name],
                     "AccumPosCount": [state.name],
                     "AccumTruePos": [tp.name],
                     "AccumFalsePos": [fp.name]},
            attrs={"overlap_threshold": overlap_threshold,
                   "evaluate_difficult": evaluate_difficult,
                   "ap_type": ap_version, "class_num": class_num},
            infer_shape=False)
        self.cur_map = cur_map
        self.accum_map = accum_map
        self.metrics.extend([cur_map, accum_map])
        self.reset(None)

    def reset(self, executor, reset_program=None):
        """The state is a host object: seeded anew in the global
        scope."""
        global_scope().var(self._state_var.name).get_tensor().set_tensor(
            DetectionMAPState())

    def get_map_var(self):
        return self.cur_map, self.accum_map

    def eval(self, executor, eval_program=None):
        return self.accum_map
