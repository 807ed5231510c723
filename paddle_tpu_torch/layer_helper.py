"""LayerHelper: parameter creation and op appending shared by the layers
(counterpart of paddle_tpu/layer_helper.py, graph mode only)."""
from __future__ import annotations

from .framework import (Parameter, default_main_program,
                        default_startup_program, unique_name)
from . import initializer as init_mod
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    # ---- variables --------------------------------------------------------
    def create_variable_for_type_inference(self, dtype,
                                           stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_global_variable(self, persistable=False, **kwargs):
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs)

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        if not attr.name:
            attr.name = unique_name.generate(
                f"{self.name}.b" if is_bias else f"{self.name}.w")
        initializer = attr.initializer or default_initializer
        if initializer is None:
            if not is_bias:
                raise ValueError(
                    f"parameter {attr.name!r} has no initializer; the "
                    "port has no default weight initializer yet, so give "
                    "ParamAttr(initializer=...)")
            initializer = init_mod.Constant(0.0)

        shape = [int(d) for d in shape]
        gb = self.main_program.global_block()
        if attr.name in gb.vars:
            # an explicit name shared by two call sites is the
            # weight-sharing contract: reuse the existing parameter
            existing = gb.vars[attr.name]
            if not isinstance(existing, Parameter):
                raise ValueError(
                    f"ParamAttr name {attr.name!r} collides with a "
                    f"non-parameter variable of the same name")
            return existing
        param = gb.create_parameter(name=attr.name, shape=shape,
                                    dtype=dtype, trainable=attr.trainable)
        # mirror into the startup program with its init op
        sb = self.startup_program.global_block()
        sv = sb.create_parameter(name=attr.name, shape=shape, dtype=dtype,
                                 trainable=attr.trainable)
        initializer(sv, sb)
        return param

    # ---- ops --------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.main_program.current_block().append_op(
            type, inputs=inputs, outputs=outputs, attrs=attrs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr or ParamAttr(), size,
                                  input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op("elementwise_add",
                       inputs={"X": input_var, "Y": b},
                       outputs={"Out": out}, attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(act, inputs={"X": input_var}, outputs={"Out": out})
        return out
