"""Dygraph Layer (counterpart of paddle_tpu/dygraph/layers.py): parameter
and sublayer registration by attribute, the parameter walks, train/eval,
and a state dict keyed by structure."""
from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch

from .. import framework
from ..framework import unique_name
from .tracer import VarBase

__all__ = ["Layer"]


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower())
        self._dtype = dtype
        self._parameters: "OrderedDict[str, VarBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self.training = True

    def full_name(self):
        return self._full_name

    # -- parameter / sublayer registration ----------------------------------
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        if isinstance(value, VarBase) and value.persistable and \
                params is not None:
            params[name] = value
        elif isinstance(value, Layer) and layers is not None:
            layers[name] = value
        object.__setattr__(self, name, value)

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        object.__setattr__(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        object.__setattr__(self, name, sublayer)
        return sublayer

    def parameters(self, include_sublayers=True) -> List[VarBase]:
        out = list(self._parameters.values())
        if include_sublayers:
            for layer in self._sub_layers.values():
                out.extend(layer.parameters())
        return out

    def named_parameters(self, prefix=""):
        for name, p in self._parameters.items():
            yield (f"{prefix}.{name}" if prefix else name), p
        for lname, layer in self._sub_layers.items():
            yield from layer.named_parameters(
                f"{prefix}.{lname}" if prefix else lname)

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for layer in self._sub_layers.values():
                out.extend(layer.sublayers())
        return out

    # -- modes --------------------------------------------------------------
    def train(self):
        self.training = True
        for layer in self.sublayers():
            layer.training = True

    def eval(self):
        self.training = False
        for layer in self.sublayers():
            layer.training = False

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- state dict ---------------------------------------------------------
    def _stable_named_parameters(self, prefix=""):
        """Structural keys, attribute path and creation ordinal: stable
        across instances, where the unique parameter names are not."""
        for i, p in enumerate(self._parameters.values()):
            yield f"{prefix}p{i}", p
        for lname, layer in self._sub_layers.items():
            yield from layer._stable_named_parameters(f"{prefix}{lname}.")

    def state_dict(self, destination=None, include_sublayers=True,
                   prefix=""):
        """Keyed by structural path, so that a fresh instance (whose
        unique parameter names differ) can load it; each parameter's
        name is a key too."""
        dest = destination if destination is not None else OrderedDict()
        for key, p in self._stable_named_parameters():
            dest[key] = p
            dest.setdefault(p.name, p)
        return dest

    def set_dict(self, state_dict, include_sublayers=True):
        for key, p in self._stable_named_parameters():
            v = state_dict.get(key, state_dict.get(p.name))
            if v is not None:
                p.set_value(v)

    load_dict = set_dict

    # -- call ---------------------------------------------------------------
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        tracer = framework._dygraph_tracer()
        if tracer is not None:
            tracer._layer_stack.append(self)
            self._param_create_idx = 0   # restart the lazy ordinals
        try:
            return self.forward(*inputs, **kwargs)
        finally:
            if tracer is not None:
                tracer._layer_stack.pop()

    def create_parameter(self, attr, shape, dtype=None, is_bias=False,
                         default_initializer=None):
        from ..layer_helper import LayerHelper
        from ..param_attr import ParamAttr
        helper = LayerHelper(self._full_name, bias_attr=attr)
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        return helper.create_parameter(attr, shape, dtype or self._dtype,
                                       is_bias, default_initializer)

    def create_variable(self, name=None, persistable=None, dtype=None):
        """A state variable of this layer that is not a parameter: one
        zero on the tracer's device."""
        from ..core.types import dtype_to_torch
        tracer = framework._dygraph_tracer()
        v = VarBase(torch.zeros((1,), dtype=dtype_to_torch(
            dtype or self._dtype), device=tracer.device if tracer else None),
            stop_gradient=True)
        v.name = name or unique_name.generate(self._full_name + ".var")
        v.persistable = bool(persistable)
        return v

    def backward(self, *inputs):
        raise ValueError(
            "Layer.backward is only meaningful on PyLayer-style "
            "custom-gradient layers; built-in layers differentiate "
            "through the tape automatically")
