"""ParamAttr (counterpart of paddle_tpu/param_attr.py)."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, trainable=True):
        self.name = name
        self.initializer = initializer
        self.trainable = trainable

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if arg is False:
            return False
        from .initializer import Initializer
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"invalid param_attr: {arg!r}")
