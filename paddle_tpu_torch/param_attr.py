"""ParamAttr (counterpart of paddle_tpu/param_attr.py). The learning
rate multiplier reaches the optimizer through the Parameter's
optimize_attr; the regularizer and the clip reach the optimizer's
regularization and clip passes (regularizer.py, clip.py): the
regularizer's decay term is added to the gradient, a clip raises until
the clip ops are ported."""
from __future__ import annotations

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=False):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
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
