"""Imperative (dygraph) mode (counterpart of paddle_tpu/dygraph): the
eager tracer and its tape, Layers, the dygraph layers, checkpoints,
learning-rate schedules and jit.capture. DataParallel, prepare_context
and Env (multi-device) are not ported yet."""
from .base import guard, enabled, to_variable, no_grad  # noqa: F401
from .tracer import Tracer, VarBase  # noqa: F401
from .layers import Layer  # noqa: F401
from . import nn  # noqa: F401
from .nn import *  # noqa: F401,F403
from .checkpoint import save_persistables, load_persistables  # noqa: F401

from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    NoamDecay, PiecewiseDecay, NaturalExpDecay,
    ExponentialDecay, InverseTimeDecay, PolynomialDecay,
    CosineDecay)
from . import jit  # noqa: F401


class BackwardStrategy:
    """The reference's dygraph.BackwardStrategy: sort_sum_gradient asks
    for a fixed order of gradient sums. The tape always sums in one order
    (the tape's), so the flag is kept and has no effect."""

    def __init__(self):
        self.sort_sum_gradient = False
