"""Op-builder layer API (counterpart of paddle_tpu/layers/)."""
from . import (control_flow, io, learning_rate_scheduler,  # noqa: F401
               loss, math_ops, metric_op, nn, ops, rnn, sequence, tensor)

from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .math_ops import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
