"""Op-builder layer API (counterpart of paddle_tpu/layers/)."""
from . import io, loss, metric_op, nn, sequence, tensor  # noqa: F401

from .io import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
