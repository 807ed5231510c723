"""contrib.slim: model compression (counterpart of
paddle_tpu/contrib/slim/): quantization-aware training, pruning,
distillation and the light NAS search, composed by the Compressor's
epoch loop."""
from . import quantization  # noqa: F401
from . import core  # noqa: F401
from . import prune  # noqa: F401
from . import distillation  # noqa: F401
from . import nas  # noqa: F401
