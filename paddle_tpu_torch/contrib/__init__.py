"""Contributed modules (counterpart of paddle_tpu/contrib/): the
mixed-precision decorator, the seq2seq decoder API and slim (model
compression: QAT, pruning, distillation, NAS)."""
from . import mixed_precision  # noqa: F401
from . import slim  # noqa: F401
from .slim.core.compressor import Compressor  # noqa: F401
from .slim.quantization import QuantizeTranspiler  # noqa: F401
from .decoder import (BeamSearchDecoder, InitState,  # noqa: F401
                      StateCell, TrainingDecoder)
