"""Contributed modules (counterpart of paddle_tpu/contrib/): the
mixed-precision decorator and the seq2seq decoder API."""
from . import mixed_precision  # noqa: F401
from .decoder import (BeamSearchDecoder, InitState,  # noqa: F401
                      StateCell, TrainingDecoder)
