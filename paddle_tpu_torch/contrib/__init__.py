"""Contributed modules (counterpart of paddle_tpu/contrib/): the
mixed-precision decorator."""
from . import mixed_precision  # noqa: F401
