"""bf16 mixed-precision training (counterpart of
paddle_tpu/contrib/mixed_precision/)."""
from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
