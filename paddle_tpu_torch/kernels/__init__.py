"""Hand-written Hopper kernels and their plain PyTorch versions.
Importing this package registers the kernels that ops reach through the
registry (kernels/registry.py)."""
from . import fused_optimizer  # noqa: F401  (registers for adam/sgd)
from . import quantized_matmul  # noqa: F401  (registers for mul/matmul)
