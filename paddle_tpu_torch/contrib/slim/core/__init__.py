"""slim.core: the compression pipeline (Compressor, Strategy, Context,
ConfigFactory; counterpart of paddle_tpu/contrib/slim/core/): an epoch
loop that composes quantization, pruning, distillation and NAS
strategies over one training run, with a checkpoint of the compression
state. The "graph" a strategy rewrites is a Program, and training and
evaluation run through Executor.run (a plan, then one CUDA graph a
block)."""
from .strategy import Strategy
from .compressor import Compressor, Context
from .config import ConfigFactory, load_config

__all__ = ["Strategy", "Compressor", "Context", "ConfigFactory",
           "load_config"]
