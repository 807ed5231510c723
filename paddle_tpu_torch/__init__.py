"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one, with the same module names and the
same fluid-style surface: build a Program with `layers`, minimize its
cost with an `optimizer` (optionally under
`contrib.mixed_precision.decorate`), run it with
`Executor(CUDAPlace(0))`. Its hand-written kernels are CUDA C++ for
Hopper (sm_90a) under `csrc/`, built at first use. It imports torch and
numpy, and nothing of JAX or of paddle_tpu.
"""
from . import ops  # noqa: F401  (registers the op lowerings)
from . import framework, initializer, io, layers, models  # noqa: F401
from . import backward, contrib, dygraph, inference, optimizer  # noqa: F401
from . import evaluator, parallel, regularizer, unique_name  # noqa: F401
from .backward import gradients  # noqa: F401
from .core.place import CPUPlace, CUDAPlace, default_place  # noqa: F401
from .core.scope import (LoDTensor, Scope, create_lod_tensor,  # noqa: F401
                         global_scope, scope_guard)
from .executor import Executor  # noqa: F401
from . import lod_tensor, nets  # noqa: F401
from .lod_tensor import create_random_int_lodtensor  # noqa: F401
from .framework import (Program, default_main_program,  # noqa: F401
                        default_startup_program, in_dygraph_mode,
                        program_guard)
from .param_attr import ParamAttr  # noqa: F401
