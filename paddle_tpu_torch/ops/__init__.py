"""Op lowerings. Importing this package registers every op."""
from . import (activations, basic, control_flow, conv,  # noqa: F401
               elementwise, fused, matmul, metrics, nn, optimizer_ops,
               random_ops, reduce, rnn, sequence)
