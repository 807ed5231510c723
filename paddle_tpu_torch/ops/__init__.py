"""Op lowerings. Importing this package registers every op."""
from . import (activations, basic, conv, elementwise, fused,  # noqa: F401
               matmul, metrics, nn, optimizer_ops, random_ops, reduce,
               rnn, sequence)
