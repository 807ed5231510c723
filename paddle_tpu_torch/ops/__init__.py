"""Op lowerings. Importing this package registers every op."""
from . import (activations, basic, beam_search,  # noqa: F401
               control_flow, conv, elementwise, fused, matmul, metrics,
               misc, nlp, nn, optimizer_ops, random_ops, reduce, rnn,
               sequence)
