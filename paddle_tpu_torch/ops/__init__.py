"""Op lowerings. Importing this package registers every op."""
from . import (activations, basic, beam_search,  # noqa: F401
               control_flow, conv, detection, elementwise, fused, matmul,
               metrics, misc, nlp, nn, optimizer_ops, quantize, random_ops,
               reduce, rnn, sequence)
