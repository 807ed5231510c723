"""Op lowerings. Importing this package registers every op."""
from . import (activations, basic, elementwise, fused, matmul,  # noqa: F401
               nn, optimizer_ops, random_ops, reduce)
