"""Op lowerings. Importing this package registers every op."""
from . import (activations, basic, elementwise, fused, matmul,  # noqa: F401
               nn, random_ops, reduce)
