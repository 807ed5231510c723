"""Model builders."""
from . import transformer  # noqa: F401
from .transformer import (TransformerConfig, transformer_base,  # noqa: F401
                          transformer_train)
