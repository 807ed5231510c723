"""Model builders."""
from . import lenet, resnet, transformer  # noqa: F401
from .lenet import lenet_train  # noqa: F401
from .resnet import resnet_train  # noqa: F401
from .transformer import (TransformerConfig, transformer_base,  # noqa: F401
                          transformer_train)
