"""Model builders."""
from . import (label_semantic_roles, lenet,  # noqa: F401
               machine_translation, resnet, sentiment, seq2seq,
               transformer, wide_deep)
from .lenet import lenet_train  # noqa: F401
from .resnet import resnet_train  # noqa: F401
from .sentiment import sentiment_train  # noqa: F401
from .seq2seq import seq2seq_train  # noqa: F401
from .transformer import (TransformerConfig, transformer_base,  # noqa: F401
                          transformer_train)
from .wide_deep import ctr_train  # noqa: F401
