"""Strategy base class (counterpart of
paddle_tpu/contrib/slim/core/strategy.py): callbacks the Compressor
calls at the compression's, the epochs' and the batches' boundaries."""
from __future__ import annotations

__all__ = ["Strategy"]


class Strategy:
    def __init__(self, start_epoch=0, end_epoch=0):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def on_compression_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        pass

    def on_epoch_end(self, context):
        pass

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_compression_end(self, context):
        pass

    def restore_from_checkpoint(self, context):
        pass
