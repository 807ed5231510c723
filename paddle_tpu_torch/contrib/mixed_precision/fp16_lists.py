"""Op lists controlling which ops compute in reduced precision
(counterpart of paddle_tpu/contrib/mixed_precision/fp16_lists.py). The
default policy lives in core/amp.py; custom white/black entries are
merged into the policy the decorator hands to the Program."""
from __future__ import annotations

from ...core import amp as _amp

white_list = set(_amp.WHITE_OPS)
black_list = set(_amp.BLACK_OPS)
gray_list = set(_amp.GRAY_OPS)


class AutoMixedPrecisionLists:
    """Custom white/black list container."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
