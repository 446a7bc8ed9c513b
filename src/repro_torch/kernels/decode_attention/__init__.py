"""Split-KV grouped-query decode attention (one token against a cache)."""

from .kernel import (combine_splits, decode_attention_plain,
                     decode_partials_plain)
from .ops import DEFAULTS, decode_attention

__all__ = ["DEFAULTS", "combine_splits", "decode_attention",
           "decode_attention_plain", "decode_partials_plain"]
