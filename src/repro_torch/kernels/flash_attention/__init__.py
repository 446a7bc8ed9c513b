"""FlashAttention-2 forward (prefill attention)."""

from .kernel import flash_attention_fwd, flash_attention_fwd_plain
from .ops import DEFAULTS, flash_attention

__all__ = ["DEFAULTS", "flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain"]
