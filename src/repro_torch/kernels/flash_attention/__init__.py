"""FlashAttention-2 forward (prefill) and backward (training) attention."""

from .kernel import (flash_attention_bwd, flash_attention_bwd_plain,
                     flash_attention_fwd, flash_attention_fwd_plain)
from .ops import (BWD_DEFAULTS, BWD_F32_DEFAULTS, DEFAULTS, F32_DEFAULTS,
                  FlashAttention, flash_attention)

__all__ = ["BWD_DEFAULTS", "BWD_F32_DEFAULTS", "DEFAULTS", "F32_DEFAULTS",
           "FlashAttention", "flash_attention", "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_fwd_plain"]
