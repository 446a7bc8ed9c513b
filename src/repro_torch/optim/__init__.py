"""AdamW (optionally with int8 block-quantized moments) and learning-rate
schedules."""

from .adamw import (BLOCK, AdamWConfig, apply_updates, dequantize_moment,
                    global_norm, init_opt_state, quantize_moment)
from .schedule import constant, warmup_cosine

__all__ = ["AdamWConfig", "BLOCK", "apply_updates", "constant",
           "dequantize_moment", "global_norm", "init_opt_state",
           "quantize_moment", "warmup_cosine"]
