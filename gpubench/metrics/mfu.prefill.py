"""The prefill's model FLOPs (``counts.prefill_flops``) as % of the card's
bf16 peak, over the window's untraced batches by the host clock."""

from gpubench import readers


def read(view):
    return readers.mfu(view)
