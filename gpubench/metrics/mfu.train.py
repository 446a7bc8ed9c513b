"""The training step's model FLOPs (``counts.train_step_flops``) as % of
the card's bf16 peak, over the window's untraced steps by the host clock."""

from gpubench import readers


def read(view):
    return readers.mfu(view)
