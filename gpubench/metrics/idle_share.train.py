"""The share of the traced training steps' wall time in which nothing ran
on the card: 1 - the union of its activities' intervals / the window."""

from gpubench import readers


def read(view):
    return readers.idle_share(view)
