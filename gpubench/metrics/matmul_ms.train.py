"""Device ms a training step in cuBLAS's matrix products."""

from gpubench import devtrace, readers


def read(view):
    acts = [a for a in view.acts if devtrace.is_matmul(a.name)]
    return readers.per_unit_ms(view, acts) if acts else None
