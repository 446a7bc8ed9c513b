"""Device ms a training step in PyTorch's own elementwise and reduction
kernels outside the optimizer: every kernel that is not a cuBLAS product,
not one the port built, not a copy and not launched inside ``adamw``."""

from gpubench import devtrace, readers


def read(view):
    adamw = {id(a) for a in devtrace.launched_in(view.trace, "adamw",
                                                 view.acts)}
    acts = [a for a in view.acts
            if id(a) not in adamw and not devtrace.is_matmul(a.name)
            and not readers.is_copy(a.name)
            and not any(k in a.name for k in readers.PORT_KERNELS)]
    return readers.per_unit_ms(view, acts) if acts else None
