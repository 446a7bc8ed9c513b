"""Device ms a step of the optimizer (``optim/adamw.py::apply_updates``):
the activities launched inside ``train_step``'s ``adamw`` range."""

from gpubench import devtrace, readers


def read(view):
    acts = devtrace.launched_in(view.trace, "adamw", view.acts)
    return readers.per_unit_ms(view, acts) if acts else None
