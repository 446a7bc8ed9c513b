"""Device activities (kernels, copies, sets) a training step launches, as
the trace holds them: PyTorch eager's dispatch under ``train_step``."""


def read(view):
    if view.units <= 0 or not view.acts:
        return None
    return len(view.acts) / view.units
