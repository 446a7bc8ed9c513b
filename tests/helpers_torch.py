"""Helpers for the port's kernel tests: a tensor that reports a CUDA
device on a machine without one.

``on_fake_card(fn, *tensors)`` calls ``fn`` on stand-ins of ``tensors``
(the same shapes, strides and dtypes) made under ``FakeTensorMode`` on
device ``"cuda"``: a kernel wrapper takes its CUDA branch for them, as it
would on the card, and the test holds it to building the library (made to
fail here) or raising.  A ``meta`` tensor no longer stands for "off the
CPU": it takes the wrappers' shape-only branch (``kernels.census``).
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

__all__ = ["fake_delta", "on_fake_card"]


def fake_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """B5's ``delta`` of its shape and dtype: a fake CUDA tensor cannot be
    made contiguous on a build without CUDA (the plain PyTorch step
    before the kernel; the kernel is what the tests hold)."""
    b, tq, h, _ = o.shape
    return torch.empty((b, h, tq), dtype=torch.float32, device=o.device)


def on_fake_card(fn, *tensors, **kw):
    with FakeTensorMode():
        args = [torch.empty_strided(tuple(t.shape), t.stride(),
                                    dtype=t.dtype, device="cuda")
                for t in tensors]
        return fn(*args, **kw)
