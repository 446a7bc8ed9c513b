"""What a step on **meta** tensors shows without a device: the live bytes
it would hold at its peak, the FLOPs of its PyTorch operations and the
kernels it would launch.

``trace(fn, args, resident)`` runs ``fn(*args)`` once under two dispatch
modes and the kernel census (``kernels.census.CENSUS``):

* ``LiveBytes`` counts every meta tensor storage from the operation that
  makes it until it is freed (a weak reference on the storage), each
  rounded up to the 512 bytes the CUDA caching allocator rounds a block
  to, so its peak is comparable with ``torch.cuda.max_memory_allocated``
  after ``reset_peak_memory_stats``; the storages of ``resident`` (the
  parameters, optimizer state, batch and caches the step is given) count
  from the start.  A view shares its base's storage and counts once.
* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
  products and convolutions PyTorch runs; the kernels' work (which
  PyTorch does not see) comes from the census.

The meta path is the one the card runs: the kernel wrappers allocate
their outputs and scratch as their CUDA branches do and launch nothing
(``kernels/*/kernel.py``).  What the card allocates that a meta tensor
cannot show (cuBLAS workspaces, an operation whose CUDA implementation
allocates scratch its meta function does not) is not counted.
"""

from __future__ import annotations

import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..kernels.census import CENSUS

__all__ = ["LiveBytes", "block_bytes", "trace"]

# the CUDA caching allocator's smallest block (kMinBlockSize)
ALLOC_ROUND = 512


def block_bytes(nbytes: int) -> int:
    """``nbytes`` rounded up to the allocator's block size."""
    return -(-int(nbytes) // ALLOC_ROUND) * ALLOC_ROUND


class LiveBytes(TorchDispatchMode):
    """The bytes of live meta storages while the mode is on, and their
    peak (see the module docstring)."""

    def __init__(self, resident=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}
        for t in resident:
            self.track(t)

    def track(self, t) -> None:
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = block_bytes(st.nbytes())

        def freed(_, key=key, n=n):
            self._refs.pop(key, None)
            self.live -= n

        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            self.track(t)
        return out


def trace(fn, args: tuple, resident=()) -> dict:
    """``fn(*args)`` on meta tensors: ``{"out", "seconds", "resident_bytes",
    "peak_bytes", "torch_flops", "kernel_flops", "kernels"}`` (the census
    of the kernels' meta calls, by wrapper).  ``resident`` is every tensor
    the step is given (counted from the start)."""
    CENSUS.reset()
    t0 = time.perf_counter()
    live = LiveBytes(resident)
    start = live.live
    with FlopCounterMode(display=False) as flops, live:
        out = fn(*args)
    return {"out": out, "seconds": time.perf_counter() - t0,
            "resident_bytes": start, "peak_bytes": live.peak,
            "torch_flops": float(flops.get_total_flops()),
            "kernel_flops": CENSUS.flops(), "kernels": CENSUS.snapshot()}
