"""repro_torch.tune.kernels — autotuning for the CUDA kernel suite.

Closes the loop between the paper's tuning stack (``repro_torch.tune``
sessions, BDTR surrogate, ``TuningStore``) and the repo's hottest code:
each kernel's launch parameters (chunk lengths, threads per block) are a
:class:`~repro_torch.core.space.ConfigSpace`, candidates are evaluated by
a timed-execution oracle that gates on numerical parity against the
kernel's plain PyTorch version (invalid configs score ``inf`` instead of
crashing the search), and the session strategies — ``saml`` by default —
keep measured experiments to <=5% of each space.

Three surfaces:

  * :func:`tune_kernel` — search one (kernel, shape, dtype) and persist
    the winner in a ``TuningStore``;
  * :func:`configure` / :func:`resolve_config` — the serving side: once
    a store is configured, every kernel op called with ``tuned=True``
    (or ``tuned=None`` after ``configure(..., enabled=True)``) resolves
    its cached best config with zero measurements, falling back to the
    hardcoded defaults on a miss;
  * :func:`register_kernel` — add a new kernel's space.

Usage::

    from repro_torch.tune import kernels as ktune

    out = ktune.tune_kernel("dna_automaton", store="kernels.json")
    ktune.configure("kernels.json")          # enable the tuned path
    # ... fa_match(text, table, accept) now runs the tuned launch params
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch

from ... import resolve_device
from .evaluate import KernelTimer, SMEM_LIMIT_BYTES
from .registry import (KernelSpec, dtype_name, get_kernel, kernel_workload,
                       list_kernels, register_kernel)
from .tuner import KernelTuneOutcome, tune_kernel
from . import specs as _specs  # noqa: F401  (registers the built-in kernels)

__all__ = [
    "KernelSpec", "KernelTimer", "KernelTuneOutcome", "SMEM_LIMIT_BYTES",
    "configure", "disable", "get_kernel", "kernel_workload", "list_kernels",
    "register_kernel", "resolve_config", "tune_kernel", "tuning_enabled",
]

# Global tuned-path state: the store serving ``resolve_config`` plus the
# enable flag consulted by ops called with ``tuned=None``.  The resolve
# cache memoizes per (kernel, shape, dtype, device kind) so repeated calls
# do not re-read the store.
_state: dict = {"store": None, "enabled": False, "cache": {}}


def configure(store: Any = None, *, enabled: bool = True,
              device: Any = None) -> None:
    """Install the kernel tuning store (path or ``TuningStore``).

    ``enabled=True`` switches every kernel op's default (``tuned=None``)
    to tuned resolution; ``enabled=False`` installs the store for
    explicit ``tuned=True`` calls only.  ``device`` (``None`` = the card)
    is the device a store opened from a path is keyed by.
    """
    if isinstance(store, (str, os.PathLike)):
        from ...runtime.store import TuningStore
        store = TuningStore(store, device=device)
    _state.update(store=store, enabled=bool(enabled), cache={})


def disable() -> None:
    """Drop the tuned-path store and flag (ops fall back to defaults)."""
    _state.update(store=None, enabled=False, cache={})


def tuning_enabled() -> bool:
    return bool(_state["enabled"]) and _state["store"] is not None


def resolve_config(kernel: str, meta: Mapping[str, Any], dtype: Any, *,
                   device: Any = None) -> dict:
    """Cached best launch params for (kernel, shape, dtype, device kind).

    Pure lookup — zero measurements.  Returns ``{}`` when no store is
    configured, the kernel is unregistered, the store has no entry for
    this workload signature, or the store is keyed by another kind of
    device than ``device``, the one the call runs on (the caller keeps
    its defaults).

    The store key already hashes the space fingerprint (param names,
    domains, ordinality), so editing a kernel's :class:`ConfigSpace` in
    ``specs.py`` invalidates every record tuned against the old space —
    a stale winner can never be served to a redefined kernel.  As a
    second line of defense (hand-edited stores, renamed launch params),
    a resolved config must still be a valid point of the *current*
    space for this shape, else it is dropped and the defaults win.
    """
    store = _state["store"]
    if store is None:
        return {}
    if device is not None and getattr(store, "devices", None) is None:
        # live topology: the store's own device decides the key
        if resolve_device(store.device).type != torch.device(device).type:
            return {}
    key = (kernel,
           tuple(sorted((str(k), v) for k, v in meta.items())),
           dtype_name(dtype))
    cache = _state["cache"]
    if key not in cache:
        try:
            spec = get_kernel(kernel)
        except ValueError:
            cache[key] = {}
        else:
            space = spec.space(meta)
            rec = store.best_record(space, kernel_workload(kernel, meta,
                                                           dtype))
            cfg = dict(rec.best_config) if rec is not None else {}
            if cfg:
                try:
                    space.validate(cfg)
                    stale = spec.validate(cfg, meta)
                except (KeyError, ValueError):
                    cfg = {}
                else:
                    if stale is not None:
                        cfg = {}
            cache[key] = cfg
    return cache[key]
