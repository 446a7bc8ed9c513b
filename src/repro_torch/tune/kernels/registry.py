"""Kernel registry: one :class:`KernelSpec` per hand-written CUDA kernel.

A spec bundles everything the tuner needs to treat a kernel's launch
parameters as a paper-style combinatorial space:

  * ``space_fn(meta)``   — the launch-parameter :class:`ConfigSpace` for
    a concrete shape ``meta`` (candidate values include invalid ones —
    non-dividing chunks, shared-memory overflows — which the evaluator
    scores ``inf`` without measuring);
  * ``validate_fn(cfg, meta)`` — ``None`` when the config can launch,
    else a short reason string (free: no kernel run happens);
  * ``make_inputs(meta, dtype, rng, device)`` — seeded random inputs for
    the shape, as tensors on ``device`` (made on the device itself at
    full size: a host copy of the text would not fit);
  * ``run(cfg, inputs)`` — execute the kernel at a candidate;
  * ``ref(inputs)``      — the parity oracle the candidate's output must
    match before its time counts (the kernel's plain PyTorch path).

Registering a new kernel space is one :func:`register_kernel` call; see
``specs.py`` for the built-in kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch

from ...core.space import ConfigSpace

__all__ = ["KernelSpec", "dtype_name", "register_kernel", "get_kernel",
           "list_kernels", "kernel_workload"]


@dataclass(frozen=True)
class KernelSpec:
    name: str
    # the ops.py hardcoded launch params, or where they follow the shape
    # the ops layer's function of meta giving them
    defaults: Mapping[str, Any] | Callable[[Mapping[str, Any]],
                                           Mapping[str, Any]]
    space_fn: Callable[[Mapping[str, Any]], ConfigSpace]
    validate_fn: Callable[[Mapping[str, Any], Mapping[str, Any]], str | None]
    make_inputs: Callable[[Mapping[str, Any], Any, np.random.Generator,
                           torch.device], tuple]
    run: Callable[[Mapping[str, Any], tuple], Any]
    ref: Callable[[tuple], Any]
    default_shape: Mapping[str, Any]      # bench/tune shape (full run)
    smoke_shape: Mapping[str, Any]        # CI-sized shape (tiny spaces OK)
    dtype: str = "float32"                # the ops layer's resolution dtype
    atol: float = 2e-4
    rtol: float = 2e-4

    def space(self, meta: Mapping[str, Any]) -> ConfigSpace:
        return self.space_fn(meta)

    def validate(self, cfg: Mapping[str, Any],
                 meta: Mapping[str, Any]) -> str | None:
        return self.validate_fn(cfg, meta)

    def default_config(self, space: ConfigSpace,
                       meta: Mapping[str, Any] | None = None) -> dict:
        """The hardcoded launch parameters as a point of ``space``.

        When ``meta`` is given and the raw defaults are invalid for that
        shape (e.g. a 2048-symbol chunk on a 1000-symbol text), returns the
        nearest valid config instead — mirroring the clamping the ops
        layer applies to its hardcoded defaults at launch.  Defaults that
        follow the shape are taken at ``meta`` (at ``default_shape`` when
        it is None).
        """
        base = self.defaults
        if callable(base):
            base = base(self.default_shape if meta is None else meta)
        cfg = {p.name: base[p.name] for p in space.params}
        space.validate(cfg)
        if meta is None or self.validate(cfg, meta) is None:
            return cfg
        didx = space.to_indices(cfg)
        best, best_d = None, None
        for row in space.index_grid():
            cand = space.from_indices(row)
            if self.validate(cand, meta) is not None:
                continue
            d = int(np.abs(np.asarray(row) - didx).sum())
            if best is None or d < best_d:
                best, best_d = cand, d
        if best is None:
            raise ValueError(f"kernel {self.name!r} has no valid config "
                             f"for shape {dict(meta)!r}")
        return best


_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(f"unknown kernel {name!r}; registered: "
                         f"{', '.join(list_kernels())}")
    return spec


def list_kernels() -> list[str]:
    """Sorted names of every registered tunable kernel."""
    return sorted(_REGISTRY)


def dtype_name(dtype: Any) -> str:
    """A dtype spelled as numpy spells it (``"uint8"``), whether it was
    given as a string, a numpy dtype or a ``torch.dtype``; ``bfloat16``,
    which numpy lacks, is spelled as JAX spells it."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if dtype == "bfloat16":
        return dtype
    return str(np.dtype(dtype))


def kernel_workload(name: str, meta: Mapping[str, Any], dtype: Any) -> dict:
    """The tuning-store workload payload: kernel + shape signature + dtype.

    Together with the store's device-topology component this keys cached
    results by (kernel name, shape signature, dtype, device kind) — the
    resolution key of the ``tuned=`` fast path.
    """
    return {"kernel": name,
            "shape": {str(k): meta[k] for k in sorted(meta, key=str)},
            "dtype": dtype_name(dtype)}
