"""Hand-written CUDA kernels for the repo's compute hot spots.

Each kernel lives in its own package: ``kernel.py`` (the ``ctypes``
wrapper around the CUDA C++ kernel in ``csrc/``, with its plain PyTorch
version beside it), ``ops.py`` (the public function) and ``ref.py`` (a
plain sequential oracle used by the tests).

Launch parameters (chunk lengths, threads per block) are tunable: every
``ops.py`` entry point accepts explicit overrides, and a ``tuned=``
switch that resolves the cached best configuration for the call's
shape/dtype from ``repro_torch.tune.kernels`` (the paper's
combinatorial-search loop applied to the kernels themselves).  This
module holds the pieces shared by all kernels:

  * :func:`largest_aligned_divisor` — clamp a requested block size to a
    valid divisor of the extent (it clamps, it never asserts),
  * :func:`resolve_launch_params` — defaults < tuned cache < explicit
    overrides, with the tuned lookup deferred so the kernels stay
    importable without the tuning stack,
  * :class:`KernelLaunchError` — what a wrapper raises when the CUDA runtime
    refuses a launch (too many threads or too much shared memory for
    the kernel); the kernel timer scores exactly this error as an
    invalid configuration.

The reference's ``grid_compiler_params`` (Mosaic ``dimension_semantics``
for a Pallas grid) has no counterpart: CUDA blocks always run in
parallel and in no order, so there is nothing to declare.  The ``dims``
launch parameter that fed it is replaced by ``block_threads``.
"""

from __future__ import annotations

import sys
from typing import Any, Mapping

__all__ = ["KernelLaunchError", "SMEM_LIMIT_BYTES", "largest_aligned_divisor",
           "resolve_launch_params"]

# Shared memory one block can use on Hopper (227 KB of the SM's 256 KB;
# above 48 KB only as dynamic shared memory the kernel opts in to).
SMEM_LIMIT_BYTES = 232448


class KernelLaunchError(RuntimeError):
    """The CUDA runtime refused a kernel launch (``cudaGetLastError() != 0``).

    A refused launch never runs, so the configuration that asked for it
    is invalid for this kernel on this card.
    """


def largest_aligned_divisor(n: int, cap: int, align: int = 1) -> int:
    """Largest divisor of ``n`` that is ``<= cap``, preferring multiples
    of ``align`` when any exist under the cap.

    Divisors are enumerated in O(sqrt n), except when ``cap`` itself is
    an aligned divisor (the common case, and the one a full-size text
    takes: sqrt(3 * 2^30) Python iterations per call would cost more host
    time than both kernels take on the card).  ``n >= 1`` always yields
    at least 1.
    """
    if n < 1:
        raise ValueError(f"extent must be >= 1, got {n}")
    cap = max(min(cap, n), 1)
    if n % cap == 0 and cap % align == 0:
        return cap
    divisors = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            if i <= cap:
                divisors.append(i)
            if n // i <= cap:
                divisors.append(n // i)
        i += 1
    aligned = [d for d in divisors if d % align == 0]
    return max(aligned or divisors)


def resolve_launch_params(kernel: str, meta: Mapping[str, Any], dtype: Any,
                          *, defaults: Mapping[str, Any],
                          overrides: Mapping[str, Any] | None = None,
                          tuned: bool | None = None,
                          device: Any = None) -> dict:
    """Launch parameters for one kernel call.

    Precedence: hardcoded ``defaults`` < tuned-store best config <
    caller ``overrides`` (entries that are not ``None``).  ``tuned=None``
    consults the cache only when kernel tuning was enabled globally
    (``repro_torch.tune.kernels.configure``); ``tuned=True`` always
    consults it; ``tuned=False`` never does.  The lookup performs zero
    measurements — a store miss falls back to the defaults.  ``device``
    is the device the call runs on: a record tuned on another kind of
    device is not served.
    """
    params = dict(defaults)
    # tuned=None can only resolve after repro_torch.tune.kernels.configure()
    # ran, which requires the module to be imported — so when it is not
    # in sys.modules, skip without pulling in the tuning stack at all
    if tuned or (tuned is None
                 and "repro_torch.tune.kernels" in sys.modules):
        from ..tune import kernels as ktune
        if tuned or ktune.tuning_enabled():
            best = ktune.resolve_config(kernel, meta, dtype, device=device)
            params.update({k: v for k, v in best.items() if k in params})
    if overrides:
        params.update({k: v for k, v in overrides.items() if v is not None})
    return params
