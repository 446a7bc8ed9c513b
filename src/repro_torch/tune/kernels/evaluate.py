"""Timed-execution evaluator with a numerical-parity gate.

The paper evaluates a candidate system configuration by running the
experiment; here an experiment is one kernel launch at a candidate's
launch parameters.  :class:`KernelTimer` is the measurement oracle a
:class:`~repro_torch.tune.session.TuningSession` consumes:

  * **validity first** — configs that cannot launch (non-dividing
    chunks, shared-memory overflow, incompatible chunking) score ``inf``
    without running anything, so the search never crashes on them and
    they cost zero experiments;
  * **parity second** — the candidate's output must match the spec's
    oracle (the kernel's plain PyTorch path) within the spec's
    tolerance, else ``inf`` (a fast config that computes the wrong
    thing must never win);
  * **then time** — best-of-``repeats`` device time between two CUDA
    events around the call (the first call warms and builds; on
    ``device="cpu"`` it is host wall time).

Measurements are deduplicated per config (the paper's effort
accounting: re-measuring a recorded experiment is free), and
``n_measured`` counts actual kernel executions — the number compared
against the space size for the <=5% headline claim.

Only one failure is scored as an invalid configuration: the CUDA runtime
refusing the launch (:class:`~repro_torch.kernels.KernelLaunchError`),
counted in ``n_launch_failed``.  A kernel that does not build, a CUDA
fault while it runs, or a parity failure at the spec's own default
configuration is a bug, not a property of a candidate, and propagates —
otherwise a kernel that never works would "tune" to whichever
configuration happens to survive.
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import numpy as np
import torch

from ... import resolve_device
from ...kernels import KernelLaunchError
from .registry import KernelSpec, dtype_name

__all__ = ["KernelTimer", "SMEM_LIMIT_BYTES"]

# Shared memory one block can use on Hopper (227 KB of the SM's 256 KB;
# above 48 KB only as dynamic shared memory the kernel opts in to).
SMEM_LIMIT_BYTES = 232448


def _leaves(out) -> list[torch.Tensor]:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    return [torch.as_tensor(out)]


class KernelTimer:
    """Measurement oracle: ``cfg -> seconds`` (``inf`` = invalid/diverged).

    One timer holds one (kernel, shape, dtype) worth of inputs on one
    device and the precomputed oracle output; every distinct config is
    measured at most once.
    """

    def __init__(self, spec: KernelSpec, meta: Mapping[str, Any], dtype: Any,
                 *, device=None, repeats: int = 3, seed: int = 0,
                 observer=None):
        if observer is not None:
            raise NotImplementedError(
                "KernelTimer(observer=...) needs the observability layer "
                "(obs), which is not ported to repro_torch yet")
        self.spec = spec
        self.meta = dict(meta)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.repeats = max(int(repeats), 1)
        self.inputs = spec.make_inputs(self.meta, dtype,
                                       np.random.default_rng(seed),
                                       self.device)
        self.atol, self.rtol = spec.atol, spec.rtol
        tdtype = getattr(torch, dtype_name(dtype))
        if tdtype.is_floating_point and tdtype.itemsize < 4:   # bf16/f16
            self.atol = max(self.atol, 2e-2)
            self.rtol = max(self.rtol, 2e-2)
        self._expected = None
        self._default_key: tuple | None = None
        self._cache: dict[tuple, float] = {}
        self.n_measured = 0          # actual kernel executions (deduplicated)
        self.n_launch_failed = 0     # launches the CUDA runtime refused
        self.rejected: dict[tuple, str] = {}   # cfg key -> invalidity reason

    def _key(self, cfg: Mapping[str, Any]) -> tuple:
        return tuple(sorted((str(k), cfg[k]) for k in cfg))

    @property
    def expected(self):
        if self._expected is None:
            self._expected = self.spec.ref(self.inputs)
        return self._expected

    def _is_default(self, key: tuple) -> bool:
        if self._default_key is None:
            space = self.spec.space(self.meta)
            self._default_key = self._key(
                self.spec.default_config(space, self.meta))
        return key == self._default_key

    def _parity_ok(self, out) -> bool:
        got, want = _leaves(out), _leaves(self.expected)
        if len(got) != len(want):
            return False
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.allclose(
                    g.double(), w.to(g.device).double(),
                    atol=self.atol, rtol=self.rtol):
                return False
        return True

    def __call__(self, cfg: Mapping[str, Any]) -> float:
        key = self._key(cfg)
        if key in self._cache:
            return self._cache[key]
        reason = self.spec.validate(cfg, self.meta)
        if reason is not None:
            self.rejected[key] = reason
            self._cache[key] = float("inf")
            return float("inf")
        score = self._guarded_measure(cfg, key)
        self._cache[key] = score
        return score

    def _guarded_measure(self, cfg: Mapping[str, Any], key: tuple) -> float:
        try:
            return self._measure(dict(cfg), key)
        except KernelLaunchError as exc:    # refused launch = invalid config
            self.n_launch_failed += 1
            self.rejected[key] = f"launch failed: {exc}"
            return float("inf")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _time_once(self, cfg: dict) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            self.spec.run(cfg, self.inputs)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.spec.run(cfg, self.inputs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def _measure(self, cfg: dict, key: tuple) -> float:
        out = self.spec.run(cfg, self.inputs)       # build + warm
        self._sync()
        if not self._parity_ok(out):
            if self._is_default(key):
                raise RuntimeError(
                    f"kernel {self.spec.name!r} disagrees with its oracle "
                    f"at its default configuration {cfg!r}")
            self.rejected[key] = "parity vs oracle failed"
            return float("inf")
        times = [self._time_once(cfg) for _ in range(self.repeats)]
        self.n_measured += 1
        return float(min(times))
