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
  * **then time** — best-of-``repeats`` device time per call, each
    repeat a batch of back-to-back calls between two CUDA events (the
    first call warms and builds; on ``device="cpu"`` it is host wall time
    of one call).  A probe call sizes the batch to about ``MIN_BATCH_S``
    and measures how long the host takes to enqueue one call; before each
    batch the card is held by a spin long enough for the host to enqueue
    the whole batch, so the events bracket device work only.  Without the
    spin, a call whose launches are shorter than the host's time to issue
    them (a decode kernel followed by a plain five-launch split combine:
    ~0.09 ms of device work, ~0.15 ms of host work) is timed at the host's
    pace, the same for every configuration and 2x apart between runs, and
    the tune ranks noise.

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

import functools
import time
from typing import Any, Mapping

import numpy as np
import torch

from ... import resolve_device
from ...kernels import SMEM_LIMIT_BYTES, KernelLaunchError
from .registry import KernelSpec, dtype_name

__all__ = ["KernelTimer", "MAX_BATCH", "MIN_BATCH_S", "SMEM_LIMIT_BYTES",
           "SPIN_CYCLES_PER_S", "device_seconds", "probe_seconds"]

MIN_BATCH_S = 1e-3      # a timed batch of calls lasts about this long
MAX_BATCH = 1000        # ... and holds at most this many calls
# spin cycles per second of host enqueue time to cover: the H100's SM clock
# is at most 1.98 GHz, so the spin lasts at least as long as asked
SPIN_CYCLES_PER_S = 2e9


def probe_seconds(fn, device: torch.device) -> tuple[float, float]:
    """One call of ``fn``: (host seconds to enqueue it, seconds from an
    event before it to one after it, host gaps included).  On the host the
    two are one wall time."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        return host_s, host_s
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return host_s, start.elapsed_time(end) / 1e3


def device_seconds(fn, calls: int, host_s: float) -> float:
    """Device seconds per call of ``fn`` over ``calls`` back-to-back calls
    between two CUDA events.  The card is first held by a spin long enough
    for the host to enqueue all of them (``host_s``: its time to enqueue
    one), so the events bracket device work only, not the host's pace."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (2 * calls * host_s + 1e-4)))
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


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
        run = functools.partial(self.spec.run, cfg, self.inputs)
        if self.device.type != "cuda":
            times = [probe_seconds(run, self.device)[0]
                     for _ in range(self.repeats)]
        else:
            host_s, probe_s = probe_seconds(run, self.device)
            calls = int(min(MAX_BATCH, max(1, np.ceil(MIN_BATCH_S / probe_s))))
            times = [device_seconds(run, calls, host_s)
                     for _ in range(self.repeats)]
        self.n_measured += 1
        return float(min(times))
