"""Parametric performance model of the paper's experimental platform.

The paper measures a DNA-sequence-analysis application on "Emil": a host
with 2x Intel Xeon E5-2695v2 (48 hw threads, 30 MB L3, ~59.7 GB/s) plus an
Intel Xeon Phi 7120P (61 cores / 244 threads, 352 GB/s, PCIe-attached).
The reproduction replaces the physical node with a calibrated analytic
model with the same observable structure the paper reports:

  * saturating thread-scaling on both sides (memory-bound stream workload),
  * affinity multipliers (compact hurts, scatter/balanced help),
  * offload overhead on the device side = fixed runtime startup + PCIe
    transfer proportional to the offloaded bytes,
  * mild cache superlinearity (smaller working set -> lower per-byte cost;
    both sides have ~30 MB LLC, so partial fractions run disproportionately
    faster — this is what makes the tuned split beat the naive
    rate-proportional split, as in the paper's measurements),
  * multiplicative lognormal measurement noise (seeded, reproducible).

Calibration targets (from the paper): host-side execution times span
~0.74-5.5 s and device-side ~0.9-42 s across the measured grid; the best
split sits around 60/40-70/30 host/device for large inputs with 48 host
threads (Fig. 2b); tuned-vs-host-only speedup ~1.7-1.95x and
tuned-vs-device-only ~2.1-2.36x (Tables VIII-IX).
``tests/test_torch_platform_model.py`` asserts these bands.

The model evaluates E = max(T_host, T_device) (paper Eq. 2) — host and
device shares run concurrently under the offload-overlap execution model.

Beyond the paper, the model also carries an **energy column** (joules):
each side draws base + per-thread watts while its share runs (the Phi is
the power-hungry side), enabling the energy-aware objectives of
``repro_torch.tune`` (``metrics`` / ``metrics_batch`` / ``evaluator`` return
``{"time", "energy", "t_host", "t_device"}`` records).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np

__all__ = ["EmilPlatformModel", "DATASETS_GB"]

# Real-world DNA sequence sizes used in the paper (GB).
DATASETS_GB: dict[str, float] = {
    "human": 3.17,
    "mouse": 2.77,
    "cat": 2.43,
    "dog": 2.38,
}


@dataclass(frozen=True)
class EmilPlatformModel:
    """Analytic execution-time model for one (host, device) node."""

    # Host: saturating rate R(h) = rate_max * h / (h + k)  [GB/s]
    host_rate_max: float = 2.0
    host_rate_k: float = 6.0
    # Device (Xeon Phi): needs many threads to saturate.
    device_rate_max: float = 3.5
    device_rate_k: float = 80.0
    # Offload overhead: fixed runtime startup + PCIe transfer of the share.
    device_startup_s: float = 0.35
    pcie_gbps: float = 6.0
    # Cache superlinearity: per-byte cost multiplier  c0 + c1 * min(1, GB/ref)
    host_cache_c0: float = 0.76
    host_cache_c1: float = 0.24
    device_cache_c0: float = 0.80
    device_cache_c1: float = 0.20
    cache_ref_gb: float = 3.2
    # Affinity multipliers on execution time.
    host_affinity_mult: Mapping[str, float] | None = None
    device_affinity_mult: Mapping[str, float] | None = None
    # Measurement noise (lognormal sigma); 0 disables.
    noise_sigma: float = 0.015
    # Power draw (watts) for the energy-to-solution column: each side
    # consumes base + per-thread power while its share runs.  Defaults
    # approximate the platform's TDPs (2x Xeon E5-2695v2 ~230 W total at
    # 48 threads; Xeon Phi 7120P ~300 W at 240 threads) — the Phi is the
    # power-hungry side, so time- and energy-optimal splits differ.
    host_base_w: float = 80.0
    host_thread_w: float = 3.2
    device_base_w: float = 110.0
    device_thread_w: float = 0.85

    _DEFAULT_HOST_AFF = {"none": 1.00, "scatter": 0.98, "compact": 1.10}
    _DEFAULT_DEVICE_AFF = {"balanced": 0.96, "scatter": 1.00, "compact": 1.12}

    def _host_aff(self, aff: str) -> float:
        table = self.host_affinity_mult or self._DEFAULT_HOST_AFF
        return table[aff]

    def _device_aff(self, aff: str, threads: int) -> float:
        table = self.device_affinity_mult or self._DEFAULT_DEVICE_AFF
        m = table[aff]
        # compact packs 4 threads/core: with few threads it strands cores.
        if aff == "compact" and threads <= 60:
            m *= 1.10
        return m

    # -- component times -------------------------------------------------------
    def host_time(self, gb: float, threads: int, affinity: str) -> float:
        """Noise-free host execution time for ``gb`` of input."""
        if gb <= 0.0:
            return 0.0
        rate = self.host_rate_max * threads / (threads + self.host_rate_k)
        cache = self.host_cache_c0 + self.host_cache_c1 * min(
            1.0, gb / self.cache_ref_gb
        )
        return gb / rate * self._host_aff(affinity) * cache

    def device_time(self, gb: float, threads: int, affinity: str) -> float:
        """Noise-free device execution time (incl. offload overhead)."""
        if gb <= 0.0:
            return 0.0
        rate = self.device_rate_max * threads / (threads + self.device_rate_k)
        cache = self.device_cache_c0 + self.device_cache_c1 * min(
            1.0, gb / self.cache_ref_gb
        )
        compute = gb / rate * self._device_aff(affinity, threads) * cache
        return self.device_startup_s + gb / self.pcie_gbps + compute

    # -- vectorized component times --------------------------------------------
    @staticmethod
    def _aff_lookup(aff: np.ndarray, table: Mapping[str, float]) -> np.ndarray:
        """Vectorized table lookup; unknown names raise like the scalar path."""
        out = np.empty(len(aff))
        seen = np.zeros(len(aff), dtype=bool)
        for name, mult in table.items():
            m = aff == name
            out[m] = mult
            seen |= m
        if not seen.all():
            raise KeyError(str(np.unique(aff[~seen]).tolist()))
        return out

    def _host_aff_array(self, aff: np.ndarray) -> np.ndarray:
        return self._aff_lookup(
            aff, self.host_affinity_mult or self._DEFAULT_HOST_AFF)

    def _device_aff_array(self, aff: np.ndarray, threads: np.ndarray
                          ) -> np.ndarray:
        out = self._aff_lookup(
            aff, self.device_affinity_mult or self._DEFAULT_DEVICE_AFF)
        return np.where((aff == "compact") & (threads <= 60), out * 1.10, out)

    def host_time_batch(self, gb: np.ndarray, threads: np.ndarray,
                        affinity: np.ndarray) -> np.ndarray:
        """Vectorized ``host_time`` over aligned arrays."""
        gb = np.asarray(gb, dtype=np.float64)
        threads = np.asarray(threads, dtype=np.float64)
        rate = self.host_rate_max * threads / (threads + self.host_rate_k)
        cache = self.host_cache_c0 + self.host_cache_c1 * np.minimum(
            1.0, gb / self.cache_ref_gb
        )
        t = gb / rate * self._host_aff_array(np.asarray(affinity)) * cache
        return np.where(gb > 0.0, t, 0.0)

    def device_time_batch(self, gb: np.ndarray, threads: np.ndarray,
                          affinity: np.ndarray) -> np.ndarray:
        """Vectorized ``device_time`` over aligned arrays."""
        gb = np.asarray(gb, dtype=np.float64)
        threads = np.asarray(threads, dtype=np.float64)
        rate = self.device_rate_max * threads / (threads + self.device_rate_k)
        cache = self.device_cache_c0 + self.device_cache_c1 * np.minimum(
            1.0, gb / self.cache_ref_gb
        )
        compute = (gb / rate * cache
                   * self._device_aff_array(np.asarray(affinity), threads))
        t = self.device_startup_s + gb / self.pcie_gbps + compute
        return np.where(gb > 0.0, t, 0.0)

    def energy_batch(self, columns: Mapping[str, np.ndarray],
                     dataset_gb: float,
                     rng: np.random.Generator | None = None) -> np.ndarray:
        """Vectorized ``energy`` over a column-oriented batch of configs.

        ``columns`` maps the paper's parameter names to aligned value
        arrays (e.g. ``ConfigSpace.enumerate_columns()``).  One call
        replaces ``space.size()`` scalar measurements; noise draws are
        independent per entry, as in repeated scalar calls.
        """
        f = np.asarray(columns["host_fraction"], dtype=np.float64) / 100.0
        th = self.host_time_batch(dataset_gb * f,
                                  np.asarray(columns["host_threads"]),
                                  np.asarray(columns["host_affinity"]))
        td = self.device_time_batch(dataset_gb * (1.0 - f),
                                    np.asarray(columns["device_threads"]),
                                    np.asarray(columns["device_affinity"]))
        if rng is not None and self.noise_sigma > 0:
            th = th * np.where(th > 0,
                               np.exp(rng.normal(0.0, self.noise_sigma,
                                                 th.shape)), 1.0)
            td = td * np.where(td > 0,
                               np.exp(rng.normal(0.0, self.noise_sigma,
                                                 td.shape)), 1.0)
        return np.maximum(th, td)

    # -- the measurement oracle -------------------------------------------------
    def measure(self, config: Mapping, dataset_gb: float,
                rng: np.random.Generator | None = None) -> tuple[float, float]:
        """(T_host, T_device) for a full system configuration.

        ``config`` uses the paper's parameter names (see ``space.paper_space``):
        host_threads, device_threads, host_affinity, device_affinity,
        host_fraction (percent of work mapped to the host).
        """
        f = float(config["host_fraction"]) / 100.0
        th = self.host_time(dataset_gb * f, int(config["host_threads"]),
                            str(config["host_affinity"]))
        td = self.device_time(dataset_gb * (1.0 - f),
                              int(config["device_threads"]),
                              str(config["device_affinity"]))
        if rng is not None and self.noise_sigma > 0:
            th *= math.exp(rng.normal(0.0, self.noise_sigma)) if th > 0 else 1.0
            td *= math.exp(rng.normal(0.0, self.noise_sigma)) if td > 0 else 1.0
        return th, td

    def energy(self, config: Mapping, dataset_gb: float,
               rng: np.random.Generator | None = None) -> float:
        """E = max(T_host, T_device)   (paper Eq. 2)."""
        th, td = self.measure(config, dataset_gb, rng)
        return max(th, td)

    # -- the energy column (joules) and multi-metric oracles ---------------------
    def _power_w(self, host_threads: Any, device_threads: Any
                 ) -> tuple[Any, Any]:
        """Per-side power draw (watts) while that side's share runs."""
        ph = self.host_base_w + self.host_thread_w * host_threads
        pd = self.device_base_w + self.device_thread_w * device_threads
        return ph, pd

    def joules(self, config: Mapping, dataset_gb: float,
               rng: np.random.Generator | None = None) -> float:
        """Energy-to-solution: sum of per-side time x power draws."""
        return self.metrics(config, dataset_gb, rng)["energy"]

    def metrics(self, config: Mapping, dataset_gb: float,
                rng: np.random.Generator | None = None) -> dict[str, float]:
        """One measurement as a metrics record.

        Returns ``{"time", "energy", "t_host", "t_device"}`` — the
        paper's E = max(T_host, T_device) under ``"time"`` and the
        energy-to-solution column (joules) under ``"energy"``, from a
        single pair of (possibly noisy) per-side measurements.
        """
        th, td = self.measure(config, dataset_gb, rng)
        ph, pd = self._power_w(float(config["host_threads"]),
                               float(config["device_threads"]))
        return {"time": max(th, td), "energy": th * ph + td * pd,
                "t_host": th, "t_device": td}

    def metrics_batch(self, columns: Mapping[str, np.ndarray],
                      dataset_gb: float,
                      rng: np.random.Generator | None = None
                      ) -> dict[str, np.ndarray]:
        """Vectorized ``metrics`` over a column-oriented config batch.

        Noise draws consume ``rng`` in the same order as ``energy_batch``
        (one host vector, then one device vector), so seeded scores on
        the ``"time"`` column match the time-only batched oracle.
        """
        f = np.asarray(columns["host_fraction"], dtype=np.float64) / 100.0
        ht = np.asarray(columns["host_threads"], dtype=np.float64)
        dt = np.asarray(columns["device_threads"], dtype=np.float64)
        th = self.host_time_batch(dataset_gb * f, ht,
                                  np.asarray(columns["host_affinity"]))
        td = self.device_time_batch(dataset_gb * (1.0 - f), dt,
                                    np.asarray(columns["device_affinity"]))
        if rng is not None and self.noise_sigma > 0:
            th = th * np.where(th > 0,
                               np.exp(rng.normal(0.0, self.noise_sigma,
                                                 th.shape)), 1.0)
            td = td * np.where(td > 0,
                               np.exp(rng.normal(0.0, self.noise_sigma,
                                                 td.shape)), 1.0)
        ph, pd = self._power_w(ht, dt)
        return {"time": np.maximum(th, td), "energy": th * ph + td * pd,
                "t_host": th, "t_device": td}

    def evaluator(self, dataset_gb: float,
                  rng: np.random.Generator | None = None):
        """Both oracle paths bundled for ``repro_torch.tune.TuningSession``.

        Returns a ``MetricsEvaluator`` whose scalar and batch paths share
        ``rng`` (pass ``None`` for noise-free ground truth).
        """
        from ..tune.objective import MetricsEvaluator
        return MetricsEvaluator(
            lambda cfg: self.metrics(cfg, dataset_gb, rng),
            lambda cols: self.metrics_batch(cols, dataset_gb, rng))

    # -- reference points used by the paper's speedup tables ---------------------
    def host_only_time(self, dataset_gb: float, threads: int = 48,
                       affinity: str = "scatter") -> float:
        return self.host_time(dataset_gb, threads, affinity)

    def device_only_time(self, dataset_gb: float, threads: int = 240,
                         affinity: str = "balanced") -> float:
        return self.device_time(dataset_gb, threads, affinity)
