"""Run-time state of the tuner.

``store`` — persistent tuning cache.
    :class:`~repro_torch.runtime.store.TuningStore` keys recorded
    ``TuneResult``s by workload signature (space hash + shapes + device
    topology); ``repro_torch.tune.TuningSession(store=...)`` serves
    repeated workloads with zero new measurements.
"""

from .store import TuningStore, space_fingerprint, workload_signature

__all__ = ["TuningStore", "space_fingerprint", "workload_signature"]
