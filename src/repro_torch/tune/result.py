"""The unified tuning result record.

``TuneResult`` is the record the ``TuningStore`` persists (the reference's
deprecated ``TuneReport`` alias is not carried over; the fields and the
on-disk format are the same).  One dataclass serves every strategy in the registry and
every objective: the paper's effort accounting (experiments vs
predictions vs one-time training cost) is unchanged, and multi-objective
runs additionally carry the scored metrics of the winning configuration
and — for enumerating strategies under a ``Pareto`` objective — the
non-dominated front.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["TuneResult"]


@dataclass
class TuneResult:
    strategy: str
    best_config: dict
    best_energy_search: float      # score the search itself saw (pred or meas)
    best_energy_measured: float    # ground-truth (noise-free) score
    n_experiments: int             # measurements performed during the search
    n_predictions: int             # surrogate queries during the search
    n_training_experiments: int    # one-time surrogate training measurements
    space_size: int
    # {iteration: (measured score of best-so-far config, config)}
    checkpoints: dict[int, tuple[float, dict]] = field(default_factory=dict)
    # True when the result was served from a persistent tuning cache
    # (repro_torch.runtime.store) — the counters above then describe the effort
    # of the *original* recorded search, and this tune ran 0 experiments.
    from_cache: bool = False
    # key of the objective the search minimised ("time" is the paper's
    # E = max(T_host, T_device))
    objective: str = "time"
    # ground-truth metric columns of the winning config (e.g. {"time": ...,
    # "energy": ...}) when the evaluator exposes them
    best_metrics: dict = field(default_factory=dict)
    # [[component scores...], config] rows of the non-dominated set, filled
    # by enumerating strategies under a Pareto objective
    pareto_front: list = field(default_factory=list)
    # deduplicated *real executions* behind the search: ``n_experiments``
    # counts oracle calls (repeats of a config served from the oracle's
    # memo included), ``n_measured`` counts distinct configs actually
    # timed on hardware when the oracle exposes that accounting (e.g.
    # ``KernelTimer``); equal to ``n_experiments`` otherwise.  This is
    # the numerator of the paper's ~5%-of-space budget claim.
    n_measured: int = 0

    # ``best_score_*`` are the objective-neutral names for new-API callers;
    # the stored field names keep the paper's "energy" wording (and the
    # on-disk cache format) stable.
    @property
    def best_score_search(self) -> float:
        return self.best_energy_search

    @property
    def best_score_measured(self) -> float:
        return self.best_energy_measured

    @property
    def experiments_fraction(self) -> float:
        """Search experiments as a fraction of the enumeration count.

        A degenerate/empty space (``space_size <= 0`` — e.g. a manually
        constructed or deserialized result) yields 0.0 rather than a
        division error or a nonsensical ratio.
        """
        if self.space_size <= 0:
            return 0.0
        return self.n_experiments / self.space_size
