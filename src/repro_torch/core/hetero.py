"""Heterogeneous work distribution across device groups.

The paper's runtime: two device groups of different speed (the host's
CPU threads and the card, here) process complementary fractions of every
batch.  Both dispatches return at once — a card step enqueues its copy
and kernels and hands back an event-backed handle, a host step runs on a
worker thread and hands back a future-backed one — so the step time is
``E = max(T_a, T_b)``, exactly the paper's objective (Eq. 2), and the
work fraction is the paper's tunable.

Two tuning modes:
  * ``proportional_rebalance`` — online controller from observed rates
    (straggler mitigation: a slowing group sheds work every step);
  * the full paper loop — a ``TuningSession`` (SAM/SAML) over the
    fraction space with measured step times as the objective, for the
    initial configuration search.

A batch is a dict of tensors (or arrays) sharing their leading row
dimension; ``tree_leaves`` / ``tree_map`` walk it as the reference walks
a JAX pytree (dict keys in sorted order, ``None`` an empty subtree).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["DeviceGroup", "HeterogeneousRunner", "proportional_rebalance",
           "result_ready_time", "tree_leaves", "tree_map"]


def tree_leaves(tree: Any) -> list:
    """The leaves of a nest of dicts, lists and tuples, dict keys sorted."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` (and to the same leaves of
    the trees in ``rest``), keeping the nesting."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def result_ready_time(result) -> float | None:
    """Exact completion instant of a dispatch result, when knowable.

    Emulated results (``repro_torch.runtime.simulate.SimReadyAt``) expose
    ``ready_at`` — the absolute instant (wall or virtual clock) the
    result became ready; returning it makes timing independent of
    thread wake-up latency, which is what lets whole trajectories run
    on a deterministic :class:`~repro_torch.runtime.simulate.VirtualClock`.
    Real results (tensors, event- or future-backed handles) have no such
    attribute: return ``None`` and the caller falls back to reading its
    clock after waiting.
    """
    ts = None
    for leaf in tree_leaves(result):
        t = getattr(leaf, "ready_at", None)
        if t is None:
            return None
        ts = t if ts is None else max(ts, t)
    return ts


def block_result(result) -> None:
    """Wait for every leaf of a dispatch result that can be waited on
    (duck-typed ``block_until_ready``: the port's event- and
    future-backed handles, simulated results); plain tensors and arrays
    are already complete."""
    for leaf in tree_leaves(result):
        blocker = getattr(leaf, "block_until_ready", None)
        if blocker is not None:
            blocker()


@dataclass
class DeviceGroup:
    name: str
    devices: list                       # torch devices (their count aligns rows)
    work_multiplier: int = 1            # test hook: emulate a slower group


def proportional_rebalance(fraction: float, t_a: float, t_b: float,
                           damping: float = 0.5,
                           min_fraction: float = 1e-3) -> float:
    """New fraction for group A from observed per-group times.

    Observed rates: r_a = f/t_a, r_b = (1-f)/t_b; the equal-finish-time
    split is r_a/(r_a+r_b).  ``damping`` smooths measurement noise.

    Degenerate measurements (zero or negative time on either side —
    clock skew, dropped timer) carry no rate information, so the current
    split is kept.  The result is always clamped to
    ``[min_fraction, 1 - min_fraction]``: a group may be starved of
    *almost* all work but never permanently — it keeps receiving a sliver
    of each batch, so a recovered straggler produces a finite time and
    wins work back.  (The N-group generalization is
    ``repro_torch.runtime.scheduler.ewma_rebalance``.)
    """
    f = min(max(fraction, min_fraction), 1.0 - min_fraction)
    if t_a <= 0.0 or t_b <= 0.0:
        return float(f)
    r_a = f / t_a
    r_b = (1.0 - f) / t_b
    target = r_a / (r_a + r_b)
    out = (1 - damping) * f + damping * target
    return float(min(max(out, min_fraction), 1.0 - min_fraction))


class HeterogeneousRunner:
    """Split each batch between two device groups by a tunable fraction."""

    def __init__(self, step_builder: Callable[[DeviceGroup], Callable],
                 group_a: DeviceGroup, group_b: DeviceGroup,
                 fraction: float = 0.5, *, clock=None):
        """``step_builder(group)`` returns ``fn(batch_rows) -> result`` that
        runs on that group's devices and returns without waiting for the
        work.  ``fraction`` is group A's share of each batch.  ``clock``
        (anything with ``now()``, e.g. a ``runtime.simulate.VirtualClock``
        shared with a simulated builder) replaces the wall clock so
        simulated trajectories are deterministic."""
        self.group_a = group_a
        self.group_b = group_b
        self.fraction = fraction
        self.clock = clock
        self._fn_a = step_builder(group_a)
        self._fn_b = step_builder(group_b)
        self.history: list[dict] = []

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.perf_counter()

    def _split(self, batch: dict) -> tuple[dict, dict]:
        n = tree_leaves(batch)[0].shape[0]
        ga, gb = len(self.group_a.devices), len(self.group_b.devices)
        n_a = int(round(n * self.fraction / ga)) * ga
        n_a = min(max(n_a, ga), n - gb)
        a = tree_map(lambda x: x[:n_a], batch)
        b = tree_map(lambda x: x[n_a:], batch)
        return a, b

    _block = staticmethod(block_result)

    def step(self, batch: dict, rebalance: bool = True) -> dict:
        a, b = self._split(batch)
        t0 = self._now()
        ra = self._fn_a(a)                      # returns at once
        rb = self._fn_b(b)                      # overlaps with group A
        self._block(ra)
        ready_a = result_ready_time(ra)
        t_a = (ready_a if ready_a is not None else self._now()) - t0
        self._block(rb)
        ready_b = result_ready_time(rb)
        t_b = (ready_b if ready_b is not None else self._now()) - t0
        rec = {
            "fraction": self.fraction,
            "t_a": t_a, "t_b": t_b, "t_step": max(t_a, t_b),
            "rows_a": tree_leaves(a)[0].shape[0],
            "rows_b": tree_leaves(b)[0].shape[0],
        }
        self.history.append(rec)
        if rebalance:
            self.fraction = proportional_rebalance(self.fraction, t_a, t_b)
        return rec

    # -- the paper's offline search over the fraction space -------------------
    def workload(self, batch: dict) -> dict:
        """Workload-signature payload for the tuning cache: batch shapes
        plus the device-group topology (see ``repro_torch.runtime.store``)."""
        shapes = {k: (tuple(v.shape), str(getattr(v, "dtype", "")))
                  for k, v in sorted(batch.items())}
        groups = [(g.name, len(g.devices), g.work_multiplier)
                  for g in (self.group_a, self.group_b)]
        return {"batch": shapes, "groups": groups}

    def tuning_session(self, batch: dict, *, store=None, **session_kw):
        """A ``repro_torch.tune.TuningSession`` over this runner's fraction
        space.

        The evaluator dispatches the batch at the candidate fraction and
        returns the measured step metrics (``time`` = max(T_a, T_b), the
        per-group times under ``t_host``/``t_device``).  ``store`` (a
        ``repro_torch.runtime.store.TuningStore`` or a path) caches
        results under this workload's signature.
        """
        from ..tune import TuningSession
        from .space import ConfigSpace, Param

        space = ConfigSpace([Param("fraction", tuple(range(5, 100, 5)))])

        def measure(cfg):
            self.fraction = cfg["fraction"] / 100.0
            rec = self.step(batch, rebalance=False)
            return {"time": rec["t_step"], "t_host": rec["t_a"],
                    "t_device": rec["t_b"]}

        return TuningSession(
            space, evaluator=measure, store=store,
            workload=self.workload(batch) if store is not None else None,
            **session_kw)

    def tune_fraction(self, batch: dict, *, strategy: str = "sam",
                      iterations: int = 30, seed: int = 0, store=None,
                      **session_kw) -> float:
        """Tune the work fraction with any registered strategy (default:
        the paper's SAM — simulated annealing with measured step times)
        and apply the winner."""
        session = self.tuning_session(batch, store=store, **session_kw)
        result = session.run(strategy, iterations=iterations, seed=seed)
        self.fraction = result.best_config["fraction"] / 100.0
        return self.fraction
