"""Chunked online work distribution across N device groups.

``HeterogeneousRunner`` (the paper's runtime, ``core/hetero.py``) does
one static split per batch: each group gets its whole share in a single
dispatch, and the split moves only between batches.  This module turns
that into a live scheduler:

  * each incoming batch is split into **chunks** (row slices aligned to
    each group's device count);
  * chunks are dispatched **asynchronously** and interleaved across
    groups, with at most ``inflight`` chunks outstanding per group —
    a step function returns a handle at once (a card step after
    enqueueing its copy and kernels, a host step after handing the work
    to a worker thread), so chunk k+1's transfer overlaps chunk k's
    compute (double buffering), and the inflight bound keeps live
    buffers constant;
  * per-chunk completion times feed an **EWMA controller**
    (``ewma_rebalance``) that re-splits the next batch — the N-group
    generalization of ``core.hetero.proportional_rebalance``;
  * group membership is **elastic**: ``drop_group``/``restore_group``
    remove and re-admit groups mid-stream (shares re-project onto the
    simplex, plans re-key), and a dispatch that raises or times out
    **demotes** the group automatically, re-dispatching its unfinished
    chunks to the survivors so no batch is ever dropped.

Chunk inputs are annotated with ``dist.api.constrain_leading`` so that
when placement rules are installed each chunk carries its data-parallel
layout (the identity on one card).  Batches are dicts of tensors or
arrays; the orphans of a failed group are merged with ``torch.cat``
(``numpy.concatenate`` for arrays).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.hetero import (DeviceGroup, block_result, result_ready_time,
                           tree_leaves, tree_map)
from ..dist.api import constrain_leading
from ..obs import as_observer

__all__ = ["ChunkedScheduler", "EwmaController", "ewma_rebalance"]


def _slice_spans(spans: Sequence[tuple[int, int]], lo: int,
                 count: int) -> list[tuple[int, int]]:
    """Sub-spans covering rows ``[lo, lo + count)`` of the concatenation
    of ``spans`` (each a ``(batch_row_start, n_rows)`` pair).  Used to
    keep per-row completion attribution exact through the re-dispatch
    path, where orphaned chunks are merged and re-split."""
    out = []
    pos = 0
    for start, n in spans:
        take_lo = max(lo, pos)
        take_hi = min(lo + count, pos + n)
        if take_hi > take_lo:
            out.append((start + take_lo - pos, take_hi - take_lo))
        pos += n
    return out


def _concat_rows(*xs):
    """Row-concatenate orphaned chunk leaves (tensors on one device
    or arrays); the result of a pinned tensor's ``torch.cat`` is not
    pinned, which the recovery path accepts."""
    if isinstance(xs[0], torch.Tensor):
        return torch.cat([torch.as_tensor(x) for x in xs], dim=0)
    return np.concatenate([np.asarray(x) for x in xs], axis=0)


def _project_simplex_floor(w: np.ndarray, floor: float) -> np.ndarray:
    """Nearest share vector with ``sum == 1`` and every entry ``>= floor``
    (scales the above-floor mass uniformly)."""
    n = len(w)
    free = 1.0 - floor * n
    if free <= 0:
        return np.full(n, 1.0 / n)
    slack = np.maximum(np.asarray(w, dtype=np.float64) - floor, 0.0)
    total = slack.sum()
    if total <= 0:
        return np.full(n, 1.0 / n)
    return floor + slack * (free / total)


def ewma_rebalance(shares: Sequence[float], times: Sequence[float],
                   damping: float = 0.5, min_share: float = 0.01,
                   rows: Sequence[int] | None = None) -> np.ndarray:
    """New work shares from observed per-group times (N groups).

    Rates are ``r_i = rows_i / t_i`` (or ``shares_i / t_i`` when row
    counts are not given); the equal-finish-time target is
    ``r_i / sum(r)``, and the update is the EWMA
    ``(1 - damping) * shares + damping * target`` — for two groups with
    ``rows=None`` this is exactly ``proportional_rebalance``.  Degenerate
    measurements (any ``t_i <= 0``) keep the current shares; the result
    is clamped to ``>= min_share`` per group so no group is ever starved
    permanently.
    """
    shares = _project_simplex_floor(np.asarray(shares, np.float64), min_share)
    times = np.asarray(times, dtype=np.float64)
    if times.shape != shares.shape:
        raise ValueError("times must align with shares")
    if (times <= 0.0).any():
        return shares
    work = shares if rows is None else np.asarray(rows, dtype=np.float64)
    rates = work / times
    target = rates / rates.sum()
    out = (1.0 - damping) * shares + damping * target
    return _project_simplex_floor(out, min_share)


@dataclass
class EwmaController:
    """Stateful wrapper around ``ewma_rebalance`` holding current shares
    and **live membership**: dropped groups hold exactly share 0 and are
    excluded from updates; the surviving shares always form a simplex
    floored at ``min_share``."""

    n_groups: int
    damping: float = 0.5
    min_share: float = 0.01
    shares: np.ndarray = field(default=None)  # type: ignore[assignment]
    live: np.ndarray = field(default=None)    # type: ignore[assignment]
    observer: object = field(default=None, repr=False)

    def __post_init__(self):
        # normalize once: disabled observers become None so every
        # per-update check is a single `is not None`
        self.observer = as_observer(self.observer)
        if self.n_groups < 1:
            raise ValueError("need at least one group")
        if self.live is None:
            self.live = np.ones(self.n_groups, dtype=bool)
        else:
            self.live = np.asarray(self.live, dtype=bool).copy()
            if self.live.shape != (self.n_groups,):
                raise ValueError("live mask must have one entry per group")
            if not self.live.any():
                raise ValueError("at least one group must be live")
        if self.shares is None:
            self.shares = np.where(self.live, 1.0 / self.live.sum(), 0.0)
        self.shares = np.asarray(self.shares, np.float64).copy()
        if len(self.shares) != self.n_groups:
            raise ValueError("shares must have one entry per group")
        self._project()

    def _project(self) -> np.ndarray:
        """Re-project: live shares onto the floored simplex, dead to 0."""
        out = np.zeros(self.n_groups)
        out[self.live] = _project_simplex_floor(
            np.asarray(self.shares, np.float64)[self.live], self.min_share)
        self.shares = out
        return out

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def drop(self, i: int) -> np.ndarray:
        """Remove group ``i``: its share goes to exactly 0 and the
        survivors re-project onto the simplex.  Idempotent (demotion can
        race a scripted kill).  The last live group cannot be dropped."""
        if not 0 <= i < self.n_groups:
            raise IndexError(f"group {i} out of range")
        if not self.live[i]:
            return self.shares
        if self.n_live == 1:
            raise RuntimeError("cannot drop the last live group")
        self.live[i] = False
        self.shares[i] = 0.0
        return self._project()

    def restore(self, i: int, share: float | None = None) -> np.ndarray:
        """Re-admit group ``i`` at ``share`` (default ``1 / n_groups``;
        the EWMA pulls it to its rate-proportional share within a few
        steps — even a sliver yields an unbiased rate estimate, since
        rates are rows/time).  Idempotent."""
        if not 0 <= i < self.n_groups:
            raise IndexError(f"group {i} out of range")
        if self.live[i]:
            return self.shares
        if share is None:
            share = 1.0 / self.n_groups
        share = float(min(max(share, self.min_share), 1.0 - self.min_share))
        self.live[i] = True
        self.shares *= (1.0 - share)        # survivors scale down ...
        self.shares[i] = share              # ... to make room
        return self._project()

    def update(self, times: Sequence[float],
               rows: Sequence[int] | None = None) -> np.ndarray:
        """EWMA-rebalance the live groups from observed times (entries
        for dead groups are ignored; their shares stay exactly 0)."""
        times = np.asarray(times, dtype=np.float64)
        if times.shape != (self.n_groups,):
            raise ValueError("times must have one entry per group")
        live = self.live
        if live.all():
            self.shares = ewma_rebalance(self.shares, times, self.damping,
                                         self.min_share, rows=rows)
            self._observe_update()
            return self.shares
        sub_rows = None if rows is None else np.asarray(rows)[live]
        sub = ewma_rebalance(self.shares[live] / self.shares[live].sum(),
                             times[live], self.damping, self.min_share,
                             rows=sub_rows)
        out = np.zeros(self.n_groups)
        out[live] = sub
        self.shares = out
        self._observe_update()
        return self.shares

    def _observe_update(self) -> None:
        if self.observer is None:
            return
        m = self.observer.metrics
        m.counter("controller.updates").inc()
        for i, s in enumerate(self.shares):
            m.gauge(f"controller.share.g{i}").set(round(float(s), 6))

    # -- durability (runtime.checkpoint snapshots) -------------------------
    def state_dict(self) -> dict:
        """JSON-ready recoverable state: shares + live mask."""
        return {"shares": [float(s) for s in self.shares],
                "live": [bool(x) for x in self.live]}

    def load_state(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (re-projected, so a
        hand-edited or stale snapshot still yields a valid simplex)."""
        live = np.asarray(state["live"], dtype=bool)
        shares = np.asarray(state["shares"], np.float64)
        if live.shape != (self.n_groups,) \
                or shares.shape != (self.n_groups,):
            raise ValueError("snapshot group count mismatch")
        if not live.any():
            raise ValueError("snapshot has no live group")
        self.live = live.copy()
        self.shares = shares.copy()
        self._project()


class ChunkedScheduler:
    """Split each batch into chunks, overlap dispatch across N groups,
    rebalance the split online from measured per-chunk times, and
    survive groups degrading or vanishing mid-stream."""

    def __init__(self, step_builder: Callable[[DeviceGroup], Callable],
                 groups: Sequence[DeviceGroup], *,
                 controller: EwmaController | None = None,
                 chunks_per_group: int = 2, inflight: int = 2,
                 row_quantum: int = 1, clock=None,
                 dispatch_timeout_s: float | None = None,
                 observer=None):
        """``step_builder(group)`` returns ``fn(chunk) -> result`` exactly
        as for ``HeterogeneousRunner`` (results wait via
        ``block_until_ready`` leaves).  ``chunks_per_group`` bounds how
        finely each group's share is sliced; ``inflight`` is the per-group
        dispatch depth (2 = double buffering).  ``row_quantum`` coarsens
        chunk-size rounding to multiples of ``quantum * n_devices`` rows:
        a step pays per distinct chunk shape (allocator growth, a kernel
        launch point resolved per shape), so a coarser quantum keeps the
        shape set small while shares drift.
        Controller-driven steps additionally serve their row/chunk plan
        from a debounced cache (see ``_planned_rows``) so timing noise
        never churns the chunk-shape set.

        ``clock`` (anything with ``now()``, e.g. a shared
        ``runtime.simulate.VirtualClock``) replaces the wall clock for
        deterministic simulated trajectories.  ``dispatch_timeout_s``
        bounds the drain wait per group and step: a group that exceeds
        it is demoted exactly like one whose dispatch raised.

        ``observer`` (a ``repro_torch.obs.Observer``, default off) records
        dispatch/drain spans per group lane, plan-cache hit/miss
        counters, a step-latency histogram, and the semantic decision
        journal (rebalance adopted/debounced, demotion, re-dispatch).
        Share the observer's clock with ``clock`` for deterministic
        traces.  Every instrumentation block is guarded on the resolved
        observer, so a disabled/absent one costs nothing per step."""
        if not groups:
            raise ValueError("need at least one device group")
        if chunks_per_group < 1 or inflight < 1 or row_quantum < 1:
            raise ValueError("chunks_per_group, inflight and row_quantum "
                             "must be >= 1")
        self.groups = list(groups)
        self.controller = controller or EwmaController(len(self.groups))
        if self.controller.n_groups != len(self.groups):
            raise ValueError("controller group count mismatch")
        self.chunks_per_group = chunks_per_group
        self.inflight = inflight
        self.row_quantum = row_quantum
        self.clock = clock
        self.dispatch_timeout_s = dispatch_timeout_s
        self._fns = [step_builder(g) for g in self.groups]
        self._plans: dict[tuple, dict] = {}  # (rows, membership) -> plan
        self.history: list[dict] = []
        self._obs = as_observer(observer)
        if self._obs is not None:
            if self.controller.observer is None:
                self.controller.observer = self._obs
            m = self._obs.metrics
            self._m_plan_hit = m.counter("scheduler.plan_cache_hits")
            self._m_plan_miss = m.counter("scheduler.plan_cache_misses")
            self._m_steps = m.counter("scheduler.steps")
            self._m_rows = m.counter("scheduler.rows_completed")
            self._m_redispatch = m.counter("scheduler.redispatched_rows")
            self._h_step = m.histogram("scheduler.t_step_s")
            # stable lanes: one per group (index, not OS thread id) plus
            # a step lane — traces compare across runs and machines
            for gi, g in enumerate(self.groups):
                self._obs.tracer.thread_name(gi, f"group:{g.name}")
            self._obs.tracer.thread_name(len(self.groups), "scheduler")

    @property
    def shares(self) -> np.ndarray:
        return self.controller.shares

    @property
    def live(self) -> np.ndarray:
        return self.controller.live

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.perf_counter()

    # -- elastic membership ------------------------------------------------
    def drop_group(self, i: int, reason: str = "manual") -> None:
        """Remove group ``i`` from dispatch: its share goes to 0, the
        survivors re-normalize, and the next step plans (under a new
        membership key — never a stale pre-drop plan) without it.
        ``reason`` lands in the decision journal (``group_demoted``)."""
        was_live = bool(self.controller.live[i])
        self.controller.drop(i)
        if self._obs is not None and was_live:
            self._obs.journal.event(
                "group_demoted", group=self.groups[i].name, index=i,
                reason=reason, n_live=self.controller.n_live)
            self._obs.tracer.instant("demote", tid=i,
                                     args={"reason": reason})

    def restore_group(self, i: int, share: float | None = None) -> None:
        """Re-admit group ``i``; the EWMA wins its share back from live
        measurements within a few steps."""
        was_live = bool(self.controller.live[i])
        self.controller.restore(i, share)
        if self._obs is not None and not was_live:
            self._obs.journal.event(
                "group_restored", group=self.groups[i].name, index=i,
                share=round(float(self.controller.shares[i]), 6),
                n_live=self.controller.n_live)
            self._obs.tracer.instant("restore", tid=i)

    def _live_key(self) -> int:
        return int(np.packbits(self.controller.live, bitorder="little")
                   .view(np.uint8)[0]) if self.controller.n_groups <= 8 \
            else hash(tuple(bool(x) for x in self.controller.live))

    # -- planning ----------------------------------------------------------
    def plan_rows(self, n: int) -> list[int]:
        """Per-group row counts for a batch of ``n`` rows.

        Dropped groups get exactly 0 rows.  Every live group gets at
        least one device-aligned sliver; all live groups except the
        largest-share one are rounded to multiples of their device
        count, and the largest-share group absorbs the remainder
        (exactly aligned whenever ``n`` divides by the total live device
        count and groups are equally sized, as in the tests/benchmarks).
        """
        live = self.controller.live
        align = [len(g.devices) for g in self.groups]
        live_align = sum(a for a, l in zip(align, live) if l)
        if n < live_align:
            raise ValueError(f"batch of {n} rows is smaller than one row "
                             f"per live device ({live_align})")
        shares = self.controller.shares
        big = int(np.argmax(shares))          # dead shares are 0: big is live
        rows = [0] * len(self.groups)
        for i, (g, s) in enumerate(zip(align, shares)):
            if i == big or not live[i]:
                continue
            q = g * self.row_quantum            # shape-stable rounding
            rows[i] = max(int(round(n * s / q)) * q, g)
        rest = n - sum(rows)
        while rest < align[big]:
            # reclaim alignment units from the largest other group so the
            # largest-share group is never starved (n >= live aligns
            # guarantees termination: with every other live group at its
            # minimum, rest >= align[big])
            cands = [i for i in range(len(rows))
                     if i != big and rows[i] > align[i]]
            j = max(cands, key=lambda i: rows[i])
            rows[j] -= align[j]
            rest += align[j]
        rows[big] = rest
        return rows

    def _planned_rows(self, n: int, rebalance: bool) -> tuple[list[int], bool]:
        """(row plan for this step, whether a known size's plan changed).

        New chunk shapes are the costly part of chunked dispatch (the
        reference recompiles per shape; here the allocator grows and
        launch points resolve per shape): on near-equal groups the EWMA's
        response to timing noise would produce a new split almost every
        step — each new shape then poisons the next measurement,
        drifting the shares further.  Two regimes break it:

          * ``rebalance=False`` — the caller manages the shares (e.g. a
            split tuner sweeping fractions): the freshly computed plan is
            always honored, so measurements reflect the assigned split;
          * ``rebalance=True`` — controller-driven: the cached plan (and
            with it every chunk shape) is reused until the
            freshly computed plan **deviates from it on two consecutive
            steps**.  A single noisy measurement moves the shares once
            and the next clean measurement pulls them back, so one-step
            flicker never changes a shape; persistent movement (real skew,
            convergence) lands its new plan one step later.

        Plans are cached per **(batch size, group membership)** — a
        membership change (drop/restore) switches keys, so a post-drop
        batch of a known size can never reuse a stale plan that would
        dispatch rows to a dead group.  ``step`` skips the controller
        update on share-driven replan steps (their measured times
        include the first run of the new shapes and would re-poison the
        shares); a first-seen key does not suppress the update —
        freezing the shares on an all-new-sizes stream would be worse
        than one noisy measurement per size.
        """
        key = (n, self._live_key())
        fresh = self.plan_rows(n)
        plan = self._plans.get(key)
        if plan is not None:
            if fresh == plan["rows"]:
                plan["pending"] = None
                if self._obs is not None:
                    self._m_plan_hit.inc()
                return plan["rows"], False
            if rebalance and plan["pending"] is None:
                plan["pending"] = list(fresh)    # first deviation: debounce
                if self._obs is not None:
                    self._m_plan_hit.inc()
                    self._obs.journal.event(
                        "rebalance_debounced", batch=n,
                        kept=list(plan["rows"]), deviating=list(fresh))
                return plan["rows"], False
        if len(self._plans) >= 64 and key not in self._plans:
            self._plans.pop(next(iter(self._plans)))   # bound the cache
        self._plans[key] = {"rows": list(fresh), "pending": None,
                            "chunks": [self._chunk_sizes(r, len(g.devices))
                                       for r, g in zip(fresh, self.groups)]}
        if self._obs is not None:
            self._m_plan_miss.inc()
            if plan is not None:
                self._obs.journal.event(
                    "rebalance_adopted", batch=n,
                    old=list(plan["rows"]), new=list(fresh))
        # a replan of a known key is share-driven (possibly
        # new-shape-tainted measurement); a new key is just a new plan
        return self._plans[key]["rows"], plan is not None

    def _chunk_sizes(self, rows: int, align: int) -> list[int]:
        """Split one group's share into up to ``chunks_per_group`` aligned
        chunks (first chunk takes any residual); rounding uses the row
        quantum so chunk shapes stay stable as shares drift.  Zero rows
        (a dropped group) yield no chunks."""
        if rows <= 0:
            return []
        q = align * self.row_quantum
        per = rows // (self.chunks_per_group * q) * q
        if per == 0:
            per = rows // (self.chunks_per_group * align) * align
        if per == 0:
            return [rows]
        sizes = [per] * self.chunks_per_group
        sizes[0] += rows - per * self.chunks_per_group
        return [s for s in sizes if s > 0]

    _block = staticmethod(block_result)

    @property
    def _drain_pool(self) -> ThreadPoolExecutor:
        # lazy: schedulers built in tests/benches that never step should
        # not spawn threads (an unreferenced scheduler's idle workers
        # also exit on GC via the executor's weakref sentinel)
        pool = getattr(self, "_pool", None)
        if pool is None:
            pool = self._pool = ThreadPoolExecutor(
                max_workers=len(self.groups),
                thread_name_prefix="chunked-drain")
        return pool

    def close(self) -> None:
        """Release the drain worker threads of a long-lived scheduler."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._pool = None

    # -- redispatch after a failure ----------------------------------------
    def _redispatch_split(self, n: int, live_idx: list[int]) -> list[tuple[int, int]]:
        """(group index, rows) assignments for ``n`` orphaned rows across
        the live groups — shares-proportional, device-aligned, no
        min-sliver requirement (zero rows for a group is fine here).
        Falls back to the largest-share group when proportional rounding
        cannot stay aligned; raises if no live group's alignment divides
        the residue (equal-sized groups and ``row_quantum`` planning keep
        this from happening in practice)."""
        shares = self.controller.shares
        align = [len(self.groups[i].devices) for i in live_idx]
        order = sorted(range(len(live_idx)),
                       key=lambda k: -shares[live_idx[k]])
        big = order[0]
        rows = [0] * len(live_idx)
        rest = n
        for k in order[1:]:
            a = align[k]
            r = min(int(n * shares[live_idx[k]]) // a * a, rest)
            rows[k] = r
            rest -= r
        if rest % align[big] == 0:
            rows[big] = rest
        else:
            # push the misaligned residue onto any group that fits it
            for k in order:
                if rest % align[k] == 0:
                    rows[k] += rest
                    rest = 0
                    break
            else:
                raise RuntimeError(
                    f"cannot re-dispatch {rest} orphaned rows: no live "
                    f"group's device count divides them (aligns "
                    f"{align})")
        return [(live_idx[k], r) for k, r in enumerate(rows) if r > 0]

    # -- the online step ---------------------------------------------------
    def step(self, batch: dict, rebalance: bool = True) -> dict:
        """Dispatch one batch; returns the step record (and appends it to
        ``history``).

        A group whose dispatch raises (e.g. ``GroupFailure`` from fault
        injection or a real device error) or whose drain exceeds
        ``dispatch_timeout_s`` is demoted mid-step: its share drops to 0,
        survivors re-normalize, and all of its unconfirmed chunks are
        re-dispatched to the survivors — every row of the batch completes
        on a live group (at-least-once: a chunk whose result was in
        flight when the group died may have run twice).  Failure steps
        never feed the controller (their times are recovery-tainted).
        Raises ``RuntimeError`` if every group fails.
        """
        n = tree_leaves(batch)[0].shape[0]
        rows, plan_changed = self._planned_rows(n, rebalance)
        plan = self._plans[(n, self._live_key())]

        # contiguous per-group row ranges, then per-group chunk slices
        # (sizes come from the plan cache — no recompute per step);
        # each chunk carries its batch-row span so per-row completion
        # instants can be attributed back to the rows (and, one layer
        # up, to the requests) it served
        offsets = np.concatenate([[0], np.cumsum(rows)])
        chunks: list[list[dict]] = []
        chunk_rows: list[list[int]] = []
        chunk_spans: list[list[list[tuple[int, int]]]] = []
        for gi, g in enumerate(self.groups):
            sizes = plan["chunks"][gi]
            lo = int(offsets[gi])
            group_chunks = []
            group_spans = []
            for s in sizes:
                sl = tree_map(lambda x, lo=lo, s=s: x[lo:lo + s], batch)
                group_chunks.append(constrain_leading(sl))
                group_spans.append([(lo, s)])
                lo += s
            chunks.append(group_chunks)
            chunk_rows.append(list(sizes))
            chunk_spans.append(group_spans)

        t0 = self._now()
        n_groups = len(self.groups)
        pending: list[deque] = [deque() for _ in range(n_groups)]
        # per-group clocks start at the group's own first dispatch:
        # measuring every group from the common t0 would bill group k the
        # dispatch latency of groups 0..k-1, and the controller would
        # "rebalance" that constant bias into a real share drift on
        # equal-speed groups (new shapes) — group times must
        # estimate device speed, not dispatch order
        t_start = [None] * n_groups
        t_done = [0.0] * n_groups
        t_done_abs = [0.0] * n_groups
        chunk_times: list[list[float]] = [[] for _ in range(n_groups)]
        done_rows = [0] * n_groups        # rows confirmed complete
        done_chunks = [0] * n_groups      # planned chunks confirmed complete
        failures: dict[int, str] = {}
        # absolute completion instant per batch row (the serving layer
        # turns these into per-request latencies); rows of a failed
        # chunk stay NaN until their re-dispatch completes — drain
        # threads write disjoint slices, so no lock is needed
        row_done_at = np.full(n, np.nan)

        def record(gi: int, res, r: int, spans) -> None:
            # emulated results expose their exact completion instant;
            # real arrays are timestamped as their drain returns
            ready = result_ready_time(res)
            now = ready if ready is not None else self._now()
            if self._obs is not None:
                # one span per chunk on the group's lane, back-to-back
                # from the group's first dispatch (timestamps come from
                # the shared clock, so traces are deterministic even
                # though this runs on a drain thread)
                prev = chunk_times[gi][-1] if chunk_times[gi] else 0.0
                self._obs.tracer.complete(
                    "chunk", t_start[gi] + prev,
                    (now - t_start[gi]) - prev, tid=gi, args={"rows": r})
            chunk_times[gi].append(now - t_start[gi])
            t_done[gi] = now - t_start[gi]
            t_done_abs[gi] = max(t_done_abs[gi], now - t0)
            done_rows[gi] += r
            for start, cnt in spans:
                row_done_at[start:start + cnt] = now

        def fail(gi: int, err: BaseException | str) -> None:
            failures[gi] = err if isinstance(err, str) \
                else f"{type(err).__name__}: {err}"
            pending[gi].clear()           # unconfirmed results are orphaned
            if self._obs is not None:
                self._obs.tracer.instant("failure", tid=gi,
                                         args={"error": failures[gi]})

        def drain_one(gi: int) -> bool:
            res, r, planned, spans = pending[gi].popleft()
            try:
                self._block(res)
            except Exception as e:  # noqa: BLE001 — demotion boundary
                fail(gi, e)
                return False
            record(gi, res, r, spans)
            if planned:
                done_chunks[gi] += 1
            return True

        def dispatch(gi: int, chunk, r: int, planned: bool, spans) -> bool:
            if t_start[gi] is None:
                t_start[gi] = self._now()
            if self._obs is not None:
                self._obs.tracer.instant("dispatch", tid=gi,
                                         args={"rows": r})
            try:
                res = self._fns[gi](chunk)
            except Exception as e:  # noqa: BLE001 — demotion boundary
                fail(gi, e)
                return False
            pending[gi].append((res, r, planned, spans))
            return True

        # interleave dispatch round-robin by chunk index so every group
        # starts working immediately; bound the per-group queue depth
        max_chunks = max((len(c) for c in chunks), default=0)
        for ci in range(max_chunks):
            for gi in range(n_groups):
                if gi in failures or ci >= len(chunks[gi]):
                    continue
                if len(pending[gi]) >= self.inflight and not drain_one(gi):
                    continue
                dispatch(gi, chunks[gi][ci], chunk_rows[gi][ci], True,
                         chunk_spans[gi][ci])

        # drain each group in its own worker thread: waiting on a CUDA
        # event or a future releases the GIL, so every group's completion is timestamped
        # exactly when it happens (a later-indexed fast group is never
        # measured at a slower group's completion), with zero host-side
        # polling — the old is_ready/sleep loop cost ~ms per step in
        # redundant host syncs
        def drain_group(gi: int) -> None:
            while pending[gi]:
                if not drain_one(gi):
                    return

        futures = {gi: self._drain_pool.submit(drain_group, gi)
                   for gi in range(n_groups)
                   if pending[gi] and gi not in failures}
        for gi, f in futures.items():
            try:
                f.result(timeout=self.dispatch_timeout_s)
            except FutureTimeoutError:
                fail(gi, f"drain timed out after {self.dispatch_timeout_s}s")
                # the worker is still blocked on the dead dispatch — the
                # pool cannot be reused safely, so a fresh one is built
                # lazily on the next step
                pool = getattr(self, "_pool", None)
                if pool is not None:
                    pool.shutdown(wait=False)
                    self._pool = None

        # -- demote failed groups and re-dispatch their orphans ------------
        redispatched = 0
        if failures:
            orphans: list[tuple] = []       # (chunk, rows, spans) triples
            for gi in failures:
                if self.controller.live[gi]:
                    if self.controller.n_live == 1:
                        raise RuntimeError(
                            f"all device groups failed: {failures}")
                    self.drop_group(gi, reason=failures[gi])
                orphans.extend(zip(chunks[gi][done_chunks[gi]:],
                                   chunk_rows[gi][done_chunks[gi]:],
                                   chunk_spans[gi][done_chunks[gi]:]))
            attempts = 0
            while orphans:
                attempts += 1
                if attempts > n_groups:
                    raise RuntimeError(
                        f"re-dispatch kept failing: {failures}")
                merged = tree_map(_concat_rows, *[c for c, _, _ in orphans])
                merged_spans = [sp for _, _, spans in orphans for sp in spans]
                n_orphan = sum(r for _, r, _ in orphans)
                orphans = []
                live_idx = [i for i in range(n_groups)
                            if self.controller.live[i]]
                lo = 0
                retry: list[tuple[int, dict, int, list]] = []
                for gi, r in self._redispatch_split(n_orphan, live_idx):
                    sl = tree_map(lambda x, lo=lo, r=r: x[lo:lo + r],
                                  merged)
                    retry.append((gi, constrain_leading(sl), r,
                                  _slice_spans(merged_spans, lo, r)))
                    lo += r
                for gi, chunk, r, spans in retry:
                    if gi in failures and not self.controller.live[gi]:
                        orphans.append((chunk, r, spans))
                        continue
                    if not dispatch(gi, chunk, r, False, spans):
                        self._demote_if_live(gi, failures)
                        orphans.append((chunk, r, spans))
                        continue
                    if not drain_one(gi):
                        self._demote_if_live(gi, failures)
                        orphans.append((chunk, r, spans))
            # rows that completed via re-dispatch rather than the plan
            redispatched = sum(done_rows) - sum(
                sum(chunk_rows[gi][:done_chunks[gi]])
                for gi in range(n_groups))

        times = [max(t, 1e-9) for t in t_done]
        rec = {
            "shares": self.controller.shares.copy(),
            "live": [bool(x) for x in self.controller.live],
            "rows": list(rows),
            "rows_completed": list(done_rows),
            "n_chunks": [len(c) for c in chunks],
            "t_group": times,
            "t_chunks": chunk_times,
            # makespan on the common clock (dispatch latency included);
            # t_group above are per-group durations from each group's
            # own first dispatch (what the controller consumes)
            "t_step": max(max(t, 1e-9) for t in t_done_abs),
            "plan_changed": plan_changed,
            "failures": {self.groups[gi].name: msg
                         for gi, msg in failures.items()},
            "redispatched_rows": int(redispatched),
            # absolute completion instant of every batch row on the
            # step's clock (NaN only for rows the step could not
            # complete, which raises above) — a request-level serving
            # layer retires per-request latencies from it
            "row_done_at": row_done_at,
        }
        self.history.append(rec)
        if self._obs is not None:
            self._m_steps.inc()
            self._m_rows.inc(int(sum(done_rows)))
            self._h_step.observe(rec["t_step"])
            self._obs.tracer.complete(
                "scheduler.step", t0, rec["t_step"],
                tid=n_groups, args={"rows": n, "plan_changed": plan_changed,
                                    "failures": len(failures)})
            if redispatched:
                self._m_redispatch.inc(int(redispatched))
                self._obs.journal.event(
                    "chunks_redispatched", rows=int(redispatched),
                    from_groups=sorted(rec["failures"]),
                    to_groups=[g.name for g, l in
                               zip(self.groups, self.controller.live) if l])
        if rebalance and not plan_changed and not failures:
            # a plan-change step's times include the first run of the new
            # chunk shapes, and a failure step's include recovery re-dispatch —
            # feeding either to the controller would re-poison the shares
            # the moment the stream stabilizes
            self.controller.update(times, rows=rows)
        return rec

    def _demote_if_live(self, gi: int, failures: dict) -> None:
        if self.controller.live[gi]:
            if self.controller.n_live == 1:
                raise RuntimeError(f"all device groups failed: {failures}")
            self.drop_group(gi, reason=failures.get(gi, "redispatch failure"))

    def run(self, batches, rebalance: bool = True) -> list[dict]:
        """Drive a stream of batches; returns the step records."""
        return [self.step(b, rebalance=rebalance) for b in batches]
