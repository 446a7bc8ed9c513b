"""Continuous batching: coalesce admitted requests into scheduler batches.

The scheduler's unit of work is a batch of rows with one step function
per shape; the serving layer's unit of work is a request.  The
batcher closes the gap with *continuous batching*: instead of a fixed
cohort that runs to completion before the next forms, every scheduler
step re-forms its batch from whatever is queued *right now* — new
requests join mid-stream (next step), finished requests retire
individually, and a step never waits for stragglers of a previous
cohort.

Formation policy (``form``):

  * the queue is priority-ordered ((-priority, admit time, rid) — FIFO
    within a class, interactive ahead of best-effort);
  * the head request pins the batch **shape**; same-shape requests are
    taken in queue order up to ``max_batch_rows`` (a different shape
    would be a different step, so it waits for a later batch);
  * **coalesce window**: when the batch is not full and another arrival
    is due within ``coalesce_window_s`` of the head's admission,
    formation holds until then — trading a bounded head-of-line delay
    for larger (more device-efficient) batches.  ``coalesce_window_s=0``
    dispatches eagerly;
  * the formed batch is padded up to a multiple of ``align`` (the
    scheduler's live row quantum, Σ live device counts × row_quantum)
    with throwaway rows appended *after* the request rows — each
    request occupies one contiguous row span, so its completion instant
    is the max of the scheduler's per-row ``row_done_at`` over that
    span.

The three knobs (``max_batch_rows``, ``coalesce_window_s``,
``queue_depth_rows``) trade latency against throughput in a
workload-dependent way — exactly the shape of problem the paper's
tuning methodology solves, so :func:`tune_batcher` exposes them as a
``ConfigSpace`` (210 configs) driven through ``TuningSession`` against
a latency-percentile objective, with results persisted in the
``TuningStore`` (a repeat workload re-serves the tuned config with zero
new measurements).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

from ..core.space import ConfigSpace, Param
from ..tune.session import TuningSession
from .request import Request

__all__ = ["BatcherConfig", "ContinuousBatcher", "FormedBatch",
           "batcher_space", "tune_batcher"]


def batcher_space() -> ConfigSpace:
    """The batcher's tuning space (7 x 5 x 6 = 210 configs).

    ``max_batch_rows`` spans device-starved to throughput-saturated;
    ``coalesce_window_ms`` spans eager dispatch to aggressive
    coalescing; ``queue_depth_rows`` is the admission backpressure bound
    (it shapes the latency/goodput trade under overload).  A ``sam``
    tuning run with ~10 measurements is 4.8% of the space — inside the
    paper's ~5% envelope.
    """
    return ConfigSpace([
        Param("max_batch_rows", (16, 24, 32, 48, 64, 96, 128)),
        Param("coalesce_window_ms", (0, 2, 5, 10, 20)),
        Param("queue_depth_rows", (64, 128, 192, 256, 384, 512)),
    ])


@dataclass(frozen=True)
class BatcherConfig:
    """One point of the batcher space (seconds, not the space's ms)."""

    max_batch_rows: int = 64
    coalesce_window_s: float = 0.002
    queue_depth_rows: int = 256

    def __post_init__(self):
        if self.max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        if self.coalesce_window_s < 0:
            raise ValueError("coalesce_window_s must be >= 0")
        if self.queue_depth_rows < 1:
            raise ValueError("queue_depth_rows must be >= 1")

    @classmethod
    def from_config(cls, cfg: dict) -> "BatcherConfig":
        """From a tuning-space config dict (``coalesce_window_ms``)."""
        return cls(max_batch_rows=int(cfg["max_batch_rows"]),
                   coalesce_window_s=float(cfg["coalesce_window_ms"]) / 1e3,
                   queue_depth_rows=int(cfg["queue_depth_rows"]))


@dataclass(frozen=True)
class FormedBatch:
    """One scheduler batch worth of requests: ``requests`` in row
    order (request i occupies rows ``[spans[i], spans[i] + rows_i)``),
    padded to ``padded_rows`` total."""

    requests: tuple[Request, ...]
    shape: tuple[int, int]
    rows: int           # request rows (sum over requests)
    padded_rows: int    # rows after alignment padding

    @property
    def spans(self) -> list[tuple[int, int]]:
        """Per-request ``(lo, rows)`` row spans within the batch."""
        out, lo = [], 0
        for r in self.requests:
            out.append((lo, r.rows))
            lo += r.rows
        return out


class ContinuousBatcher:
    """Priority queue + batch formation under one :class:`BatcherConfig`.

    ``push`` admits requests into the queue; ``form`` either returns a
    :class:`FormedBatch` (requests transitioned to ``batched``), a
    ``float`` hold-until instant (coalesce window active — call again
    at/after it), or ``None`` (queue empty).
    """

    def __init__(self, config: BatcherConfig | None = None):
        self.config = config or BatcherConfig()
        self.queue: list[Request] = []

    def push(self, req: Request) -> None:
        self.queue.append(req)
        # stable priority order; t_admit tie-breaks FIFO within a class,
        # rid makes the order total (deterministic across runs)
        self.queue.sort(key=lambda r: (-r.priority, r.t_admit, r.rid))

    @property
    def queued_rows(self) -> int:
        return sum(r.rows for r in self.queue)

    def remove(self, reqs: Sequence[Request]) -> None:
        gone = {r.rid for r in reqs}
        self.queue = [r for r in self.queue if r.rid not in gone]

    def form(self, now: float, *, next_arrival: float | None = None,
             align: int = 1, flush: bool = False,
             ) -> "FormedBatch | float | None":
        """Form the next batch from the queue head (see class doc).

        ``next_arrival`` is the source's next arrival instant (for the
        coalesce hold); ``flush=True`` disables the hold (drain mode —
        the source is exhausted, nothing more is coming).
        """
        if not self.queue:
            return None
        head = self.queue[0]
        take: list[Request] = []
        rows = 0
        for req in self.queue:
            if req.shape != head.shape:
                continue                     # a different step shape
            if rows + req.rows > self.config.max_batch_rows:
                break
            take.append(req)
            rows += req.rows
        if not take:
            # head alone exceeds max_batch_rows: take it anyway (it
            # could never dispatch otherwise) — the scheduler handles
            # oversized batches fine, the cap is a latency knob
            take, rows = [head], head.rows
        # coalesce: hold a non-full batch while another arrival is due
        # within the window of the head's admission
        if not flush and rows < self.config.max_batch_rows \
                and self.config.coalesce_window_s > 0 \
                and next_arrival is not None:
            hold_until = head.t_admit + self.config.coalesce_window_s
            if now < hold_until and next_arrival <= hold_until:
                return hold_until
        align = max(int(align), 1)
        padded = -(-rows // align) * align
        self.remove(take)
        for r in take:
            r.batched()
        return FormedBatch(requests=tuple(take), shape=head.shape,
                           rows=rows, padded_rows=padded)


def tune_batcher(evaluate: Callable[[BatcherConfig], dict], *,
                 store=None, workload: dict | None = None,
                 strategy: str = "sam", iterations: int = 9,
                 seed: int = 0, observer=None):
    """Tune the batcher knobs through the paper's tuning machinery.

    ``evaluate(BatcherConfig) -> metrics`` must return a dict with a
    ``"time"`` entry (the objective — the serving drills use admitted
    p95 end-to-end latency with a goodput-weighted penalty for sheds).
    Results persist in ``store`` keyed by ``workload``; a repeat call
    with the same workload re-serves the stored winner with zero new
    measurements (``TuneResult.from_cache``).

    Returns ``(BatcherConfig, TuneResult)``.  With the default ``sam``
    strategy and ``iterations=9``, n_experiments is ~10 of 210 configs
    (≈4.8% — the paper's ~5% envelope).
    """
    space = batcher_space()

    def _eval(cfg: dict) -> dict:
        return evaluate(BatcherConfig.from_config(cfg))

    session = TuningSession(space, evaluator=_eval, store=store,
                            workload={"task": "serve_batcher",
                                      **(workload or {})},
                            seed=seed, observer=observer)
    result = session.run(strategy, iterations=iterations)
    return BatcherConfig.from_config(result.best_config), result
