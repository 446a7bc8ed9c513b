"""The serving run loop: source -> admission -> batcher -> scheduler.

``ServeEngine`` is the long-lived request-level loop above the chunked
scheduler.  One iteration:

  1. **ingest** — pull every arrival up to ``now`` from the source and
     run the admission policy on each: admitted requests enter the
     batcher's priority queue (journal ``request_admitted``), the rest
     are shed with a journaled reason (``request_shed``);
  2. **form** — ask the batcher for the next batch.  An empty queue
     advances the clock to the next arrival; a coalesce hold advances
     it to the hold horizon (new arrivals may join); a formed batch
     proceeds;
  3. **dispatch** — build the payload (``payload_fn(shape, rows)``),
     mark requests dispatched, tick the fault injector, and run one
     scheduler (or guard) step.  The scheduler advancing the clock
     while the step runs is what makes the batching *continuous*:
     requests arriving during the step are ingested at the top of the
     next iteration and join the very next batch;
  4. **retire** — on success, each request's completion instant is the
     max of the scheduler's per-row ``row_done_at`` over the request's
     contiguous row span (exact attribution, not step-end rounding);
     journal ``request_retired`` with the queue-delay/service
     decomposition.  On step failure (every live group failed — single
     -group failures are absorbed inside the scheduler by orphan
     re-dispatch), every in-flight request transitions to ``failed``
     and the admission layer decides retry (re-queue, journal
     ``request_retried``) or shed;
  5. **capacity watch** — if live membership shrank during the step,
     the service estimator rescales immediately (old/new capacity
     ratio) and the queue is re-evaluated: requests whose deadlines
     became infeasible are shed now instead of after burning a
     dispatch.

The loop ends when the source is exhausted and the queue is drained;
every admitted request is then terminal (completed or shed with a
reason) — the zero-lost-requests invariant the fault drill asserts.

**Crash durability** (``docs/resilience.md``): with ``wal=`` the engine
appends an ``admit`` record the moment a request is admitted (and again
on each retry re-queue, so the retry budget survives a restart) and a
``retire`` record at every terminal transition; a ``step`` record per
scheduler step pins the simulated clock and the fault plan's position.
``snapshot_path=`` adds periodic checksummed snapshots of the soft
state the WAL does not carry (controller shares + live mask, kill
switch, guard fallback, service estimator).  After a crash,
:meth:`ServeEngine.restore` replays the WAL: admitted-but-unretired
requests are rebuilt (``replayed`` marker set) and re-enter admission —
at-least-once execution, exactly-once terminal accounting (exactly one
valid ``retire`` per rid across both runs' WAL, which resumes in
place).

``make_sim_engine`` wires the whole stack onto the deterministic sim
rig (skewed fake device groups, ``VirtualClock``, optional
``FaultPlan``), shared by the bench, the CLI drill and the tests; with
``wal=``/``resume=True`` it is also the crash-recovery rig.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np

from ..obs import as_observer
from ..runtime.checkpoint import WalWriter, load_snapshot, save_snapshot
from ..runtime.guard import ServeGuard
from ..runtime.scheduler import ChunkedScheduler
from ..runtime.simulate import (FaultInjector, FaultPlan, VirtualClock,
                                make_serial_sim_builder, sim_skew_groups)
from .admission import AdmissionController, ServiceEstimator, SloPolicy
from .batcher import BatcherConfig, ContinuousBatcher, FormedBatch
from .request import Request, RequestSource

__all__ = ["ServeEngine", "make_sim_engine"]


def _zeros_payload(shape: tuple[int, int], rows: int) -> dict:
    """Default payload builder: the sim path only counts rows, so the
    feature dimension just needs to exist."""
    return {"x": np.zeros((rows, max(shape[0], 1)), np.float32)}


class ServeEngine:
    """Request-level serving loop (see module docstring)."""

    def __init__(self, target: "ServeGuard | ChunkedScheduler", *,
                 source: RequestSource,
                 admission: AdmissionController | None = None,
                 batcher: ContinuousBatcher | None = None,
                 payload_fn: Callable[[tuple[int, int], int], dict]
                 = _zeros_payload,
                 injector: FaultInjector | None = None,
                 observer=None, max_steps: int | None = None,
                 wal: WalWriter | None = None,
                 snapshot_path=None, snapshot_every: int = 8):
        """``target`` is a ``ServeGuard`` (degraded-mode aware path) or
        a bare ``ChunkedScheduler``.  ``observer`` defaults to the
        scheduler's (so request events share the run's journal
        sequence); ``max_steps`` is a safety valve — when hit, the
        remaining queue is shed as ``drained``.  ``wal`` (an open
        ``runtime.checkpoint.WalWriter``) makes every admission and
        retirement durable; ``snapshot_path`` + ``snapshot_every``
        checkpoint the soft state every N steps (see module
        docstring)."""
        if isinstance(target, ServeGuard):
            self.guard: ServeGuard | None = target
            self.scheduler = target.scheduler
        else:
            self.guard = None
            self.scheduler = target
        self.source = source
        self.admission = admission or AdmissionController()
        self.batcher = batcher or ContinuousBatcher()
        self.payload_fn = payload_fn
        self.injector = injector
        self.max_steps = max_steps
        self.wal = wal
        self.snapshot_path = snapshot_path
        self.snapshot_every = max(int(snapshot_every), 1)
        self.replayed = 0                  # requests re-queued on restore
        self.done: list[Request] = []      # terminal requests, any state
        self.steps = 0
        if wal is not None and self.injector is not None:
            self.injector.attach_wal(wal)
        self._obs = as_observer(observer) or self.scheduler._obs
        if self._obs is not None:
            m = self._obs.metrics
            self._h_queue = m.histogram("serve.queue_delay_s")
            self._h_service = m.histogram("serve.service_s")
            self._h_e2e = m.histogram("serve.e2e_s")

    # -- clock / capacity ---------------------------------------------------
    def _now(self) -> float:
        return self.scheduler._now()

    def _wait_until(self, t: float) -> None:
        clock = self.scheduler.clock
        if clock is not None and hasattr(clock, "advance_to"):
            clock.advance_to(t)
        else:
            time.sleep(max(t - self._now(), 0.0))

    def _degraded(self) -> bool:
        if self.guard is not None:
            return self.guard.degraded
        return not bool(self.scheduler.controller.live.all())

    def _capacity(self) -> float:
        """Relative serving capacity: device-rows per unit time, summed
        over live groups (the sim model's exact throughput; a faithful
        proxy for real groups)."""
        return sum(len(g.devices) / g.work_multiplier
                   for g, l in zip(self.scheduler.groups,
                                   self.scheduler.live) if l)

    def _align(self) -> int:
        live_align = sum(len(g.devices)
                         for g, l in zip(self.scheduler.groups,
                                         self.scheduler.live) if l)
        return max(live_align, 1) * self.scheduler.row_quantum

    # -- journal helpers ----------------------------------------------------
    def _j(self, kind: str, **fields) -> None:
        if self._obs is not None:
            self._obs.journal.event(kind, **fields)

    def _count(self, name: str) -> None:
        if self._obs is not None:
            self._obs.metrics.counter(name).inc()

    # -- lifecycle steps ----------------------------------------------------
    def _ingest(self, now: float) -> None:
        degraded = self._degraded()
        for req in self.source.take_until(now):
            reason = self.admission.admit(req, now, self.batcher.queued_rows,
                                          degraded=degraded)
            if reason is None:
                req.admit(now)
                self.batcher.push(req)
                if self.wal is not None:
                    self.wal.append("admit", **req.wal_fields(),
                                    replayed=req.replayed)
                self._count("serve.admitted")
                self._j("request_admitted", rid=req.rid, rows=req.rows,
                        shape=list(req.shape), klass=req.klass,
                        queued_rows=self.batcher.queued_rows)
            else:
                self._shed(req, now, reason)

    def _shed(self, req: Request, now: float, reason: str) -> None:
        req.shed(now, reason)
        self.done.append(req)
        if self.wal is not None:
            # shed-at-the-door requests get a retire record too: the WAL
            # then names every delivered rid, which is what fast-forwards
            # the arrival source exactly on restore
            self.wal.append("retire", rid=req.rid, status="shed",
                            reason=reason, t_done=req.t_done,
                            retries=req.retries)
        self._count(f"serve.shed.{reason}")
        self._j("request_shed", rid=req.rid, reason=reason, klass=req.klass,
                retries=req.retries)

    def _retire(self, fb: FormedBatch, rec: dict) -> None:
        done_at = rec.get("row_done_at")
        fallback = self._now()
        for (lo, rows), req in zip(fb.spans, fb.requests):
            span = None if done_at is None else done_at[lo:lo + rows]
            t_done = fallback if span is None or np.isnan(span).any() \
                else float(np.max(span))
            req.completed(t_done)
            self.done.append(req)
            if self.wal is not None:
                self.wal.append("retire", rid=req.rid, status="completed",
                                t_done=req.t_done, retries=req.retries)
            self._count("serve.completed")
            if self._obs is not None:
                self._h_queue.observe(req.queue_delay_s)
                self._h_service.observe(req.service_s)
                self._h_e2e.observe(req.latency_s)
            self._j("request_retired", rid=req.rid, klass=req.klass,
                    retries=req.retries, replayed=req.replayed,
                    queue_delay_s=round(req.queue_delay_s, 9),
                    service_s=round(req.service_s, 9),
                    e2e_s=round(req.latency_s, 9),
                    slo_ok=bool(req.slo_ok))

    def _handle_failure(self, fb: FormedBatch, error: str) -> None:
        now = self._now()
        for req in fb.requests:
            req.failed()
            reason = self.admission.retry_or_shed(
                req, now, self.batcher.queued_rows)
            if reason is None:
                req.retry(now)
                self.batcher.push(req)
                if self.wal is not None:
                    # a fresh admit record with the bumped retry count:
                    # the latest admit per rid wins at replay, so the
                    # retry budget is crash-durable (a request cannot
                    # earn extra retries by crashing the process)
                    self.wal.append("admit", **req.wal_fields(),
                                    replayed=req.replayed)
                self._count("serve.retried")
                self._j("request_retried", rid=req.rid, retries=req.retries,
                        error=error)
            else:
                self._shed(req, now, reason)

    def _after_step(self, cap_before: float) -> None:
        cap_after = self._capacity()
        if cap_after < cap_before and cap_after > 0:
            self.admission.estimator.rescale(cap_before / cap_after)
            now = self._now()
            for req, reason in self.admission.reevaluate(
                    self.batcher.queue, now, degraded=self._degraded()):
                self.batcher.remove([req])
                self._shed(req, now, reason)

    def _dispatch(self, fb: FormedBatch) -> None:
        now = self._now()
        payload = self.payload_fn(fb.shape, fb.padded_rows)
        for req in fb.requests:
            req.dispatched(now)
        if self.injector is not None:
            self.injector.tick()
        cap_before = self._capacity()
        try:
            rec = self.guard.step(payload) if self.guard is not None \
                else self.scheduler.step(payload)
        except RuntimeError as e:
            # every live group failed this step; single-group failures
            # never surface here (scheduler-internal re-dispatch)
            self._handle_failure(fb, str(e))
            self._after_step(cap_before)
            return
        self.admission.estimator.observe(rec["t_step"], fb.padded_rows)
        self._retire(fb, rec)
        self._after_step(cap_before)

    # -- durability ---------------------------------------------------------
    def save_state_snapshot(self) -> None:
        """Checksummed snapshot of the soft recoverable state — what the
        WAL's request records cannot reconstruct: controller shares +
        live mask, kill-switch baseline/trip state, the guard's learned
        fallback, and the service estimator (``docs/resilience.md``)."""
        state = {
            "now": round(self._now(), 9),
            "steps": self.steps,
            "controller": self.scheduler.controller.state_dict(),
            "estimator": self.admission.estimator.state_dict(),
            "guard": None if self.guard is None else self.guard.state_dict(),
        }
        save_snapshot(self.snapshot_path, state)
        self._j("snapshot_saved", step=self.steps,
                wal_lsn=None if self.wal is None else self.wal.lsn)

    def restore(self, records: list[dict], state: dict | None = None, *,
                torn: bool = False) -> dict:
        """Rebuild run state from a recovered WAL (+ optional snapshot).

        The WAL is the source of truth for *hard* state — which rids
        were delivered, which were retired, how far the clock and the
        fault plan got; the snapshot restores the *soft* state
        (controller/guard/estimator) when present and fresh.  Admitted-
        but-unretired requests are rebuilt from their latest ``admit``
        record (``replayed`` marker set, retry budget preserved) and
        re-enter admission at the recovered instant: the ones that still
        fit re-queue, the rest shed with a journaled reason — either
        way every pre-crash admission reaches exactly one valid
        ``retire`` record.  Returns a summary dict (also journaled as
        ``wal_recovered``).
        """
        admits: dict[int, dict] = {}
        retired: set[int] = set()
        delivered: set[int] = set()
        steps, now = 0, 0.0
        for rec in records:
            kind = rec.get("kind")
            if kind == "admit":
                admits[int(rec["rid"])] = rec          # latest wins
                delivered.add(int(rec["rid"]))
            elif kind == "retire":
                retired.add(int(rec["rid"]))
                delivered.add(int(rec["rid"]))
                now = max(now, float(rec.get("t_done") or 0.0))
            elif kind == "step":
                steps = max(steps, int(rec["step"]))
                now = max(now, float(rec["now"]))
        if state is not None:
            steps = max(steps, int(state.get("steps", 0)))
            now = max(now, float(state.get("now", 0.0)))
            self.scheduler.controller.load_state(state["controller"])
            self.admission.estimator.load_state(state["estimator"])
            if self.guard is not None and state.get("guard") is not None:
                self.guard.load_state(state["guard"])
        self.steps = steps
        clock = self.scheduler.clock
        if clock is not None and hasattr(clock, "advance_to"):
            clock.advance_to(now)
        if self.injector is not None:
            # re-apply the pre-crash fault timeline: persistent device
            # faults re-establish, fired process faults are spent.  The
            # +1 covers the tick that died mid-flight — its step record
            # was never written, but its events (including the crash)
            # all fired before the process went down.
            self.injector.fast_forward(steps + 1)
        # groups the snapshot remembers as dead re-run the scheduler's
        # demotion (plan-cache keying, journal) — straight on the
        # scheduler, not the guard, so the restored kill-switch baseline
        # is not reset by a membership "change" that is only a restore
        for i, live in enumerate(self.scheduler.controller.live):
            if not live:
                self.scheduler.controller.live[i] = True  # let drop re-run
                self.scheduler.drop_group(i, reason="wal-restore")
        n_requeued = n_shed = 0
        now = self._now()
        degraded = self._degraded()
        for rid in sorted(set(admits) - retired):
            req = Request.from_wal(admits[rid])
            self.replayed += 1
            reason = self.admission.admit(req, now,
                                          self.batcher.queued_rows,
                                          degraded=degraded)
            self._j("request_replayed", rid=req.rid, rows=req.rows,
                    retries=req.retries,
                    disposition="requeued" if reason is None else reason)
            if reason is None:
                req.admit(now)
                self.batcher.push(req)
                self._count("serve.replayed")
                n_requeued += 1
            else:
                self._shed(req, now, reason)
                n_shed += 1
        # the source delivers rids in order: everything the WAL names
        # was handed out before the crash
        fast_forward_to = max(delivered, default=-1) + 1
        self.source._next = max(self.source._next, fast_forward_to)
        out = {"wal_records": len(records), "admitted": len(admits),
               "retired": len(retired), "replayed": self.replayed,
               "requeued": n_requeued, "shed_on_replay": n_shed,
               "steps": self.steps, "now": round(now, 9),
               "torn": bool(torn)}
        self._j("wal_recovered", **out)
        return out

    # -- run ---------------------------------------------------------------
    def run(self) -> dict:
        """Serve the whole source to drained; returns :meth:`summary`."""
        while True:
            now = self._now()
            self._ingest(now)
            fb = self.batcher.form(now, next_arrival=self.source.next_time(),
                                   align=self._align(),
                                   flush=self.source.exhausted)
            if fb is None:
                nxt = self.source.next_time()
                if nxt is None:
                    break                    # drained: source + queue empty
                self._wait_until(nxt)
                continue
            if isinstance(fb, float):        # coalesce hold
                nxt = self.source.next_time()
                self._wait_until(min(fb, nxt) if nxt is not None else fb)
                continue
            self._dispatch(fb)
            self.steps += 1
            if self.wal is not None:
                # pins the clock and the fault plan's position, so a
                # restart resumes the exact simulated timeline even when
                # the last snapshot is several steps stale
                self.wal.append("step", step=self.steps,
                                now=round(self._now(), 9))
            if self.snapshot_path is not None \
                    and self.steps % self.snapshot_every == 0:
                self.save_state_snapshot()
            if self.max_steps is not None and self.steps >= self.max_steps:
                now = self._now()
                for req in list(self.batcher.queue):
                    self.batcher.remove([req])
                    self._shed(req, now, "drained")
                break
        if self.wal is not None:
            self.wal.sync()
        if self.snapshot_path is not None:
            self.save_state_snapshot()
        return self.summary()

    def summary(self) -> dict:
        """Exact (not bucket-estimated) end-to-end percentiles over the
        terminal requests, plus shed accounting and goodput."""
        completed = [r for r in self.done if r.status == "completed"]
        shed = [r for r in self.done if r.status == "shed"]
        out = {
            "requests": len(self.done),
            "completed": len(completed),
            "shed": len(shed),
            "shed_rate": len(shed) / max(len(self.done), 1),
            "shed_reasons": {},
            "retries": sum(r.retries for r in self.done),
            "replayed": self.replayed,
            "steps": self.steps,
            "slo_violations": sum(1 for r in completed if not r.slo_ok),
        }
        for r in shed:
            out["shed_reasons"][r.shed_reason] = \
                out["shed_reasons"].get(r.shed_reason, 0) + 1
        if completed:
            e2e = np.asarray([r.latency_s for r in completed])
            qd = np.asarray([r.queue_delay_s for r in completed])
            sv = np.asarray([r.service_s for r in completed])
            for q, tag in ((50, "p50"), (95, "p95"), (99, "p99")):
                out[f"e2e_{tag}"] = float(np.percentile(e2e, q))
                out[f"queue_delay_{tag}"] = float(np.percentile(qd, q))
                out[f"service_{tag}"] = float(np.percentile(sv, q))
            t0 = min(r.t_arrival for r in completed)
            t1 = max(r.t_done for r in completed)
            rows_done = sum(r.rows for r in completed)
            out["goodput_rows_per_s"] = rows_done / max(t1 - t0, 1e-9)
        return out


def make_sim_engine(*, n_requests: int = 200, rate_rps: float = 400.0,
                    seed: int = 0, per_row_s: float = 4e-4, skew: int = 3,
                    batcher_config: BatcherConfig | None = None,
                    policy: SloPolicy | None = None,
                    fault_plan: FaultPlan | None = None,
                    guard: bool = False, observer=None,
                    source: RequestSource | None = None,
                    row_quantum: int = 1,
                    max_steps: int | None = None,
                    wal=None, snapshot=None, snapshot_every: int = 8,
                    resume: bool = False, crash_mode: str = "raise",
                    wal_fsync_every: int = 1) -> ServeEngine:
    """The deterministic serving rig: skewed sim groups on a
    ``VirtualClock``, optionally fault-injected and guard-wrapped.

    Identical parameters + seed produce identical journals on any
    machine (the bench, CLI drill and tests all ride this).  Capacity
    of the default rig: 2 groups x 4 devices with skew 3 gives
    ``(4 + 4/3) / per_row_s`` rows/s ≈ 13.3k rows/s at the default
    ``per_row_s`` — pick ``rate_rps`` (x mean rows/request) relative to
    that for under/over-capacity regimes.

    ``wal`` (a path) makes the run crash-durable; ``snapshot`` (a path)
    adds the periodic soft-state checkpoint; ``resume=True`` recovers
    both before serving (torn WAL tails truncate, corrupt snapshots
    quarantine) and replays unretired requests — the crash-recovery
    drill is "same call, plus ``resume=True``".  ``crash_mode`` selects
    how scripted ``crash``/``torn`` faults die (``"raise"`` for the
    in-process drill, ``"sigkill"`` for the real-subprocess one).
    """
    clock = VirtualClock()
    groups = sim_skew_groups(skew)
    injector = FaultInjector(fault_plan, groups, crash_mode=crash_mode) \
        if fault_plan is not None else None
    builder = make_serial_sim_builder(per_row_s, clock=clock,
                                      injector=injector)
    obs = as_observer(observer)
    if obs is not None and obs.clock is None:
        # the rig owns the VirtualClock; rebind a wall-clock observer so
        # journal/trace timestamps ride the deterministic timeline
        obs.clock = clock
        obs.tracer.clock = clock
        obs.journal.clock = clock
    scheduler = ChunkedScheduler(builder, groups, clock=clock,
                                 row_quantum=row_quantum, observer=obs)
    target: ServeGuard | ChunkedScheduler = scheduler
    if guard:
        target = ServeGuard(scheduler)
    if injector is not None:
        injector.attach(target)
    if source is None:
        source = RequestSource(n_requests=n_requests, rate_rps=rate_rps,
                               seed=seed)
    estimator = ServiceEstimator(init_per_row_s=per_row_s)
    bc = batcher_config or BatcherConfig()
    if policy is None:
        # the batcher's tuned queue-depth knob IS the admission
        # backpressure bound — one knob, one policy
        policy = SloPolicy(max_queue_rows=bc.queue_depth_rows)
    admission = AdmissionController(policy, estimator=estimator)
    batcher = ContinuousBatcher(bc)
    wal_writer = WalWriter(wal, fsync_every=wal_fsync_every) \
        if wal is not None else None
    engine = ServeEngine(target, source=source, admission=admission,
                         batcher=batcher, injector=injector, observer=obs,
                         max_steps=max_steps, wal=wal_writer,
                         snapshot_path=snapshot,
                         snapshot_every=snapshot_every)
    if resume:
        if wal_writer is None:
            raise ValueError("resume=True needs a wal path to recover from")
        state = load_snapshot(snapshot) if snapshot is not None else None
        engine.restore(wal_writer.recovered, state,
                       torn=wal_writer.torn is not None)
    return engine
