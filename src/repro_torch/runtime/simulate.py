"""Simulated serial device groups, simulated clocks and fault injection.

Wall-clock ratios between concurrently dispatched groups on one host
are noise (the groups share its cores), so schedulers are exercised
against this timing model: dispatch returns immediately (as a card
step's enqueue does), but a group's chunks execute serially — chunk k+1
starts when chunk k finishes — at ``per_row_s * work_multiplier /
n_devices`` seconds per row.  ``SimReadyAt`` has the completion surface
of the port's result handles (``block_until_ready`` + ``is_ready``) and
additionally exposes ``ready_at`` so schedulers timestamp completions
exactly.

Two clocks drive the model:

  * wall clock (the default) — ``block_until_ready`` really sleeps, so
    the sim occupies real time;
  * :class:`VirtualClock` — a deterministic simulated timeline:
    blocking *advances the clock number* instead of sleeping, so a
    whole convergence or failure trajectory runs in microseconds and is
    bit-identical across runs and machines (no ``time.sleep``-calibrated
    assertions anywhere — the de-flake contract of the test suite).

Fault injection rides the same layer: a :class:`FaultPlan` scripts
failures per scheduler step (kill group i at step s, slow it by f×,
raise one transient, recover at step r) and a :class:`FaultInjector`
applies the plan to any step builder — natively inside
``make_serial_sim_builder`` (exact slow factors) or wrapped around a
real-dispatch builder via :meth:`FaultInjector.wrap` — raising
``repro_torch.dist.fault.GroupFailure`` so every scenario exercises the
production demotion path of ``ChunkedScheduler``.

Process-level faults (``crash``/``torn``) raise
:class:`~repro_torch.runtime.checkpoint.SimulatedCrash` (or deliver a
real ``SIGKILL``); the write-ahead log and snapshots of
``runtime.checkpoint`` recover from them.  ``SimulatedCrash`` is
importable from here too.
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass

from ..core.hetero import DeviceGroup, tree_leaves
from ..dist.fault import GroupFailure
from .checkpoint import SimulatedCrash

__all__ = ["FakeDevice", "FaultEvent", "FaultInjector", "FaultPlan",
           "GroupFailure", "SimReadyAt", "SimulatedCrash", "VirtualClock",
           "make_serial_sim_builder", "parse_fault_plan", "sim_skew_groups"]


class VirtualClock:
    """Deterministic simulated timeline for schedulers and sims.

    ``now()`` returns the current simulated instant; ``advance_to``
    moves it forward monotonically (never backward — concurrent drain
    threads may race, and the max keeps the timeline consistent).
    Passing one clock to both ``make_serial_sim_builder`` and
    ``ChunkedScheduler`` replaces every wall-clock read and sleep in the
    dispatch loop, so trajectories are exact functions of the timing
    model — independent of CI load, thread scheduling, or host speed.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance_to(self, t: float) -> float:
        with self._lock:
            self._now = max(self._now, float(t))
            return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("cannot advance a clock backward")
        with self._lock:
            self._now += float(dt)
            return self._now


class SimReadyAt:
    """Result handle of an emulated dispatch: ready at an
    absolute instant — ``time.perf_counter()`` by default, or a
    :class:`VirtualClock` instant when ``clock`` is given (blocking then
    advances the clock instead of sleeping)."""

    def __init__(self, value, done_at: float, clock: VirtualClock | None = None):
        self.value = value
        self.ready_at = float(done_at)   # schedulers read exact completion
        self._clock = clock

    def is_ready(self) -> bool:
        now = self._clock.now() if self._clock is not None \
            else time.perf_counter()
        return now >= self.ready_at

    def block_until_ready(self):
        if self._clock is not None:
            self._clock.advance_to(self.ready_at)
        else:
            time.sleep(max(0.0, self.ready_at - time.perf_counter()))
        return self


class FakeDevice:
    """Placeholder device for sim-only DeviceGroups (never dispatched to)."""


def make_serial_sim_builder(per_row_s: float = 0.0005, *,
                            clock: VirtualClock | None = None,
                            injector: "FaultInjector | None" = None):
    """Step-builder factory emulating groups of serial devices (one
    queue tail per group; see module docstring for the timing model).

    ``clock`` switches the sim onto a deterministic virtual timeline.
    ``injector`` applies a :class:`FaultPlan` natively: killed groups
    raise :class:`GroupFailure` at dispatch, slow factors scale the
    per-row time exactly (no rounding to whole repeats).
    """
    tails: dict[int, float] = {}

    def now() -> float:
        return clock.now() if clock is not None else time.perf_counter()

    def builder(group: DeviceGroup):
        key = id(group)
        per = per_row_s * group.work_multiplier / len(group.devices)

        def fn(chunk):
            if injector is not None:
                injector.check(group)
            factor = injector.slow_factor(group) if injector is not None \
                else 1.0
            n = tree_leaves(chunk)[0].shape[0]
            start = max(now(), tails.get(key, 0.0))
            tails[key] = start + per * factor * n
            return SimReadyAt(None, tails[key], clock)

        return fn

    return builder


def sim_skew_groups(skew: int = 3, n_fast: int = 4, n_slow: int = 4,
                    fast_first: bool = True) -> list[DeviceGroup]:
    """A fast + slow group pair with a per-row speed skew; ``fast_first``
    flips the ordering (schedulers must not care)."""
    fast = DeviceGroup("fast", [FakeDevice()] * n_fast)
    slow = DeviceGroup("slow", [FakeDevice()] * n_slow, work_multiplier=skew)
    return [fast, slow] if fast_first else [slow, fast]


# -- fault injection ------------------------------------------------------------

# device-level kinds target a group; process-level kinds (crash, torn)
# take down the whole process — group is carried but ignored
_FAULT_KINDS = ("kill", "slow", "transient", "recover", "crash", "torn")
_PROCESS_KINDS = ("crash", "torn")


@dataclass(frozen=True)
class FaultEvent:
    """One scripted event: at scheduler step ``step``, do ``kind`` to
    group index ``group`` (``factor`` scales per-row time for slow;
    process-level kinds ignore ``group``)."""

    step: int
    kind: str
    group: int
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_FAULT_KINDS}")
        if self.step < 0:
            raise ValueError("fault step must be >= 0")
        if self.group < 0:
            raise ValueError("group index must be >= 0")
        if self.kind == "slow" and self.factor <= 0:
            raise ValueError("slow factor must be > 0")


class FaultPlan:
    """A deterministic failure script, built by chaining:

        plan = (FaultPlan()
                .slow(1, at=3, factor=4.0)   # group 1 drops to 1/4 speed
                .kill(0, at=6)               # group 0 dies mid-stream
                .recover(0, at=12))          # ... and comes back

    One plan drives one run: a :class:`FaultInjector` consumes it step
    by step (``tick`` before each scheduler step).  The same plan runs
    identically against the serial-device sim and real dispatch, so
    every failure scenario is a fast, seeded, deterministic test.
    """

    def __init__(self, events: "list[FaultEvent] | tuple[FaultEvent, ...]" = ()):
        self.events: list[FaultEvent] = sorted(events, key=lambda e: e.step)

    def _add(self, **kw) -> "FaultPlan":
        self.events.append(FaultEvent(**kw))
        self.events.sort(key=lambda e: e.step)
        return self

    def kill(self, group: int, *, at: int) -> "FaultPlan":
        """Group ``group``'s dispatches raise from step ``at`` on."""
        return self._add(step=at, kind="kill", group=group)

    def slow(self, group: int, *, at: int, factor: float) -> "FaultPlan":
        """Scale the group's per-row time by ``factor`` from step ``at``."""
        return self._add(step=at, kind="slow", group=group, factor=factor)

    def transient(self, group: int, *, at: int) -> "FaultPlan":
        """Raise exactly one ``GroupFailure`` at step ``at`` (the group
        is healthy again afterwards, but the scheduler will have demoted
        it — pair with :meth:`recover` to bring it back)."""
        return self._add(step=at, kind="transient", group=group)

    def recover(self, group: int, *, at: int) -> "FaultPlan":
        """Clear kill/slow state at step ``at`` and (when the injector
        is attached to a scheduler) restore the group's membership."""
        return self._add(step=at, kind="recover", group=group)

    def crash(self, *, at: int) -> "FaultPlan":
        """Process fault at step ``at``: the injector's ``crash_mode``
        decides how it dies — ``"raise"`` throws
        :class:`SimulatedCrash` out of the
        serving loop (the in-process drill), ``"sigkill"`` delivers a
        real ``SIGKILL`` to the process (the subprocess drill).  On a
        resumed run, :meth:`FaultInjector.fast_forward` suppresses
        already-fired crashes so the plan does not re-kill the
        recovery."""
        return self._add(step=at, kind="crash", group=0)

    def torn(self, *, at: int) -> "FaultPlan":
        """Torn-write process fault at step ``at``: flush a *partial*
        record to the attached WAL (:meth:`FaultInjector.attach_wal`),
        then die exactly like :meth:`crash` — the restart must detect
        and truncate the torn tail."""
        return self._add(step=at, kind="torn", group=0)

    def at(self, step: int) -> list[FaultEvent]:
        return [e for e in self.events if e.step == step]

    @property
    def last_step(self) -> int:
        return max((e.step for e in self.events), default=-1)


def parse_fault_plan(spec: str) -> FaultPlan:
    """Parse a CLI fault-plan spec into a :class:`FaultPlan`.

    Comma-separated events, each ``kind:group@step`` with an extra
    ``:factor`` for slow::

        kill:0@3,slow:1@9:4,transient:0@5,recover:0@12,crash:0@8

    kills group 0 at step 3, slows group 1 to 1/4 speed from step 9,
    raises one transient on group 0 at step 5, recovers group 0 at step
    12.  Process-level kinds (``crash``, ``torn``) carry a group index
    for spelling uniformity but ignore it.  This is the surface behind
    ``launch/serve.py --fault-plan`` (the fault drill) — the parsed
    plan is the same object the tests build by chaining, so a drill
    spec is exactly reproducible in code.
    """
    plan = FaultPlan()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            kind, rest = part.split(":", 1)
            factor = None
            if kind == "slow":
                rest, factor_s = rest.split(":", 1)
                factor = float(factor_s)
            group_s, step_s = rest.split("@", 1)
            group, step = int(group_s), int(step_s)
        except ValueError as exc:
            raise ValueError(
                f"bad fault-plan event {part!r}: expected kind:group@step "
                "(slow:group@step:factor), e.g. 'kill:0@3,slow:1@9:4'"
            ) from exc
        if kind == "kill":
            plan.kill(group, at=step)
        elif kind == "slow":
            plan.slow(group, at=step, factor=factor)
        elif kind == "transient":
            plan.transient(group, at=step)
        elif kind == "recover":
            plan.recover(group, at=step)
        elif kind == "crash":
            plan.crash(at=step)
        elif kind == "torn":
            plan.torn(at=step)
        else:
            raise ValueError(f"unknown fault kind {kind!r} in {part!r}; "
                             f"expected one of {_FAULT_KINDS}")
    return plan


class FaultInjector:
    """Applies a :class:`FaultPlan` to step builders, one scheduler step
    at a time.

    The harness calls :meth:`tick` *before* each scheduler step; the
    events scripted for that step take effect (kills and slow factors
    persist until a recover event).  Dispatch-side state is consulted by
    the builders — natively by ``make_serial_sim_builder(injector=...)``
    or through :meth:`wrap` for any real builder.  ``attach`` a
    scheduler (or guard) so recover events call ``restore_group`` —
    demotion needs no attachment: the raised ``GroupFailure`` triggers
    it inside ``ChunkedScheduler.step``.

    Process-level events (``crash``/``torn``) fire inside :meth:`tick`
    — before the step's dispatch, outside the engine's failure
    handling, so they take the whole process down rather than demoting
    a group.  ``crash_mode="raise"`` throws ``SimulatedCrash`` (the
    in-process drill: the caller's ``except`` is the "restart");
    ``crash_mode="sigkill"`` delivers a real ``SIGKILL`` (the
    subprocess drill: nothing downstream of the kernel runs).  A
    ``torn`` event additionally flushes a partial record to the WAL
    attached via :meth:`attach_wal` first.  On resume,
    :meth:`fast_forward` replays the pre-crash steps' persistent
    effects (kills, slows) and marks fired process faults as spent.
    """

    def __init__(self, plan: FaultPlan, groups: "list[DeviceGroup]", *,
                 crash_mode: str = "raise"):
        for ev in plan.events:
            if ev.kind not in _PROCESS_KINDS and ev.group >= len(groups):
                raise ValueError(f"fault event {ev} references group "
                                 f"{ev.group}, but only {len(groups)} "
                                 "groups exist")
        if crash_mode not in ("raise", "sigkill"):
            raise ValueError("crash_mode must be 'raise' or 'sigkill'")
        self.plan = plan
        self.groups = list(groups)
        self.crash_mode = crash_mode
        self.step = -1                       # tick() moves to step 0
        self._dead: set[int] = set()
        self._slow: dict[int, float] = {}
        self._transient: set[int] = set()
        self._spent_crashes: set[int] = set()   # steps whose crash fired
        self._target = None
        self._wal = None

    def attach(self, target) -> "FaultInjector":
        """``target`` must expose ``restore_group(i)`` (a
        ``ChunkedScheduler`` or ``ServeGuard``); recover events call it."""
        self._target = target
        return self

    def attach_wal(self, wal) -> "FaultInjector":
        """``wal`` must expose ``append_torn(kind, **fields)`` (a
        ``runtime.checkpoint.WalWriter``); ``torn`` events flush a
        partial record through it before dying."""
        self._wal = wal
        return self

    def fast_forward(self, n_steps: int) -> "FaultInjector":
        """Resume support: re-apply steps ``0..n_steps-1`` — persistent
        device faults (kill/slow/recover) re-establish their state,
        one-shot transients are consumed silently, and process faults
        are marked spent so the crash that ended the previous run does
        not re-fire when the resumed run passes its step."""
        for _ in range(n_steps):
            self.step += 1
            for ev in self.plan.at(self.step):
                if ev.kind == "kill":
                    self._dead.add(ev.group)
                elif ev.kind == "slow":
                    if ev.factor == 1.0:
                        self._slow.pop(ev.group, None)
                    else:
                        self._slow[ev.group] = ev.factor
                elif ev.kind == "recover":
                    self._dead.discard(ev.group)
                    self._slow.pop(ev.group, None)
                elif ev.kind in _PROCESS_KINDS:
                    self._spent_crashes.add(ev.step)
        return self

    def _die(self, ev: FaultEvent) -> None:
        self._spent_crashes.add(ev.step)
        if self.crash_mode == "sigkill":
            import os
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        raise SimulatedCrash(
            f"injected {ev.kind} fault at step {ev.step}")

    def tick(self) -> list[FaultEvent]:
        """Advance to the next scheduler step; apply its events."""
        self.step += 1
        fired = self.plan.at(self.step)
        for ev in fired:
            if ev.kind == "kill":
                self._dead.add(ev.group)
            elif ev.kind == "slow":
                if ev.factor == 1.0:
                    self._slow.pop(ev.group, None)
                else:
                    self._slow[ev.group] = ev.factor
            elif ev.kind == "transient":
                self._transient.add(ev.group)
            elif ev.kind == "recover":
                self._dead.discard(ev.group)
                self._slow.pop(ev.group, None)
                self._transient.discard(ev.group)
                if self._target is not None:
                    self._target.restore_group(ev.group)
            elif ev.kind in _PROCESS_KINDS \
                    and ev.step not in self._spent_crashes:
                if ev.kind == "torn" and self._wal is not None:
                    self._wal.append_torn("admit", torn=True)
                self._die(ev)
        return fired

    # -- dispatch-side state -----------------------------------------------
    def index_of(self, group: DeviceGroup) -> int:
        for i, g in enumerate(self.groups):
            if g is group:
                return i
        raise KeyError(f"group {group.name!r} is not under this injector")

    def check(self, group: DeviceGroup) -> None:
        """Raise ``GroupFailure`` if the group is scripted to fail now."""
        gi = self.index_of(group)
        if gi in self._dead:
            raise GroupFailure(
                f"group {group.name!r} killed at step {self.step}")
        if gi in self._transient:
            self._transient.discard(gi)      # exactly once
            raise GroupFailure(
                f"transient failure on group {group.name!r} "
                f"at step {self.step}")

    def slow_factor(self, group: DeviceGroup) -> float:
        return self._slow.get(self.index_of(group), 1.0)

    def wrap(self, step_builder):
        """Wrap any step builder (same contract as the scheduler's):
        kills/transients raise before dispatch; slow factors re-dispatch
        the chunk ``ceil(factor) - 1`` extra times (the same devices
        serialize the repeats, so the group measures ~factor× slower —
        exact for integer factors, the sim path scales exactly)."""
        def wrapped_builder(group: DeviceGroup):
            fn = step_builder(group)

            def wrapped(chunk):
                self.check(group)
                result = fn(chunk)
                extra = math.ceil(self.slow_factor(group)) - 1
                if extra > 0:
                    result = (result,) + tuple(fn(chunk)
                                               for _ in range(extra))
                return result

            return wrapped

        return wrapped_builder
