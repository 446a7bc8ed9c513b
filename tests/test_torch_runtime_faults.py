"""Resilience guardrails under deterministic fault injection, held against
the reference.

Every scenario is scripted through ``runtime.simulate`` (``FaultPlan`` +
``FaultInjector``) on a ``VirtualClock`` and run through both
``repro.runtime`` and ``repro_torch.runtime``: membership, rows, shares
and step times must be equal.  The reference's sim-vs-real test runs its
real side on forced host devices in a subprocess; here the real side is
in-process CPU groups whose steps run on worker threads.
"""

import threading
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.hetero as ref_hetero
import repro.runtime as ref_runtime
import repro.runtime.simulate as ref_simulate
import repro_torch.core.hetero as port_hetero
import repro_torch.runtime as port_runtime
import repro_torch.runtime.simulate as port_simulate
from repro_torch.core.hetero import DeviceGroup
from repro_torch.runtime import (ChunkedScheduler, EwmaController, KillSwitch,
                                 fallback_from_store, sim_skew_groups)
from repro_torch.runtime.simulate import (FaultInjector, FaultPlan,
                                          GroupFailure)


def package(runtime, simulate, hetero):
    names = {n: getattr(runtime, n) for n in runtime.__all__}
    names.update({n: getattr(simulate, n) for n in simulate.__all__})
    return types.SimpleNamespace(**names, DeviceGroup=hetero.DeviceGroup)


REF = package(ref_runtime, ref_simulate, ref_hetero)
PORT = package(port_runtime, port_simulate, port_hetero)


def on_both(run):
    """``run(pkg)`` through both packages; the port's result after checking
    it equals the reference's."""
    want, got = run(REF), run(PORT)
    np.testing.assert_equal(got, want)
    return got


def make_sim(pkg=PORT, groups=None, *, plan=None, per_row_s=0.0005, skew=3,
             controller=None, **sched_kw):
    """Scheduler + injector on a fresh virtual clock (one line per test)."""
    clock = pkg.VirtualClock()
    groups = groups or pkg.sim_skew_groups(skew=skew)
    injector = pkg.FaultInjector(plan or pkg.FaultPlan(), groups)
    sched = pkg.ChunkedScheduler(
        pkg.make_serial_sim_builder(per_row_s, clock=clock,
                                    injector=injector),
        groups, clock=clock,
        controller=controller or pkg.EwmaController(len(groups),
                                                    min_share=0.02),
        **sched_kw)
    injector.attach(sched)
    return sched, injector, clock


def drive(sched, injector, batch, steps):
    recs = []
    for _ in range(steps):
        injector.tick()
        recs.append(sched.step(batch))
    return recs


def summary(recs):
    """What a trajectory is compared on across the packages."""
    return [(r["live"], r["rows"], r["rows_completed"], r["t_step"],
             sorted(r["failures"]), r["redispatched_rows"],
             r["shares"].tolist()) for r in recs]


def three_equal_groups(pkg=PORT):
    return [pkg.DeviceGroup(n, [pkg.FakeDevice()] * 4) for n in ("a", "b", "c")]


BATCH = {"x": np.zeros((64, 4), np.float32)}


# -- FaultPlan / FaultEvent / FaultInjector -------------------------------------

def test_fault_event_validation():
    for pkg in (REF, PORT):
        for kw in (dict(step=0, kind="explode", group=0),
                   dict(step=-1, kind="kill", group=0),
                   dict(step=0, kind="kill", group=-1),
                   dict(step=0, kind="slow", group=0, factor=0.0)):
            with pytest.raises(ValueError):
                pkg.FaultEvent(**kw)


def test_fault_plan_chaining_sorts_events():
    def run(pkg):
        plan = (pkg.FaultPlan().recover(0, at=9).kill(0, at=3)
                .slow(1, at=5, factor=2.0).transient(1, at=1))
        return ([e.step for e in plan.events], plan.last_step,
                [e.kind for e in plan.at(5)], plan.at(7))
    assert on_both(run) == ([1, 3, 5, 9], 9, ["slow"], [])


def test_injector_rejects_event_for_unknown_group():
    with pytest.raises(ValueError):
        FaultInjector(FaultPlan().kill(5, at=0), sim_skew_groups())


def test_injector_kill_persists_until_recover():
    groups = sim_skew_groups()
    inj = FaultInjector(FaultPlan().kill(0, at=1).recover(0, at=3), groups)
    inj.tick()
    inj.check(groups[0])
    inj.tick()
    with pytest.raises(GroupFailure):
        inj.check(groups[0])
    inj.check(groups[1])
    inj.tick()
    with pytest.raises(GroupFailure):
        inj.check(groups[0])
    inj.tick()
    inj.check(groups[0])


def test_injector_transient_raises_exactly_once():
    groups = sim_skew_groups()
    inj = FaultInjector(FaultPlan().transient(1, at=0), groups)
    inj.tick()
    with pytest.raises(GroupFailure):
        inj.check(groups[1])
    inj.check(groups[1])


def test_injector_slow_factor_scales_sim_times_exactly():
    def run(pkg):
        group = [pkg.DeviceGroup("solo", [pkg.FakeDevice()] * 4)]
        plan = pkg.FaultPlan().slow(0, at=1, factor=2.5).recover(0, at=2)
        sched, inj, _ = make_sim(pkg, group, plan=plan,
                                 controller=pkg.EwmaController(1))
        return [r["t_group"][0] for r in drive(sched, inj, BATCH, 3)]
    t0, t1, t2 = on_both(run)
    assert t1 == pytest.approx(2.5 * t0)
    assert t2 == pytest.approx(t0)


def test_injector_wrap_repeats_dispatch_for_slow():
    calls = []

    def builder(group):
        def fn(chunk):
            calls.append(group.name)
            return chunk
        return fn

    groups = sim_skew_groups()
    inj = FaultInjector(FaultPlan().slow(0, at=0, factor=3.0), groups)
    wrapped = inj.wrap(builder)(groups[0])
    inj.tick()
    out = wrapped({"x": torch.zeros(4)})
    assert len(calls) == 3 and len(out) == 3


def test_injector_wrap_raises_for_killed_group():
    groups = sim_skew_groups()
    inj = FaultInjector(FaultPlan().kill(1, at=0), groups)
    wrapped = inj.wrap(lambda g: lambda c: c)(groups[1])
    inj.tick()
    with pytest.raises(GroupFailure):
        wrapped({"x": torch.zeros(4)})


# -- EwmaController elastic membership ------------------------------------------

def test_drop_zeroes_share_and_renormalizes_survivors():
    def run(pkg):
        c = pkg.EwmaController(3, shares=np.array([0.5, 0.3, 0.2]),
                               min_share=0.02)
        c.drop(1)
        return c.shares.tolist(), c.live.tolist()
    shares, live = on_both(run)
    assert shares[1] == 0.0 and sum(shares) == pytest.approx(1.0)
    assert shares[0] / shares[2] == pytest.approx(2.5, rel=0.05)
    assert live == [True, False, True]


def test_drop_is_idempotent_and_protects_last_group():
    c = EwmaController(2)
    c.drop(0)
    before = c.shares.copy()
    c.drop(0)
    np.testing.assert_array_equal(c.shares, before)
    with pytest.raises(RuntimeError):
        c.drop(1)
    with pytest.raises(IndexError):
        c.drop(7)


def test_restore_readmits_and_is_idempotent():
    def run(pkg):
        c = pkg.EwmaController(2, min_share=0.02)
        c.drop(0)
        c.restore(0)
        first = (c.live.tolist(), c.shares.tolist())
        c.restore(0)
        return first, c.shares.tolist()
    (live, shares), again = on_both(run)
    assert live == [True, True] and shares[0] == pytest.approx(0.5)
    assert sum(shares) == pytest.approx(1.0) and again == shares


def test_update_ignores_dead_groups():
    def run(pkg):
        c = pkg.EwmaController(3, min_share=0.02, damping=1.0)
        c.drop(2)
        c.update([1.0, 2.0, 123.0])
        return c.shares.tolist()
    shares = on_both(run)
    assert shares[2] == 0.0 and sum(shares) == pytest.approx(1.0)
    assert shares[0] > shares[1]


# -- ChunkedScheduler: elastic membership + redispatch --------------------------

def test_kill_at_dispatch_loses_no_rows():
    def run(pkg):
        sched, inj, _ = make_sim(pkg, plan=pkg.FaultPlan().kill(0, at=2))
        return summary(drive(sched, inj, BATCH, 5))
    recs = on_both(run)
    assert all(sum(r[2]) == 64 for r in recs)
    live, rows, done, _, failures, redispatched, _ = recs[2]
    assert failures and redispatched > 0 and done[0] == 0
    for r in recs[3:]:
        assert r[0] == [False, True] and r[1][0] == 0


def test_kill_at_drain_redispatches_unconfirmed_chunks():
    def run(pkg):
        class PoisonedResult:
            def block_until_ready(self):
                raise pkg.GroupFailure("died while computing")

        armed = {"on": False}

        def builder(group):
            def fn(chunk):
                if group.name == "fast" and armed["on"]:
                    return PoisonedResult()
                return chunk["x"]
            return fn

        sched = pkg.ChunkedScheduler(
            builder, pkg.sim_skew_groups(),
            controller=pkg.EwmaController(2, min_share=0.02))
        first = sched.step(BATCH, rebalance=False)
        armed["on"] = True
        rec = sched.step(BATCH, rebalance=False)
        return (sorted(first["failures"]), sorted(rec["failures"]),
                rec["rows_completed"])
    first, failed, done = on_both(run)
    assert first == [] and failed == ["fast"]
    assert sum(done) == 64 and done[0] == 0


def test_plan_cache_is_keyed_by_membership():
    def run(pkg):
        sched, _, _ = make_sim(pkg)
        sched.step(BATCH)
        sched.drop_group(0)
        after_drop = sched.step(BATCH)
        sched.restore_group(0)
        after_restore = sched.step(BATCH)
        return (after_drop["rows"], after_drop["rows_completed"],
                after_restore["rows"])
    rows, done, restored = on_both(run)
    assert rows[0] == 0 and done == [0, 64] and restored[0] > 0


def test_transient_failure_demotes_until_recover():
    def run(pkg):
        plan = pkg.FaultPlan().transient(1, at=2).recover(1, at=5)
        sched, inj, _ = make_sim(pkg, plan=plan)
        return summary(drive(sched, inj, BATCH, 8))
    recs = on_both(run)
    assert recs[2][4] and recs[3][0] == [True, False]
    assert recs[5][0] == [True, True]
    assert all(sum(r[2]) == 64 for r in recs)


def test_kill_then_recover_converges_back_to_oracle():
    def run(pkg):
        plan = pkg.FaultPlan().kill(0, at=6).recover(0, at=10)
        sched, inj, _ = make_sim(pkg, plan=plan, per_row_s=0.0004)
        drive(sched, inj, {"x": np.zeros((128, 4), np.float32)}, 30)
        return sched.shares.tolist(), sched.live.tolist()
    shares, live = on_both(run)
    assert shares[0] == pytest.approx(0.75, abs=0.05)
    assert live == [True, True]


def test_all_groups_failing_raises():
    for pkg in (REF, PORT):
        sched, inj, _ = make_sim(
            pkg, plan=pkg.FaultPlan().kill(0, at=0).kill(1, at=0))
        inj.tick()
        with pytest.raises(RuntimeError, match="failed"):
            sched.step(BATCH)


def test_slow_fault_shifts_shares_away_from_straggler():
    def run(pkg):
        plan = pkg.FaultPlan().slow(0, at=5, factor=12.0)
        sched, inj, _ = make_sim(pkg, plan=plan, skew=1, per_row_s=0.0004)
        drive(sched, inj, {"x": np.zeros((128, 4), np.float32)}, 25)
        return sched.shares.tolist(), sched.live.tolist()
    shares, live = on_both(run)
    assert shares[0] < 0.2 and live == [True, True]


def test_combined_kill_and_slow_faults():
    def run(pkg):
        plan = pkg.FaultPlan().slow(1, at=3, factor=6.0).kill(2, at=5)
        sched, inj, _ = make_sim(pkg, three_equal_groups(pkg), plan=plan,
                                 per_row_s=0.0004)
        recs = drive(sched, inj, {"x": np.zeros((96, 4), np.float32)}, 20)
        return summary(recs), sched.shares.tolist()
    recs, shares = on_both(run)
    assert recs[-1][0] == [True, True, False]
    assert all(sum(r[2]) == 96 for r in recs)
    assert shares[0] > shares[1] > 0 and shares[2] == 0.0


def test_cascading_kills_leave_last_group_serving():
    def run(pkg):
        plan = pkg.FaultPlan().kill(0, at=2).kill(1, at=4)
        sched, inj, _ = make_sim(pkg, three_equal_groups(pkg), plan=plan)
        return summary(drive(sched, inj,
                             {"x": np.zeros((96, 4), np.float32)}, 7))
    recs = on_both(run)
    assert recs[-1][0] == [False, False, True]
    assert recs[-1][2] == [0, 0, 96]
    assert all(sum(r[2]) == 96 for r in recs)


def test_failure_step_skips_controller_update():
    def run(pkg):
        sched, inj, _ = make_sim(pkg, three_equal_groups(pkg),
                                 plan=pkg.FaultPlan().kill(2, at=3))
        batch = {"x": np.zeros((96, 4), np.float32)}
        drive(sched, inj, batch, 3)
        before = sched.shares[0] / sched.shares[1]
        inj.tick()
        sched.step(batch)
        return before, sched.shares[0] / sched.shares[1]
    before, after = on_both(run)
    assert after == pytest.approx(before)


def test_dispatch_timeout_demotes_hung_group():
    release = threading.Event()

    class HangingResult:
        def block_until_ready(self):
            release.wait()

    armed = {"on": False}

    def builder(group):
        def fn(chunk):
            if group.name == "fast" and armed["on"]:
                return HangingResult()
            return chunk["x"]
        return fn

    sched = ChunkedScheduler(builder, sim_skew_groups(),
                             controller=EwmaController(2, min_share=0.02),
                             dispatch_timeout_s=0.05)
    try:
        rec = sched.step({"x": torch.zeros(64, 4)}, rebalance=False)
        assert not rec["failures"]
        armed["on"] = True
        rec = sched.step({"x": torch.zeros(64, 4)}, rebalance=False)
        assert "fast" in rec["failures"]
        assert "timed out" in rec["failures"]["fast"]
        assert rec["rows_completed"] == [0, 64]
        assert list(sched.live) == [False, True]
    finally:
        release.set()
        sched.close()


def test_fault_trajectories_are_deterministic():
    def run(pkg):
        plan = (pkg.FaultPlan().slow(1, at=2, factor=4.0).kill(0, at=5)
                .recover(0, at=9).recover(1, at=9))
        sched, inj, clock = make_sim(pkg, plan=plan)
        return summary(drive(sched, inj, BATCH, 14)), clock.now()

    assert run(PORT) == run(PORT)
    on_both(run)


# -- KillSwitch state machine ---------------------------------------------------

def verdicts(pkg, times, **kw):
    ks = pkg.KillSwitch(**kw)
    return [ks.observe(t) for t in times], ks.state_dict()


def test_killswitch_warms_up_then_trips_after_patience():
    out, state = on_both(lambda pkg: verdicts(
        pkg, [1.0] * 4 + [2.0] * 3, threshold=1.5, patience=3,
        min_samples=4))
    assert out == ["ok"] * 4 + ["regressing", "regressing", "trip"]
    assert state["tripped"] and state["n_trips"] == 1


def test_killswitch_healthy_step_resets_streak():
    out, state = on_both(lambda pkg: verdicts(
        pkg, [1.0, 1.0, 2.0, 1.0, 2.0], threshold=1.5, patience=2,
        min_samples=2))
    assert out[2:] == ["regressing", "ok", "regressing"]
    assert not state["tripped"]


def test_killswitch_rearms_after_cooldown_probes():
    out, state = on_both(lambda pkg: verdicts(
        pkg, [1.0, 1.0, 5.0, 1.0, 1.0, 1.0], threshold=1.5, patience=1,
        cooldown=2, min_samples=2))
    assert out[2:] == ["trip", "cooling", "rearm", "ok"]
    assert not state["tripped"]


def test_killswitch_unhealthy_probe_restarts_cooldown():
    out, _ = on_both(lambda pkg: verdicts(
        pkg, [1.0, 1.0, 5.0, 1.0, 5.0, 1.0, 1.0], threshold=1.5,
        patience=1, cooldown=2, min_samples=2))
    assert out[3:] == ["cooling", "cooling", "cooling", "rearm"]


def test_killswitch_regressions_never_enter_baseline():
    ks = KillSwitch(threshold=1.5, patience=10, window=4, min_samples=2)
    ks.observe(1.0), ks.observe(1.0)
    for _ in range(8):
        ks.observe(1.8)
    assert ks.baseline == pytest.approx(1.0)


def test_killswitch_reset_baseline_forgets_history():
    ks = KillSwitch(min_samples=2)
    ks.observe(1.0), ks.observe(1.0)
    assert ks.baseline is not None
    ks.reset_baseline()
    assert ks.baseline is None
    assert ks.observe(99.0) == "ok"


def test_killswitch_validates_parameters():
    with pytest.raises(ValueError):
        KillSwitch(threshold=0.9)
    with pytest.raises(ValueError):
        KillSwitch(patience=0)


# -- ServeGuard -----------------------------------------------------------------

def poisoned_controller(pkg, n, poison_from, bad, **kw):
    """Scripted controller regression: from update ``poison_from`` on it
    pushes the shares to a fixed bad split."""

    class Poisoned(pkg.EwmaController):
        def update(self, times, rows=None):
            self.updates = getattr(self, "updates", 0) + 1
            if self.updates >= poison_from:
                self.shares = np.asarray(bad, np.float64).copy()
                return self.shares
            return super().update(times, rows=rows)

    return Poisoned(n, **kw)


def make_guarded(pkg=PORT, poison_from=8, fallback=(0.75, 0.25),
                 **switch_kw):
    clock = pkg.VirtualClock()
    groups = pkg.sim_skew_groups(skew=3)
    ctrl = poisoned_controller(pkg, 2, poison_from, [0.15, 0.85],
                               min_share=0.02)
    sched = pkg.ChunkedScheduler(
        pkg.make_serial_sim_builder(0.0005, clock=clock), groups,
        controller=ctrl, clock=clock)
    kw = dict(threshold=1.5, patience=5, cooldown=3)
    kw.update(switch_kw)
    guard = pkg.ServeGuard(sched, switch=pkg.KillSwitch(**kw),
                           fallback=None if fallback is None
                           else np.asarray(fallback))
    return guard, sched


def guarded_run(pkg, steps, **kw):
    guard, _ = make_guarded(pkg, **kw)
    recs = [guard.step(BATCH) for _ in range(steps)]
    return ([r["guard"]["verdict"] for r in recs], summary(recs),
            guard.switch.n_trips)


def test_guard_trips_within_patience_and_pins_fallback():
    verdict, recs, _ = on_both(lambda pkg: guarded_run(pkg, 20))
    trip = verdict.index("trip")
    assert verdict[trip - 4:trip] == ["regressing"] * 4
    healthy = recs[trip - 5][3]
    assert recs[trip + 1][3] <= 1.10 * healthy
    np.testing.assert_allclose(recs[trip + 1][6], [0.75, 0.25])


def test_guard_rearm_returns_control_to_controller():
    verdict, _, n_trips = on_both(lambda pkg: guarded_run(pkg, 40))
    assert "rearm" in verdict and n_trips >= 2


def test_guard_learns_fallback_when_none_given():
    verdict, recs, _ = on_both(lambda pkg: guarded_run(pkg, 20,
                                                       fallback=None))
    pinned = recs[verdict.index("trip") + 1][6]
    assert pinned[0] == pytest.approx(0.75, abs=0.05)


def test_guard_membership_change_resets_baseline():
    def run(pkg):
        clock = pkg.VirtualClock()
        groups = pkg.sim_skew_groups(skew=3)
        inj = pkg.FaultInjector(pkg.FaultPlan().kill(0, at=6), groups)
        sched = pkg.ChunkedScheduler(
            pkg.make_serial_sim_builder(0.0005, clock=clock, injector=inj),
            groups, controller=pkg.EwmaController(2, min_share=0.02),
            clock=clock)
        guard = pkg.ServeGuard(sched, switch=pkg.KillSwitch(threshold=1.3,
                                                            patience=2))
        inj.attach(guard)
        recs = []
        for _ in range(14):
            inj.tick()
            recs.append(guard.step(BATCH))
        return ([r["guard"]["verdict"] for r in recs], summary(recs),
                guard.switch.n_trips)
    verdict, recs, n_trips = on_both(run)
    assert verdict[6] == "membership-change" and n_trips == 0
    assert all(sum(r[2]) == 64 for r in recs)


def test_guard_projects_fallback_onto_live_membership():
    guard, sched = make_guarded()
    sched.controller.drop(0)
    shares = guard._fallback_shares()
    assert shares[0] == 0.0
    assert shares[1] == pytest.approx(1.0)


def test_fallback_from_store_resolves_tuned_fraction(tmp_path):
    class Rec:
        best_config = {"fraction": 70}

    class Store:
        def best_record(self, space, workload):
            assert space == "stream_split"
            return Rec()

    np.testing.assert_allclose(fallback_from_store(Store(), {}), [0.7, 0.3])
    np.testing.assert_allclose(ref_runtime.fallback_from_store(Store(), {}),
                               [0.7, 0.3])
    assert fallback_from_store(None, {}) is None
    assert fallback_from_store(Store(), {}, n_groups=3) is None

    # a real store, keyed by the space the paper's split was tuned over
    from repro_torch.launch.serve import split_space
    from repro_torch.runtime import TuningStore
    from repro_torch.tune import TuneResult

    space = split_space()
    store = TuningStore(tmp_path / "s.json", devices="pinned")
    cfg = {"host_threads": 8, "host_affinity": "none", "host_fraction": 25.0}
    store.record(space, {"w": 1}, "SAML",
                 TuneResult("SAML", cfg, 1.0, 1.0, 5, 0, 0, space.size()))
    np.testing.assert_allclose(fallback_from_store(store, {"w": 1},
                                                   space=space), [0.25, 0.75])


# -- StreamingPipeline integration ----------------------------------------------

def test_pipeline_with_guard_survives_kill_and_counts_rows():
    def run(pkg):
        clock = pkg.VirtualClock()
        groups = pkg.sim_skew_groups(skew=3)
        inj = pkg.FaultInjector(pkg.FaultPlan().kill(0, at=5), groups)
        pipe = pkg.StreamingPipeline(
            pkg.make_serial_sim_builder(0.0005, clock=clock, injector=inj),
            groups, controller=pkg.EwmaController(2, min_share=0.02),
            clock=clock, guard=True)
        inj.attach(pipe.guard)
        for _ in range(12):
            inj.tick()
            pipe.run([BATCH])
        return pipe.summary()
    s = on_both(run)
    assert s["batches"] == 12 and s["rows_total"] == 12 * 64
    assert s["live_final"] == [False, True]
    assert s["failures"] == 1 and s["guard_trips"] == 0


# -- sim / real dispatch agreement ----------------------------------------------

def scripted_plan(pkg):
    return (pkg.FaultPlan().transient(1, at=2).recover(1, at=3)
            .kill(0, at=5).recover(0, at=8))


def fault_trajectory(sched, inj, x, steps=10):
    out = []
    for _ in range(steps):
        inj.tick()
        rec = sched.step({"x": x})
        out.append((rec["live"], bool(rec["failures"])))
        assert sum(rec["rows_completed"]) == 64
    return out


def test_same_fault_plan_drives_sim_and_real_dispatch_identically():
    """One ``FaultPlan`` gives the same membership/failure trajectory on
    the serial-device sim (both packages) and on real dispatch: CPU groups
    whose steps sum rows on worker threads."""
    from repro_torch.runtime.stream import FutureHandle, host_executor

    def sim(pkg):
        clock = pkg.VirtualClock()
        groups = [pkg.DeviceGroup("a", [pkg.FakeDevice()] * 4),
                  pkg.DeviceGroup("b", [pkg.FakeDevice()] * 4)]
        inj = pkg.FaultInjector(scripted_plan(pkg), groups)
        sched = pkg.ChunkedScheduler(
            pkg.make_serial_sim_builder(0.0005, clock=clock, injector=inj),
            groups, controller=pkg.EwmaController(2, min_share=0.02),
            clock=clock)
        inj.attach(sched)
        return fault_trajectory(sched, inj, np.zeros((64, 16), np.float32))

    sim_traj = on_both(sim)
    pool = host_executor()
    rgroups = [DeviceGroup("a", [torch.device("cpu")] * 4),
               DeviceGroup("b", [torch.device("cpu")] * 4)]
    rinj = FaultInjector(scripted_plan(PORT), rgroups)

    def builder(group):
        def fn(chunk):
            return FutureHandle(pool.submit(lambda v: v.sum(dim=1),
                                            chunk["x"]))
        return fn

    rsched = ChunkedScheduler(rinj.wrap(builder), rgroups,
                              controller=EwmaController(2, min_share=0.02))
    rinj.attach(rsched)
    try:
        real_traj = fault_trajectory(rsched, rinj, torch.zeros(64, 16))
    finally:
        rsched.close()
        pool.shutdown()
    assert [t[0] for t in sim_traj] == [t[0] for t in real_traj]
    assert [t[1] for t in sim_traj] == [t[1] for t in real_traj]


# -- property tests: controller invariants under arbitrary sequences ------------

def _apply_ops(ctrl, rng, n_ops):
    n = ctrl.n_groups
    for _ in range(n_ops):
        op = rng.integers(0, 3)
        gi = int(rng.integers(0, n))
        if op == 0:
            if ctrl.live[gi] and ctrl.n_live > 1:
                ctrl.drop(gi)
        elif op == 1:
            ctrl.restore(gi)
        else:
            ctrl.update(rng.uniform(0.1, 5.0, n))


@settings(max_examples=40)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_property_shares_stay_on_simplex_under_drop_restore(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 6))
        ctrl = pkg.EwmaController(n, min_share=0.02)
        _apply_ops(ctrl, rng, n_ops=int(rng.integers(1, 30)))
        return ctrl.shares.tolist(), ctrl.live.tolist(), ctrl.min_share
    shares, live, floor = on_both(run)
    assert sum(shares) == pytest.approx(1.0) and any(live)
    for s, alive in zip(shares, live):
        assert s >= floor - 1e-12 if alive else s == 0.0


@settings(max_examples=25)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_property_plan_never_assigns_rows_to_dropped_group(seed):
    def run(pkg):
        rng = np.random.default_rng(seed)
        sched, _, _ = make_sim(pkg, three_equal_groups(pkg))
        _apply_ops(sched.controller, rng, n_ops=int(rng.integers(1, 20)))
        n = int(rng.integers(3, 17)) * 12
        rows = sched.plan_rows(n)
        rec = sched.step({"x": np.zeros((n, 4), np.float32)},
                         rebalance=False)
        return n, rows, sched.controller.live.tolist(), rec["rows_completed"]
    n, rows, live, done = on_both(run)
    assert sum(rows) == n
    for gi in range(3):
        if not live[gi]:
            assert rows[gi] == 0 and done[gi] == 0
        else:
            assert rows[gi] >= 4
