"""repro_torch.obs held against repro.obs: tracer format and determinism,
histogram percentiles, journal schema and causal order, the zero-cost
disabled path, and the instrumented runtime/guard/tuning call sites.

The instrumented scenarios run through both packages on a
``VirtualClock`` and their journals, traces and metrics are compared
exactly.  The serve fault drill runs in-process (the reference's test
starts its CLI in a subprocess)."""

import io
import json
import threading
import tracemalloc
from bisect import bisect_left
from pathlib import Path

import numpy as np
import pytest

import repro.obs as ref_obs
import repro.runtime as ref_runtime
import repro_torch.obs as obs_pkg
import repro_torch.runtime as port_runtime
from repro_torch.obs import (EVENT_KINDS, Histogram, Journal, MetricsRegistry,
                             Observer, Tracer, as_observer, configure,
                             get_logger, load_journal, load_trace,
                             validate_events, validate_trace)
from repro_torch.obs.__main__ import check_required_order
from repro_torch.obs.__main__ import main as check_main
from repro_torch.obs.metrics import default_latency_buckets
from repro_torch.runtime import FaultPlan, VirtualClock, parse_fault_plan

REPO = Path(__file__).resolve().parents[1]
SIDES = {"ref": (ref_obs, ref_runtime), "port": (obs_pkg, port_runtime)}
BATCH = {"x": np.zeros((128, 4), np.float32)}


def sim_rig(observer="on", *, plan=None, skew=3, per_row_s=4e-4,
            side="port"):
    """A 2-group serial-sim scheduler on a VirtualClock with an observer
    sharing the clock.  ``observer``: "on" | "off" | None (absent)."""
    obs_mod, rt = SIDES[side]
    clock = rt.VirtualClock()
    obs = None if observer is None else obs_mod.Observer(
        enabled=observer == "on", clock=clock)
    groups = rt.sim_skew_groups(skew)
    injector = rt.FaultInjector(plan, groups) if plan is not None else None
    sched = rt.ChunkedScheduler(
        rt.make_serial_sim_builder(per_row_s, clock=clock, injector=injector),
        groups, controller=rt.EwmaController(2, min_share=0.02),
        clock=clock, observer=obs)
    if injector is not None:
        injector.attach(sched)
    return sched, obs, injector, clock


def sorted_trace(events):
    key = ("ts", "dur", "name", "tid", "ph")
    return sorted(events, key=lambda e: tuple(str(e.get(k)) for k in key))


# -- histogram percentiles vs numpy ---------------------------------------------

def _bucket_window(h, value):
    i = bisect_left(h.bounds, value)
    lo = h.bounds[i - 1] if i > 0 else h.min
    hi = h.bounds[i] if i < len(h.bounds) else h.max
    return lo, hi


def test_histogram_percentiles_match_numpy_within_bucket():
    rng = np.random.default_rng(0)
    data = rng.lognormal(mean=-6.0, sigma=1.2, size=800)
    h, r = Histogram("t"), ref_obs.Histogram("t")
    for v in data:
        h.observe(v)
        r.observe(v)
    assert h.count == 800 and h.summary() == r.summary()
    assert h.sum == pytest.approx(data.sum())
    prev = 0.0
    for q in (0.50, 0.95, 0.99):
        exact = float(np.percentile(data, q * 100, method="linear"))
        est = h.percentile(q)
        lo, hi = _bucket_window(h, exact)
        assert lo * (1 - 1e-9) <= est <= hi * (1 + 1e-9), (q, exact, est)
        assert est >= prev
        prev = est


def test_histogram_single_bucket_interpolation():
    rng = np.random.default_rng(1)
    lo, hi = 1e-3, 10 ** (-3 + 0.25)
    data = rng.uniform(lo * 1.01, hi * 0.99, size=200)
    h = Histogram("t")
    for v in data:
        h.observe(v)
    for q in (0.5, 0.95):
        exact = float(np.percentile(data, q * 100))
        assert abs(h.percentile(q) - exact) <= hi - lo
    bounds = default_latency_buckets()
    assert bounds == tuple(sorted(bounds))
    assert bounds == ref_obs.default_latency_buckets()


def test_histogram_edges_overflow_and_clamping():
    h = Histogram("t", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 500.0):
        h.observe(v)
    assert h.counts == [1, 1, 1]
    assert h.min <= h.percentile(0.0) <= 1.0
    assert h.percentile(1.0) == 500.0
    with pytest.raises(ValueError):
        h.percentile(1.5)
    with pytest.raises(ValueError):
        Histogram("bad", buckets=(2.0, 1.0))
    empty = Histogram("e")
    assert empty.percentile(0.5) is None
    assert empty.summary() == {"count": 0, "sum": 0.0}


# -- metrics registry ------------------------------------------------------------

def test_registry_get_or_create_and_snapshot():
    m = MetricsRegistry()
    c = m.counter("a")
    c.inc()
    c.inc(2)
    assert m.counter("a") is c and c.value == 3
    m.gauge("g").set(0.5)
    m.histogram("h").observe(1e-3)
    snap = m.to_dict()
    assert snap["counters"] == {"a": 3}
    assert snap["gauges"] == {"g": 0.5}
    assert snap["histograms"]["h"]["count"] == 1


def test_disabled_registry_hands_out_noops():
    m = MetricsRegistry(enabled=False)
    c, g, h = m.counter("a"), m.gauge("g"), m.histogram("h")
    c.inc(10)
    g.set(1.0)
    h.observe(2.0)
    assert h.percentile(0.5) is None
    assert m.counter("other") is c
    assert m.to_dict() == {"counters": {}, "gauges": {}, "histograms": {}}


# -- journal ---------------------------------------------------------------------

def test_journal_round_trip_and_schema(tmp_path):
    clock = VirtualClock()
    j = Journal(clock=clock)
    j.event("tuning_start", strategy="sam", space_size=19)
    clock.advance(0.5)
    j.event("store_miss", strategy="sam", key="k")
    clock.advance(0.5)
    j.event("tuning_stop", strategy="sam", from_cache=False)
    assert len(j) == 3
    assert j.by_kind("store_miss")[0]["key"] == "k"
    assert j.kinds() == {"tuning_start": 1, "store_miss": 1,
                         "tuning_stop": 1}
    path = j.save(tmp_path / "journal.jsonl")
    events = load_journal(path)
    assert events == j.events and validate_events(events) == []
    assert ref_obs.load_journal(path) == events
    assert [e["seq"] for e in events] == [0, 1, 2]
    assert events[1]["ts"] == pytest.approx(0.5)
    with pytest.raises(ValueError, match="unknown journal event kind"):
        j.event("not_a_kind")
    tampered = [dict(events[0], seq=7), dict(events[1], kind="bogus")]
    errs = validate_events(tampered)
    assert any("not dense" in e for e in errs)
    assert any("unknown kind" in e for e in errs)


def test_journal_live_sink_mirrors_events():
    sink = io.StringIO()
    j = Journal(sink=sink)
    j.event("store_hit", key="k")
    line = json.loads(sink.getvalue())
    assert line["kind"] == "store_hit" and line["seq"] == 0


# -- tracer ----------------------------------------------------------------------

def test_trace_format_and_round_trip(tmp_path):
    clock = VirtualClock()
    t = Tracer(clock=clock)
    t.thread_name(0, "group:fast")
    t.complete("chunk", 0.0, 0.002, tid=0, args={"rows": 64})
    clock.advance(0.01)
    t.instant("demote", tid=0)
    with t.span("tune.sam", args={"objective": "time"}):
        clock.advance(0.25)
    assert len(t) == 4
    path = t.save(tmp_path / "trace.json")
    events = load_trace(path)
    assert validate_trace(events) == [] and ref_obs.load_trace(path) == events
    by_name = {e["name"]: e for e in events}
    assert by_name["chunk"]["ph"] == "X"
    assert by_name["chunk"]["dur"] == pytest.approx(2000.0)
    assert by_name["demote"]["ph"] == "i" and by_name["demote"]["s"] == "t"
    assert by_name["thread_name"]["ph"] == "M"
    assert by_name["tune.sam"]["dur"] == pytest.approx(0.25e6)
    doc = json.loads(path.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    assert validate_trace([{"ph": "Q"}]) != []
    assert any("missing key" in e
               for e in validate_trace([{"ph": "X", "name": "x"}]))


def test_trace_cross_thread_begin_end():
    clock = VirtualClock()
    t = Tracer(clock=clock)
    token = t.begin("drain", tid=1)
    clock.advance(0.003)
    th = threading.Thread(target=t.end, args=(token,),
                          kwargs={"args": {"rows": 32}})
    th.start()
    th.join()
    t.end(9999)
    assert len(t) == 1
    assert t.events[0]["dur"] == pytest.approx(3000.0)
    assert t.events[0]["args"] == {"rows": 32}


# -- zero-cost disabled path -----------------------------------------------------

def test_disabled_observer_resolves_to_none_and_stays_empty():
    on = Observer()
    assert as_observer(on) is on and as_observer(None) is None
    sched, off, _, _ = sim_rig("off")
    assert as_observer(off) is None and sched._obs is None
    for _ in range(4):
        sched.step(BATCH)
    assert len(off.tracer) == 0 and len(off.journal) == 0
    assert off.metrics.to_dict() == {"counters": {}, "gauges": {},
                                     "histograms": {}}


def test_disabled_observer_allocates_nothing_per_step():
    sched, _, _, _ = sim_rig("off")
    for _ in range(3):
        sched.step(BATCH)
    obs_dir = str(Path(obs_pkg.__file__).parent)
    tracemalloc.start()
    try:
        for _ in range(5):
            sched.step(BATCH)
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    obs_allocs = snap.filter_traces(
        [tracemalloc.Filter(True, obs_dir + "/*")]).statistics("filename")
    assert sum(s.size for s in obs_allocs) == 0, obs_allocs


# -- instrumented scheduler ------------------------------------------------------

def drill(side, steps, plan_fn=None):
    plan = None if plan_fn is None else plan_fn(SIDES[side][1].FaultPlan())
    sched, obs, injector, _ = sim_rig("on", plan=plan, side=side)
    for _ in range(steps):
        if injector is not None:
            injector.tick()
        sched.step(BATCH)
    return sched, obs


def test_scheduler_metrics_and_rebalance_journal():
    runs = {side: drill(side, 6) for side in SIDES}
    sched, obs = runs["port"]
    ref = runs["ref"][1]
    assert obs.journal.events == ref.journal.events
    assert obs.metrics.to_dict() == ref.metrics.to_dict()
    assert sorted_trace(obs.tracer.events) == sorted_trace(ref.tracer.events)
    m = obs.metrics.to_dict()["counters"]
    assert m["scheduler.steps"] == 6
    assert m["scheduler.rows_completed"] == 6 * 128
    assert m["scheduler.plan_cache_hits"] + \
        m["scheduler.plan_cache_misses"] == 6
    assert m["controller.updates"] == sum(
        1 for r in sched.history if not r["plan_changed"]
        and not r["failures"]) > 0
    adopted = obs.journal.by_kind("rebalance_adopted")
    assert adopted and {"batch", "old", "new"} <= set(adopted[0])
    gauges = obs.metrics.to_dict()["gauges"]
    assert gauges["controller.share.g0"] == pytest.approx(
        float(sched.shares[0]), abs=1e-6)
    names = {e["name"] for e in obs.tracer.events}
    assert {"scheduler.step", "chunk", "dispatch"} <= names
    assert validate_trace(obs.tracer.events) == []


def test_scheduler_demote_redispatch_restore_causal_order():
    runs = {side: drill(side, 10, lambda p: p.kill(0, at=3).recover(0, at=8))
            for side in SIDES}
    obs = runs["port"][1]
    assert obs.journal.events == runs["ref"][1].journal.events
    demoted = obs.journal.by_kind("group_demoted")
    redisp = obs.journal.by_kind("chunks_redispatched")
    restored = obs.journal.by_kind("group_restored")
    assert demoted and redisp and restored
    assert demoted[0]["group"] == "fast"
    assert "killed at step 3" in demoted[0]["reason"]
    assert redisp[0]["from_groups"] == ["fast"] and redisp[0]["rows"] > 0
    assert demoted[0]["seq"] < redisp[0]["seq"] < restored[0]["seq"]
    assert demoted[0]["ts"] <= redisp[0]["ts"] <= restored[0]["ts"]
    assert validate_events(obs.journal.events) == []


def test_trace_is_deterministic_under_fault_plan():
    def run(side):
        _, obs = drill(side, 8, lambda p: p.kill(0, at=3).slow(1, at=6,
                                                               factor=2.0))
        return (sorted_trace(obs.tracer.events), obs.journal.events,
                obs.metrics.to_dict())

    assert run("port") == run("port") == run("ref")


# -- guard / kill switch ---------------------------------------------------------

def test_guard_journal_armed_tripped_rearmed():
    def run(side):
        obs_mod, rt = SIDES[side]

        class Poisoned(rt.EwmaController):
            def update(self, times, rows=None):
                self.updates = getattr(self, "updates", 0) + 1
                if self.updates >= 8:
                    self.shares = np.asarray([0.15, 0.85])
                    return self.shares
                return super().update(times, rows=rows)

        clock = rt.VirtualClock()
        obs = obs_mod.Observer(clock=clock)
        sched = rt.ChunkedScheduler(
            rt.make_serial_sim_builder(4e-4, clock=clock),
            rt.sim_skew_groups(3), controller=Poisoned(2, min_share=0.02),
            clock=clock, observer=obs)
        guard = rt.ServeGuard(sched, switch=rt.KillSwitch(
            threshold=1.5, patience=3, cooldown=3),
            fallback=np.asarray([0.75, 0.25]))
        assert guard._obs is obs
        verdicts = [guard.step(BATCH)["guard"]["verdict"] for _ in range(25)]
        return verdicts, obs

    verdicts, obs = run("port")
    ref_verdicts, ref = run("ref")
    assert verdicts == ref_verdicts
    assert obs.journal.events == ref.journal.events
    assert "trip" in verdicts and "rearm" in verdicts
    armed = obs.journal.by_kind("killswitch_armed")
    tripped = obs.journal.by_kind("killswitch_tripped")
    rearmed = obs.journal.by_kind("killswitch_rearmed")
    assert len(armed) == 1 and armed[0]["patience"] == 3
    assert tripped and tripped[0]["t_step"] > tripped[0]["baseline"]
    assert rearmed
    assert armed[0]["seq"] < tripped[0]["seq"] < rearmed[0]["seq"]
    counters = obs.metrics.to_dict()["counters"]
    assert counters["guard.verdict.trip"] == verdicts.count("trip")
    assert counters["guard.verdict.ok"] == verdicts.count("ok")


# -- tuning session accounting ---------------------------------------------------

def test_session_accounting_and_store_events(tmp_path):
    from repro_torch.core import ConfigSpace, Param
    from repro_torch.runtime import TuningStore
    from repro_torch.tune import TuningSession

    space = ConfigSpace([Param("x", tuple(range(12)))])
    store = TuningStore(tmp_path / "t.json", devices="pinned")
    obs = Observer()
    session = TuningSession(space, evaluator=lambda c: (c["x"] - 7) ** 2,
                            store=store, observer=obs, device="cpu")
    res = session.run("sam", iterations=8, seed=0)
    assert res.space_size == space.size() == 12
    assert 0 < res.n_measured <= res.n_experiments
    assert res.experiments_fraction == pytest.approx(res.n_experiments / 12)
    assert obs.journal.by_kind("store_miss")
    stops = obs.journal.by_kind("tuning_stop")
    assert stops[-1]["from_cache"] is False
    assert stops[-1]["n_measured"] == res.n_measured
    assert stops[-1]["space_size"] == 12

    res2 = session.run("sam", iterations=8, seed=0)
    assert res2.best_config == res.best_config
    assert obs.journal.by_kind("store_hit")
    assert obs.journal.by_kind("tuning_stop")[-1]["from_cache"] is True
    c = obs.metrics.to_dict()["counters"]
    assert c["tune.store_hits"] == 1 and c["tune.store_misses"] == 1
    starts = obs.journal.by_kind("tuning_start")
    assert len(starts) == 2 and starts[0]["seq"] < stops[0]["seq"]
    assert any(e["name"] == "tune.sam" for e in obs.tracer.events)
    # the same journal kinds, in the same order, as the reference's session
    from repro.core import ConfigSpace as RefSpace, Param as RefParam
    from repro.tune import TuningSession as RefSession

    ref = ref_obs.Observer()
    RefSession(RefSpace([RefParam("x", tuple(range(12)))]),
               evaluator=lambda c: (c["x"] - 7) ** 2,
               observer=ref).run("sam", iterations=8, seed=0)
    port = Observer()
    TuningSession(space, evaluator=lambda c: (c["x"] - 7) ** 2,
                  observer=port, device="cpu").run("sam", iterations=8,
                                                   seed=0)
    strip = [{k: v for k, v in e.items() if k != "ts"}
             for e in port.journal.events]
    assert strip == [{k: v for k, v in e.items() if k != "ts"}
                     for e in ref.journal.events]


def test_kernel_timer_counts_deduplicated_executions():
    from repro_torch.tune import kernels as ktune
    from repro_torch.tune.kernels.evaluate import KernelTimer

    spec = ktune.get_kernel("flash_attention")
    meta = spec.smoke_shape
    space = spec.space(meta)
    obs = Observer()
    # the launch space is the bfloat16 build's (the reference's test times
    # its float32 Pallas kernel)
    timer = KernelTimer(spec, meta, "bfloat16", repeats=1, seed=0,
                        observer=obs, device="cpu")
    cfg = spec.default_config(space, meta)
    t1 = timer(cfg)
    t2 = timer(cfg)
    assert np.isfinite(t1) and t1 == t2
    assert timer.n_measured == 1
    c = obs.metrics.to_dict()["counters"]
    assert c[f"kernel.{spec.name}.measured"] == 1
    assert c[f"kernel.{spec.name}.cache_hits"] == 1


# -- streaming pipeline ----------------------------------------------------------

def test_stream_summary_reports_latency_percentiles():
    def run(side):
        obs_mod, rt = SIDES[side]
        clock = rt.VirtualClock()
        pipe = rt.StreamingPipeline(
            rt.make_serial_sim_builder(4e-4, clock=clock),
            rt.sim_skew_groups(3),
            controller=rt.EwmaController(2, min_share=0.02), clock=clock,
            observer=obs_mod.Observer(clock=clock))
        pipe.run([BATCH] * 6)
        return pipe.summary()
    s = run("port")
    assert s == run("ref")
    assert s["batches"] == 6
    assert 0 < s["t_step_p50"] <= s["t_step_p95"] <= s["t_step_p99"]


# -- structured logger -----------------------------------------------------------

def test_logger_levels_journal_mirror_and_configure():
    out = io.StringIO()
    j = Journal()
    log = get_logger("repro_torch.test_obs")
    try:
        configure(level="info", journal=j, stream=out)
        log.debug("hidden")
        log.info("shown line", batches=4)
        log.warning("warned")
        assert out.getvalue() == "shown line\nwarned\n"
        assert [e["msg"] for e in j.events] == ["shown line", "warned"]
        assert j.events[0]["kind"] == "log"
        assert j.events[0]["batches"] == 4
        assert j.events[0]["logger"] == "repro_torch.test_obs"
        configure(level="error")
        log.warning("now hidden")
        assert out.getvalue() == "shown line\nwarned\n"
        configure(level="debug", journal=False)
        log.debug("visible again")
        assert out.getvalue().endswith("visible again\n")
        assert len(j.events) == 2
        with pytest.raises(ValueError, match="unknown log level"):
            configure(level="loud")
    finally:
        configure(level="info", journal=False, stream=False)
    assert get_logger("repro_torch.test_obs") is log


# -- fault-plan CLI surface ------------------------------------------------------

def test_parse_fault_plan_round_trips_the_chained_builder():
    spec = "kill:0@3, slow:1@9:4, transient:0@5,recover:0@12"
    parsed = parse_fault_plan(spec)
    chained = (FaultPlan().kill(0, at=3).slow(1, at=9, factor=4.0)
               .transient(0, at=5).recover(0, at=12))
    assert parsed.events == chained.events
    assert [vars(e) for e in parsed.events] == [
        vars(e) for e in ref_runtime.parse_fault_plan(spec).events]
    with pytest.raises(ValueError, match="unknown fault kind"):
        parse_fault_plan("explode:0@3")
    for bad in ("kill:0", "slow:1@9", "kill:a@b"):
        with pytest.raises(ValueError, match="bad fault-plan event"):
            parse_fault_plan(bad)


# -- validator CLI helpers -------------------------------------------------------

def test_check_required_order():
    events = [{"seq": 0, "ts": 0.0, "kind": "group_demoted"},
              {"seq": 1, "ts": 1.0, "kind": "chunks_redispatched"},
              {"seq": 2, "ts": 2.0, "kind": "killswitch_tripped"}]
    assert check_required_order(
        events, ["group_demoted", "chunks_redispatched",
                 "killswitch_tripped"]) == []
    assert any("never occurred" in e for e in check_required_order(
        events, ["group_restored"]))
    assert check_required_order(
        events, ["killswitch_tripped", "group_demoted"]) != []


def test_schema_file_matches_event_catalog():
    schema = json.loads((REPO / "docs" / "obs_schema.json").read_text())
    assert set(schema["journal"]["kinds"]) == set(EVENT_KINDS)
    assert EVENT_KINDS == ref_obs.EVENT_KINDS
    for kind in ("request_admitted", "request_shed", "request_retired",
                 "request_retried"):
        assert kind in schema["journal"]["kinds"]


# -- report ----------------------------------------------------------------------

def test_summary_report_and_render(tmp_path):
    obs = Observer()
    obs.metrics.counter("scheduler.steps").inc(4)
    obs.metrics.histogram("scheduler.t_step_s").observe(2e-3)
    obs.journal.event("store_hit", key="k")
    obs.tracer.instant("demote")
    path = tmp_path / "obs_summary.json"
    summary = obs.write_summary(path, extra={"stream": {"batches": 4}},
                                date="2026-08-07")
    on_disk = json.loads(path.read_text())
    assert on_disk["metrics"]["counters"]["scheduler.steps"] == 4
    assert on_disk["journal"]["by_kind"] == {"store_hit": 1}
    assert on_disk["trace"]["n_events"] == 1
    assert on_disk["meta"]["date"] == "2026-08-07"
    assert on_disk["stream"] == {"batches": 4}
    # provenance names torch and CUDA where the reference names jax
    assert on_disk["meta"]["torch"] and "jax" not in on_disk["meta"]
    text = obs.render()
    assert "scheduler.steps" in text and "store_hit" in text
    assert "torch" in text.splitlines()[1]
    assert summary["journal"]["n_events"] == 1


# -- end-to-end: the serve fault drill -------------------------------------------

def test_serve_fault_drill_produces_causal_artifacts(tmp_path, capsys):
    from repro_torch.launch import serve

    trace = tmp_path / "trace.json"
    journal = tmp_path / "journal.jsonl"
    metrics = tmp_path / "obs_summary.json"
    try:
        serve.main(["--smoke", "--stream", "--batch", "16",
                    "--stream-batches", "16", "--slow", "4", "--guard",
                    "--guard-patience", "2",
                    "--fault-plan", "kill:0@3,slow:1@9:4",
                    "--trace-out", str(trace), "--journal-out", str(journal),
                    "--metrics-out", str(metrics)])
    finally:
        configure(level="info", journal=False, stream=False)
    events = load_trace(trace)
    assert validate_trace(events) == [] and len(events) > 20
    jev = load_journal(journal)
    assert validate_events(jev) == []
    order = ["group_demoted", "chunks_redispatched", "killswitch_tripped"]
    assert check_required_order(jev, order) == []
    demoted = [e for e in jev if e["kind"] == "group_demoted"][0]
    assert demoted["group"] == "fast" and "killed at step 3" in \
        demoted["reason"]
    summary = json.loads(metrics.read_text())
    assert summary["metrics"]["counters"]["scheduler.steps"] == 16
    assert summary["journal"]["n_events"] >= len(jev)
    capsys.readouterr()
    assert check_main(["--trace", str(trace), "--journal", str(journal),
                       "--schema", str(REPO / "docs" / "obs_schema.json"),
                       "--require", ",".join(order)]) == 0
    assert "[obs] OK" in capsys.readouterr().out
