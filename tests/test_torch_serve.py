"""Request-level serving (``repro_torch.serve``) held against the
reference's ``repro.serve``: lifecycle, batching, admission, fault drills,
batcher tuning, the request CLI and ``serve_requests`` on a model.

The serving layer is framework-free and re-homed onto the port's
runtime, so every engine-level scenario runs the deterministic sim rig
(``make_sim_engine``: skewed fake groups + ``VirtualClock``) through both
packages with the same ``(n_requests, rate_rps, seed, fault plan)``: the
summaries must be equal and the journals equal event for event (journal
events carry no provenance fields; the metrics summary's ``meta`` block,
which names the framework, is left out where a summary file is read).
"""

import json
import os
import subprocess
import sys
import types

import pytest

from helpers import SRC

import repro.obs as ref_obs
import repro.runtime.simulate as ref_simulate
import repro.serve as ref_serve
import repro_torch.obs as port_obs
import repro_torch.runtime.simulate as port_simulate
import repro_torch.serve as port_serve
from repro_torch.obs import Observer
from repro_torch.obs.journal import EVENT_KINDS, validate_events
from repro_torch.runtime import TuningStore
from repro_torch.serve import (AdmissionController, BatcherConfig,
                               ContinuousBatcher, Request, RequestSource,
                               ServiceEstimator, SloPolicy, batcher_space,
                               make_sim_engine, tune_batcher)

CAP_ROWS_PER_S = (4 + 4 / 3) / 4e-4     # the sim rig's drain rate
CAP_RPS = CAP_ROWS_PER_S / 2.1          # ~rows per request in the mix

REF = types.SimpleNamespace(serve=ref_serve, sim=ref_simulate, obs=ref_obs)
PORT = types.SimpleNamespace(serve=port_serve, sim=port_simulate,
                             obs=port_obs)


def on_both(run):
    """``run(pkg) -> (summary, journal events)`` through both packages;
    the port's after checking it equals the reference's."""
    want_s, want_ev = run(REF)
    got_s, got_ev = run(PORT)
    assert got_s == want_s
    assert [json.dumps(e) for e in got_ev] == [json.dumps(e) for e in want_ev]
    return got_s, got_ev


def _req(rid=0, rows=1, t=0.0, slo=1.0, priority=0, shape=(32, 16)):
    return Request(rid=rid, rows=rows, prompt_len=shape[0], gen=shape[1],
                   t_arrival=t, slo_s=slo, priority=priority)


# -- lifecycle ---------------------------------------------------------------

def test_request_lifecycle_happy_path():
    r = _req()
    r.admit(0.1).batched()
    r.dispatched(0.2)
    r.completed(0.3)
    assert r.status == "completed" and r.terminal
    assert r.queue_delay_s == pytest.approx(0.2)
    assert r.service_s == pytest.approx(0.1)
    assert r.latency_s == pytest.approx(0.3)
    assert r.slo_ok is True
    rec = r.record()
    assert rec["status"] == "completed" and rec["shed_reason"] is None
    ref = ref_serve.Request(rid=0, rows=1, prompt_len=32, gen=16,
                            t_arrival=0.0, slo_s=1.0)
    ref.admit(0.1).batched()
    ref.dispatched(0.2)
    ref.completed(0.3)
    assert rec == ref.record() and r.wal_fields() == ref.wal_fields()


def test_request_retry_keeps_first_admit_and_restamps_dispatch():
    r = _req()
    r.admit(0.1).batched()
    r.dispatched(0.2)
    r.failed()
    assert r.t_dispatch is None
    r.retry(0.4)
    assert r.retries == 1 and r.status == "admitted"
    assert r.t_admit == pytest.approx(0.1)
    r.batched()
    r.dispatched(0.5)
    r.completed(0.6)
    assert r.queue_delay_s == pytest.approx(0.5)


def test_request_illegal_transitions_raise():
    r = _req()
    with pytest.raises(ValueError, match="illegal transition"):
        r.completed(1.0)
    r.admit(0.0)
    with pytest.raises(ValueError, match="illegal transition"):
        r.dispatched(0.1)                 # must be batched first
    r.shed(0.2, "queue_full")
    assert r.terminal and r.shed_reason == "queue_full"
    with pytest.raises(ValueError, match="illegal transition"):
        r.admit(0.3)                      # terminal states are final


def test_source_is_deterministic_and_time_ordered():
    kw = dict(n_requests=50, rate_rps=100.0, seed=9)
    a, b = RequestSource(**kw), RequestSource(**kw)
    assert [r.record() for r in a.requests] \
        == [r.record() for r in b.requests]
    # the same stream as the reference's source, request for request
    assert [r.record() for r in a.requests] \
        == [r.record() for r in ref_serve.RequestSource(**kw).requests]
    times = [r.t_arrival for r in a.requests]
    assert times == sorted(times) and times[0] > 0
    got = a.take_until(times[9])
    assert [r.rid for r in got] == list(range(10))
    assert a.remaining == 40
    assert a.next_time() == pytest.approx(times[10])


# -- continuous batcher ------------------------------------------------------

def test_batcher_coalesces_same_shape_in_priority_order():
    b = ContinuousBatcher(BatcherConfig(max_batch_rows=8,
                                        coalesce_window_s=0.0))
    lo = _req(rid=0, rows=2, priority=0)
    hi = _req(rid=1, rows=2, priority=1)
    other = _req(rid=2, rows=2, shape=(64, 8))
    for r in (lo, hi, other):
        b.push(r.admit(0.0))
    fb = b.form(1.0, align=1)
    # the high-priority request heads the queue and pins the shape;
    # the (64, 8) request must wait for a later batch
    assert [r.rid for r in fb.requests] == [1, 0]
    assert fb.shape == (32, 16) and fb.rows == 4
    assert b.queued_rows == 2
    fb2 = b.form(1.0, align=1)
    assert [r.rid for r in fb2.requests] == [2]


def test_batcher_respects_row_cap_and_alignment():
    b = ContinuousBatcher(BatcherConfig(max_batch_rows=4,
                                        coalesce_window_s=0.0))
    for i in range(3):
        b.push(_req(rid=i, rows=2).admit(0.0))
    fb = b.form(1.0, align=8)
    assert fb.rows == 4                    # 2 requests of 2; third waits
    assert fb.padded_rows == 8             # padded to the align multiple
    assert fb.spans == [(0, 2), (2, 2)]    # contiguous per-request spans


def test_batcher_oversized_request_dispatches_alone():
    b = ContinuousBatcher(BatcherConfig(max_batch_rows=4,
                                        coalesce_window_s=0.0))
    b.push(_req(rid=0, rows=9).admit(0.0))
    fb = b.form(1.0, align=1)
    assert [r.rid for r in fb.requests] == [0] and fb.rows == 9


def test_batcher_coalesce_hold_then_flush():
    b = ContinuousBatcher(BatcherConfig(max_batch_rows=64,
                                        coalesce_window_s=0.010))
    b.push(_req(rid=0, rows=2).admit(1.0))
    # another arrival is due within the window: hold until admit+window
    hold = b.form(1.001, next_arrival=1.005, align=1)
    assert hold == pytest.approx(1.010)
    # flush (source exhausted) overrides the hold
    fb = b.form(1.001, next_arrival=1.005, align=1, flush=True)
    assert fb.rows == 2
    # no arrival inside the window: dispatch immediately
    b.push(_req(rid=1, rows=2).admit(2.0))
    fb2 = b.form(2.001, next_arrival=5.0, align=1)
    assert fb2.rows == 2


# -- admission ---------------------------------------------------------------

def test_admission_queue_backpressure():
    adm = AdmissionController(SloPolicy(max_queue_rows=4))
    assert adm.admit(_req(rows=2), 0.0, queued_rows=0) is None
    assert adm.admit(_req(rows=2), 0.0, queued_rows=3) == "queue_full"


def test_admission_degraded_sheds_by_priority():
    adm = AdmissionController(SloPolicy(degraded_shed_priority=0))
    lo, hi = _req(rows=1, priority=0), _req(rows=1, priority=1)
    assert adm.admit(lo, 0.0, 0, degraded=True) == "degraded"
    assert adm.admit(hi, 0.0, 0, degraded=True) is None
    assert adm.admit(lo, 0.0, 0, degraded=False) is None


def test_admission_feasibility_uses_live_estimate():
    est = ServiceEstimator()
    adm = AdmissionController(SloPolicy(max_queue_rows=10_000),
                              estimator=est)
    hopeless = _req(rows=1, t=0.0, slo=0.5)
    # estimator not ready: feasibility is advisory, request admitted
    assert adm.admit(hopeless, 0.0, queued_rows=5000) is None
    est.observe(t_step=1.0, rows=1000)     # 1 ms per row, now ready
    # 5000 queued rows ahead -> ~5 s eta against a 0.5 s deadline
    assert adm.admit(hopeless, 0.0, queued_rows=5000) == "infeasible"
    assert adm.admit(_req(rows=1, t=0.0, slo=10.0), 0.0, 5000) is None


def test_admission_retry_bounds_and_reevaluation():
    est = ServiceEstimator()
    est.observe(1.0, 1000)                  # 1 ms/row
    adm = AdmissionController(SloPolicy(max_retries=1), estimator=est)
    r = _req(rows=1, slo=10.0)
    assert adm.retry_or_shed(r, 0.0, 0) is None
    r.retries = 1
    assert adm.retry_or_shed(r, 0.0, 0) == "retries_exhausted"
    # capacity shrink: rescale doubles per-row time; a queue of
    # tight-deadline requests behind a long backlog sheds infeasible
    queue = [_req(rid=i, rows=400, t=0.0, slo=0.5) for i in range(3)]
    est.rescale(2.0)                        # 2 ms/row now
    sheds = adm.reevaluate(queue, now=0.0)
    assert [s[1] for s in sheds] == ["infeasible"] * 3


# -- engine ------------------------------------------------------------------

def test_engine_under_capacity_completes_everything():
    def run(pkg):
        eng = pkg.serve.make_sim_engine(n_requests=150,
                                        rate_rps=0.3 * CAP_RPS, seed=5)
        return eng.run(), [r.record() for r in eng.done]

    s, records = on_both(run)
    assert s["completed"] == 150 and s["shed"] == 0
    assert s["slo_violations"] == 0
    # the decomposition adds up per request
    for r in records:
        assert r["latency_s"] == pytest.approx(r["queue_delay_s"]
                                               + r["service_s"])
    assert s["e2e_p99"] < 0.05


def test_engine_over_capacity_sheds_and_bounds_admitted_latency():
    def run(pkg):
        obs = pkg.obs.Observer()
        eng = pkg.serve.make_sim_engine(n_requests=400,
                                        rate_rps=3.0 * CAP_RPS, seed=6,
                                        observer=obs)
        return eng.run(), obs.journal.events

    s, _ = on_both(run)
    assert s["shed"] > 0 and "queue_full" in s["shed_reasons"]
    assert s["completed"] + s["shed"] == 400
    # admitted latency bounded by the backpressure bound, not the
    # offered load: queue_depth_rows of backlog at drain rate (x2)
    bound = 2 * 256 / CAP_ROWS_PER_S + 0.01
    assert s["e2e_p99"] <= bound


def test_engine_completion_instants_come_from_row_spans():
    eng = make_sim_engine(n_requests=60, rate_rps=0.5 * CAP_RPS, seed=8)
    eng.run()
    done = [r for r in eng.done if r.status == "completed"]
    # every completion instant is dispatch-coherent, and is the max of its
    # rows' completion instants (not one step-end stamp for the batch)
    for r in done:
        assert r.t_done > r.t_dispatch >= r.t_admit >= r.t_arrival
    ref = ref_serve.make_sim_engine(n_requests=60, rate_rps=0.5 * CAP_RPS,
                                    seed=8)
    ref.run()
    assert [r.t_done for r in eng.done] == [r.t_done for r in ref.done]


def test_engine_zero_lost_requests_under_kill_and_identical_journals():
    cfg_kw = dict(max_batch_rows=16, coalesce_window_s=0.0)

    def drill(pkg):
        plan = (pkg.sim.FaultPlan().transient(0, at=3).transient(1, at=3)
                .kill(0, at=6).recover(0, at=12))
        obs = pkg.obs.Observer()
        eng = pkg.serve.make_sim_engine(
            n_requests=150, rate_rps=0.5 * CAP_RPS, seed=31,
            fault_plan=plan, guard=True, observer=obs,
            batcher_config=pkg.serve.BatcherConfig(**cfg_kw))
        return eng.run(), obs.journal.events

    s1, events = on_both(drill)
    s2, events2 = drill(PORT)
    # zero lost: every request is terminal, sheds carry reasons
    assert s1["completed"] + s1["shed"] == s1["requests"] == 150
    assert all(k is not None for k in s1["shed_reasons"])
    # the retry path fired (transients on all live groups in one step)
    assert s1["retries"] > 0
    kinds = {}
    for e in events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    assert kinds.get("request_retried", 0) > 0
    assert kinds.get("group_demoted", 0) >= 1
    admitted = {e["rid"] for e in events if e["kind"] == "request_admitted"}
    retired = {e["rid"] for e in events if e["kind"] == "request_retired"}
    shed = {e["rid"] for e in events if e["kind"] == "request_shed"}
    assert retired | shed >= admitted              # all admitted resolved
    assert len(retired) == s1["completed"]
    # deterministic: bit-identical journals run to run
    assert s2 == s1
    assert [json.dumps(e) for e in events2] == [json.dumps(e) for e in events]
    # and schema-valid against the closed catalog
    assert validate_events(events) == []


def test_engine_degraded_mode_sheds_low_priority():
    def run(pkg):
        plan = pkg.sim.FaultPlan().kill(0, at=2)  # no recovery: degraded
        eng = pkg.serve.make_sim_engine(
            n_requests=120, rate_rps=0.5 * CAP_RPS, seed=13,
            fault_plan=plan, guard=True,
            batcher_config=pkg.serve.BatcherConfig(max_batch_rows=16,
                                                   coalesce_window_s=0.0))
        return eng.run(), [r.record() for r in eng.done]

    s, records = on_both(run)
    assert s["completed"] + s["shed"] == 120
    assert s["shed_reasons"].get("degraded", 0) > 0
    # degraded sheds hit the best-effort class only (priority 0)
    for r in records:
        if r["shed_reason"] == "degraded":
            assert r["priority"] == 0 and r["klass"] == "batch"


# -- tuning ------------------------------------------------------------------

def test_batcher_space_size_and_config_mapping():
    space = batcher_space()
    assert space.size() == 210
    assert space.names == ref_serve.batcher_space().names
    cfg = BatcherConfig.from_config(
        {"max_batch_rows": 32, "coalesce_window_ms": 5,
         "queue_depth_rows": 128})
    assert cfg.coalesce_window_s == pytest.approx(0.005)
    assert cfg.queue_depth_rows == 128


def test_tune_batcher_within_envelope_and_cached_repeat(tmp_path):
    store = TuningStore(tmp_path / "store.json", device="cpu")
    calls = {"n": 0}

    def evaluate(cfg):
        calls["n"] += 1
        eng = make_sim_engine(n_requests=80, rate_rps=1.2 * CAP_RPS,
                              seed=21, batcher_config=cfg)
        s = eng.run()
        return {"time": s.get("e2e_p95", 10.0) + 0.1 * s["shed_rate"]}

    workload = {"rate": 1.2, "n": 80}
    cfg, res = tune_batcher(evaluate, store=store, workload=workload)
    assert res.experiments_fraction <= 0.05
    assert not res.from_cache and calls["n"] >= res.n_experiments
    before = calls["n"]
    cfg2, res2 = tune_batcher(evaluate, store=store, workload=workload)
    assert res2.from_cache and cfg2 == cfg
    assert calls["n"] == before            # zero new measurements

    # the same search as the reference's, point for point
    def ref_evaluate(c):
        s = ref_serve.make_sim_engine(n_requests=80, rate_rps=1.2 * CAP_RPS,
                                      seed=21, batcher_config=c).run()
        return {"time": s.get("e2e_p95", 10.0) + 0.1 * s["shed_rate"]}

    ref_cfg, ref_res = ref_serve.tune_batcher(ref_evaluate)
    assert (cfg.max_batch_rows, cfg.coalesce_window_s, cfg.queue_depth_rows) \
        == (ref_cfg.max_batch_rows, ref_cfg.coalesce_window_s,
            ref_cfg.queue_depth_rows)
    assert res.n_experiments == ref_res.n_experiments


def test_serve_journal_kinds_in_catalog():
    for kind in ("request_admitted", "request_shed", "request_retired",
                 "request_retried", "request_replayed", "wal_recovered",
                 "snapshot_saved"):
        assert kind in EVENT_KINDS


# -- the CLI drill (subprocess, real artifact validation) --------------------

def _cli(*args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{SRC}:{env.get('PYTHONPATH', '')}"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_serve_requests_drill_validates(tmp_path):
    journal = tmp_path / "journal.jsonl"
    metrics = tmp_path / "metrics.json"
    proc = _cli("--serve-requests", "80", "--request-rate", "2000",
                "--fault-plan",
                "transient:0@3,transient:1@3,kill:0@6,recover:0@12",
                "--journal-out", str(journal), "--metrics-out", str(metrics))
    assert proc.returncode == 0, proc.stderr[-2000:]
    from repro_torch.obs.journal import load_journal
    events = load_journal(journal)
    assert validate_events(events) == []
    kinds = {e["kind"] for e in events}
    assert "request_admitted" in kinds and "request_retired" in kinds
    summary = json.loads(metrics.read_text())
    assert summary["serve"]["completed"] + summary["serve"]["shed"] == 80
    # the same drill through the reference's engine: the same summary and
    # the same decisions (the CLI's log lines aside)
    plan = ref_simulate.parse_fault_plan(
        "transient:0@3,transient:1@3,kill:0@6,recover:0@12")
    obs = ref_obs.Observer()
    want = ref_serve.make_sim_engine(n_requests=80, rate_rps=2000.0, seed=0,
                                     fault_plan=plan, guard=True,
                                     observer=obs).run()
    assert summary["serve"] == want
    decisions = [{k: v for k, v in e.items() if k != "seq"}
                 for e in events if e["kind"] != "log"]
    assert decisions == [{k: v for k, v in e.items() if k != "seq"}
                         for e in obs.journal.events]


# -- serve_requests on a model -----------------------------------------------

def test_serve_requests_on_the_cpu_loses_no_request():
    """The request engine over the port's prefill+decode step (the smoke
    config on a CPU group): every request ends completed or shed exactly
    once, with per-request latencies from the rows' completion stamps."""
    from repro_torch import configs
    from repro_torch.core.hetero import DeviceGroup
    from repro_torch.launch.serve import serve_requests
    from repro_torch.models import build_model

    import torch

    cfg = configs.get("qwen2.5-3b").smoke()
    model = build_model(cfg, seed=0, device="cpu").cast_for_serving()
    obs = Observer()
    out = serve_requests(cfg, groups=[DeviceGroup("all",
                                                  [torch.device("cpu")])],
                         model=model, n_requests=16, rate_rps=50.0,
                         prompt_len=8, gen=4, seed=0, observer=obs)
    s, records = out["summary"], out["records"]
    assert s["requests"] == 16 and s["completed"] >= 1
    assert sorted(r["rid"] for r in records) == list(range(16))
    assert all(r["status"] in ("completed", "shed") for r in records)
    for r in records:
        if r["status"] == "completed":
            assert r["latency_s"] == pytest.approx(r["queue_delay_s"]
                                                   + r["service_s"])
            assert r["service_s"] > 0
    assert s["tokens_per_s"] == pytest.approx(s["goodput_rows_per_s"] * 4)
    retired = [e for e in obs.journal.events
               if e["kind"] == "request_retired"]
    assert len(retired) == s["completed"]
    assert validate_events(obs.journal.events) == []


def test_serve_requests_defaults_to_the_card():
    """No groups named: one group on the card, which this machine lacks,
    so the call raises instead of running on the CPU."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import serve_requests

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_requests(configs.get("qwen2.5-3b").smoke(), n_requests=2,
                       rate_rps=10.0, prompt_len=8, gen=2)
