"""Crash durability and recovery (``repro_torch.runtime.checkpoint`` and
the WAL-backed serving engine), held against the reference's.

Mirrors ``tests/test_recover.py``.  The failure model is the process
half (``kill -9``, a torn final write, corrupt durable files); the
invariants:

  * WAL integrity — records round-trip with CRCs and dense LSNs; a torn
    tail is detected, truncated on reopen and never misread;
  * crash drill — after a scripted crash and a restart with
    ``resume=True`` every admitted rid reaches exactly one valid
    ``retire`` record across both runs (none lost, none double-retired);
    the port's WAL is **byte-identical** to the reference's for the same
    drill, and its journals equal the reference's event for event;
  * retry budget — a request retried before the crash keeps its count
    through replay;
  * corrupt stores — quarantined to ``<name>.corrupt-<sha8>``, never fatal;
  * resumable tuning — a ``MeasurementLedger``-wrapped session crashed
    mid-search replays its measured prefix;
  * the real thing — a subprocess killed with ``SIGKILL`` mid-drill leaves
    the same WAL as the in-process crash (and as the reference's), and
    the restarted process closes the accounting; the same through the
    serving CLI with ``--resume``, checked by ``python -m repro_torch.obs
    --wal --wal-complete``.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from helpers import SRC

import repro.obs as ref_obs
import repro.runtime.checkpoint as ref_checkpoint
import repro.runtime.simulate as ref_simulate
import repro.serve as ref_serve
import repro_torch.runtime.simulate as port_simulate
import repro_torch.serve as port_serve
from repro_torch.obs import Observer
from repro_torch.obs.__main__ import check_wal
from repro_torch.runtime import (MeasurementLedger, SimulatedCrash,
                                 TuningStore, WalWriter, load_snapshot,
                                 quarantine, read_wal, save_snapshot)
from repro_torch.runtime.checkpoint import tear
from repro_torch.runtime.simulate import FaultPlan, parse_fault_plan
from repro_torch.serve import make_sim_engine

CAP_ROWS_PER_S = (4 + 4 / 3) / 4e-4     # the sim rig's drain rate
CAP_RPS = CAP_ROWS_PER_S / 2.1


# -- WAL integrity -----------------------------------------------------------

def test_wal_round_trip(tmp_path):
    path = tmp_path / "wal.jsonl"
    with WalWriter(path, fsync_every=2) as w:
        w.append("admit", rid=0, rows=2)
        w.append("retire", rid=0, status="completed")
        w.append("step", step=1, now=0.5)
    records, torn = read_wal(path)
    assert torn is None
    assert [r["kind"] for r in records] == ["admit", "retire", "step"]
    assert [r["lsn"] for r in records] == [0, 1, 2]
    assert all("crc" in r for r in records)
    # one format: the reference writes the same bytes and reads these
    ref_path = tmp_path / "ref.jsonl"
    with ref_checkpoint.WalWriter(ref_path, fsync_every=2) as w:
        w.append("admit", rid=0, rows=2)
        w.append("retire", rid=0, status="completed")
        w.append("step", step=1, now=0.5)
    assert ref_path.read_bytes() == path.read_bytes()
    assert ref_checkpoint.read_wal(path) == (records, None)


def test_wal_reopen_continues_lsn(tmp_path):
    path = tmp_path / "wal.jsonl"
    with WalWriter(path) as w:
        w.append("admit", rid=0)
    with WalWriter(path) as w:
        assert len(w.recovered) == 1 and w.lsn == 1
        w.append("admit", rid=1)
    records, torn = read_wal(path)
    assert torn is None and [r["lsn"] for r in records] == [0, 1]


def test_wal_detects_corrupted_record(tmp_path):
    path = tmp_path / "wal.jsonl"
    with WalWriter(path) as w:
        for i in range(4):
            w.append("admit", rid=i)
    lines = path.read_text().splitlines()
    lines[2] = lines[2].replace('"rid": 2', '"rid": 99')   # bit flip
    path.write_text("\n".join(lines) + "\n")
    records, torn = read_wal(path)
    assert len(records) == 2                # stops at the bad record
    assert torn is not None and torn["reason"] == "checksum mismatch"
    assert ref_checkpoint.read_wal(path) == (records, torn)


def test_wal_torn_tail_truncated_on_reopen(tmp_path):
    path = tmp_path / "wal.jsonl"
    with WalWriter(path) as w:
        for i in range(3):
            w.append("admit", rid=i)
    tear(path)                              # half of the last line survives
    records, torn = read_wal(path)
    assert len(records) == 2 and torn is not None
    assert torn["reason"] == "unparsable line"
    with WalWriter(path) as w:              # reopen truncates the tail
        assert len(w.recovered) == 2 and w.lsn == 2
        w.append("admit", rid=2)
    records, torn = read_wal(path)
    assert torn is None and len(records) == 3


def test_wal_fsync_every_validation(tmp_path):
    with pytest.raises(ValueError, match="fsync_every"):
        WalWriter(tmp_path / "w.jsonl", fsync_every=0)


# -- snapshots and quarantine ------------------------------------------------

def test_snapshot_round_trip(tmp_path):
    path = tmp_path / "snap.json"
    state = {"now": 1.5, "shares": [0.7, 0.3], "live": [True, False]}
    save_snapshot(path, state)
    assert load_snapshot(path) == state
    assert load_snapshot(tmp_path / "missing.json") is None
    ref_checkpoint.save_snapshot(tmp_path / "ref.json", state)
    assert (tmp_path / "ref.json").read_bytes() == path.read_bytes()


def test_snapshot_corruption_quarantines(tmp_path):
    path = tmp_path / "snap.json"
    save_snapshot(path, {"a": 1})
    raw = path.read_text().replace('"a": 1', '"a": 2')   # checksum now wrong
    path.write_text(raw)
    assert load_snapshot(path) is None
    assert not path.exists()
    quarantined = list(tmp_path.glob("snap.json.corrupt-*"))
    assert len(quarantined) == 1
    assert '"a": 2' in quarantined[0].read_text()        # forensics preserved


def test_quarantine_is_idempotent_per_content(tmp_path):
    p = tmp_path / "f.json"
    p.write_text("garbage")
    dest = quarantine(p, reason="test")
    assert dest.exists() and not p.exists()
    p.write_text("garbage")                 # identical corruption again
    assert quarantine(p, reason="test") == dest
    # the old import paths still name the same objects
    from repro_torch.runtime import simulate, store
    assert store.quarantine is quarantine
    assert simulate.SimulatedCrash is SimulatedCrash


# -- the crash-recovery drill ------------------------------------------------

def _drill_engine(wal, snap, *, resume, observer=None, plan=None,
                  crash_mode="raise", n_requests=80, serve=None, sim=None):
    """The drill's engine; ``serve``/``sim`` pick the reference's modules."""
    serve = serve or port_serve
    sim = sim or port_simulate
    plan = plan if plan is not None else sim.FaultPlan().crash(at=5)
    return serve.make_sim_engine(
        n_requests=n_requests, rate_rps=0.6 * CAP_RPS, seed=7,
        fault_plan=plan, guard=True,
        batcher_config=serve.BatcherConfig(max_batch_rows=16,
                                           coalesce_window_s=0.0),
        wal=str(wal), snapshot=str(snap), resume=resume,
        crash_mode=crash_mode, observer=observer)


def _ref_drill(tmp_path, tag="ref", plan_fn=None):
    """The reference's crash + resume drill: (WAL bytes, snapshot bytes,
    journal events of both runs)."""
    wal, snap = tmp_path / f"{tag}.wal", tmp_path / f"{tag}.snap"
    plan = plan_fn(ref_simulate) if plan_fn else None
    obs = ref_obs.Observer()
    eng = _drill_engine(wal, snap, resume=False, observer=obs, plan=plan,
                        serve=ref_serve, sim=ref_simulate)
    with pytest.raises(ref_checkpoint.SimulatedCrash):
        eng.run()
    obs2 = ref_obs.Observer()
    _drill_engine(wal, snap, resume=True, observer=obs2, plan=plan,
                  serve=ref_serve, sim=ref_simulate).run()
    return wal.read_bytes(), snap.read_bytes(), \
        obs.journal.events + obs2.journal.events


def _wal_accounting(path):
    records, torn = read_wal(path)
    admits, retires, double = set(), {}, []
    for rec in records:
        if rec["kind"] == "admit":
            admits.add(rec["rid"])
        elif rec["kind"] == "retire":
            if rec["rid"] in retires:
                double.append(rec["rid"])
            else:
                retires[rec["rid"]] = rec
    return records, torn, admits, retires, double


def test_crash_drill_accounts_every_admitted_request(tmp_path):
    wal, snap = tmp_path / "wal.jsonl", tmp_path / "snap.json"
    obs1 = Observer()
    eng = _drill_engine(wal, snap, resume=False, observer=obs1)
    with pytest.raises(SimulatedCrash):
        eng.run()
    _, _, admits_pre, retires_pre, _ = _wal_accounting(wal)
    in_flight = len(admits_pre) - len(retires_pre)
    assert in_flight > 0                    # the drill had stakes

    obs = Observer()
    eng2 = _drill_engine(wal, snap, resume=True, observer=obs)
    s = eng2.run()
    assert s["replayed"] == in_flight
    _, torn, admits, retires, double = _wal_accounting(wal)
    assert torn is None
    assert admits == set(retires)           # none lost
    assert double == []                     # none double-retired
    recovered = obs.journal.by_kind("wal_recovered")
    assert len(recovered) == 1
    assert recovered[0]["replayed"] == in_flight
    # every replayed request is journaled with its disposition
    replayed_ev = obs.journal.by_kind("request_replayed")
    assert len(replayed_ev) == in_flight
    assert all(e["disposition"] in
               ("requeued", "queue_full", "degraded", "infeasible")
               for e in replayed_ev)
    # the reference's drill: the same WAL and snapshot bytes, the same
    # journals event for event
    ref_wal, ref_snap, ref_events = _ref_drill(tmp_path)
    assert wal.read_bytes() == ref_wal
    assert snap.read_bytes() == ref_snap
    events = obs1.journal.events + obs.journal.events
    assert [json.dumps(e) for e in events] \
        == [json.dumps(e) for e in ref_events]


def test_crash_drill_is_deterministic(tmp_path):
    """Two identical crash+resume drills leave byte-identical WALs — and
    the reference's drill leaves the same bytes."""
    wals = []
    for i in range(2):
        wal = tmp_path / f"wal{i}.jsonl"
        snap = tmp_path / f"snap{i}.json"
        eng = _drill_engine(wal, snap, resume=False)
        with pytest.raises(SimulatedCrash):
            eng.run()
        _drill_engine(wal, snap, resume=True).run()
        wals.append(wal.read_bytes())
    assert wals[0] == wals[1]
    assert wals[0] == _ref_drill(tmp_path)[0]


def test_torn_write_drill(tmp_path):
    wal, snap = tmp_path / "wal.jsonl", tmp_path / "snap.json"
    plan = FaultPlan().torn(at=4)
    eng = _drill_engine(wal, snap, resume=False, plan=plan)
    with pytest.raises(SimulatedCrash):
        eng.run()
    _, torn = read_wal(wal)
    assert torn is not None                 # the partial record is on disk
    eng2 = _drill_engine(wal, snap, resume=True, plan=plan)
    eng2.run()
    _, torn, admits, retires, double = _wal_accounting(wal)
    assert torn is None                     # reopen truncated the tail
    assert admits == set(retires) and double == []
    ref_wal, _, _ = _ref_drill(tmp_path,
                               plan_fn=lambda sim: sim.FaultPlan().torn(at=4))
    assert wal.read_bytes() == ref_wal


def test_resume_without_wal_raises():
    with pytest.raises(ValueError, match="resume"):
        make_sim_engine(n_requests=4, rate_rps=100.0, resume=True)


def test_replay_marker_in_records(tmp_path):
    """Replayed requests carry ``replayed`` through to their journal
    retirement (the latency-anatomy marker)."""
    wal, snap = tmp_path / "wal.jsonl", tmp_path / "snap.json"
    eng = _drill_engine(wal, snap, resume=False)
    with pytest.raises(SimulatedCrash):
        eng.run()
    obs = Observer()
    eng2 = _drill_engine(wal, snap, resume=True, observer=obs)
    eng2.run()
    retired = obs.journal.by_kind("request_retired")
    assert any(e["replayed"] for e in retired)
    assert any(not e["replayed"] for e in retired)
    marked = [r for r in eng2.done if r.replayed]
    assert len(marked) >= 1
    assert all(r.record()["replayed"] for r in marked)


# -- retry budget across restart ---------------------------------------------

def test_retries_exhausted_exactly_once_across_restart(tmp_path):
    """A request that burned a retry before the crash keeps that count
    through replay: when whole-step failures continue after restart it
    sheds ``retries_exhausted`` with exactly one retire record and one
    journal shed event across both runs — as in the reference, whose WAL
    for the same drill is the same bytes."""
    def rig(serve, sim, wal, snap, resume, obs=None):
        # step 2: both groups fail -> retry (retries=1); step 3: crash;
        # step 4 (first resumed dispatch): the surviving group fails
        # again -> retries exhausted
        plan = (sim.FaultPlan().transient(0, at=2).transient(1, at=2)
                .crash(at=3).transient(1, at=4))
        source = serve.RequestSource(
            n_requests=30, rate_rps=0.3 * CAP_RPS, seed=7,
            classes=(serve.RequestClass("interactive", slo_s=8.0,
                                        priority=1, weight=1.0),))
        return serve.make_sim_engine(
            source=source, n_requests=30, rate_rps=1.0, seed=7,
            fault_plan=plan, guard=False,
            batcher_config=serve.BatcherConfig(max_batch_rows=8,
                                               coalesce_window_s=0.0),
            wal=str(wal), snapshot=str(snap), snapshot_every=1,
            resume=resume, observer=obs)

    serve, sim = port_serve, port_simulate
    wal, snap = tmp_path / "wal.jsonl", tmp_path / "snap.json"
    eng = rig(serve, sim, wal, snap, resume=False)
    with pytest.raises(SimulatedCrash):
        eng.run()
    records, _ = read_wal(wal)
    retried_pre = {r["rid"] for r in records
                   if r["kind"] == "admit" and r["retries"] > 0}
    assert retried_pre                       # the retry happened pre-crash

    obs = Observer()
    s = rig(serve, sim, wal, snap, resume=True, obs=obs).run()
    assert s["shed_reasons"] == {"retries_exhausted": len(retried_pre)}

    records, _, admits, retires, double = _wal_accounting(wal)
    assert double == [] and admits == set(retires)
    exhausted = {rid for rid, r in retires.items()
                 if r.get("reason") == "retries_exhausted"}
    assert exhausted == retried_pre
    for rid in exhausted:
        trail = [r["retries"] for r in records
                 if r["kind"] == "admit" and r["rid"] == rid]
        assert trail == [0, 1]
        assert retires[rid]["retries"] == 1
    shed_ev = [e for e in obs.journal.events if e["kind"] == "request_shed"]
    assert sorted(e["rid"] for e in shed_ev) == sorted(exhausted)
    assert all(e["reason"] == "retries_exhausted" for e in shed_ev)

    ref_wal, ref_snap = tmp_path / "ref.wal", tmp_path / "ref.snap"
    with pytest.raises(ref_checkpoint.SimulatedCrash):
        rig(ref_serve, ref_simulate, ref_wal, ref_snap, resume=False).run()
    assert rig(ref_serve, ref_simulate, ref_wal, ref_snap,
               resume=True).run() == s
    assert ref_wal.read_bytes() == wal.read_bytes()


# -- corrupt stores ----------------------------------------------------------

def _store_with_entry(path):
    from repro_torch.core.space import ConfigSpace, Param
    from repro_torch.tune import TuningSession

    space = ConfigSpace([Param("x", (1, 2, 3, 4))])
    store = TuningStore(path, devices="pinned")
    TuningSession(space, evaluator=lambda c: {"time": abs(c["x"] - 3)},
                  store=store, workload={"w": 1}, device="cpu").run(
        "random", iterations=3, seed=0)
    return space, store


def test_store_survives_truncated_json(tmp_path):
    path = tmp_path / "store.json"
    space, _ = _store_with_entry(path)
    raw = path.read_text()
    path.write_text(raw[:len(raw) // 2])     # torn write
    store2 = TuningStore(path, devices="pinned")
    assert len(store2) == 0                  # fresh start, no crash
    assert list(tmp_path.glob("store.json.corrupt-*"))
    assert store2.lookup(space, {"w": 1}, "random") is None


def test_store_survives_checksum_mismatch(tmp_path):
    path = tmp_path / "store.json"
    _store_with_entry(path)
    body = json.loads(path.read_text())
    assert set(body) == {"checksum", "entries"}   # the checksummed envelope
    body["checksum"] = "0" * 64                   # silent corruption
    path.write_text(json.dumps(body))
    store2 = TuningStore(path, devices="pinned")
    assert len(store2) == 0
    assert list(tmp_path.glob("store.json.corrupt-*"))


def test_store_accepts_legacy_flat_layout(tmp_path):
    path = tmp_path / "store.json"
    space, store = _store_with_entry(path)
    body = json.loads(path.read_text())
    path.write_text(json.dumps(body["entries"]))  # pre-checksum format
    store2 = TuningStore(path, devices="pinned")
    assert len(store2) == len(store)
    assert store2.lookup(space, {"w": 1}, "random") is not None


def test_store_quarantines_corrupt_npz_sidecar(tmp_path):
    path = tmp_path / "store.json"
    store = TuningStore(path, devices="pinned")
    sig = "a" * 32
    npz = store.save_observations(sig, x=np.arange(4.0))
    loaded = store.load_observations(sig)
    assert np.allclose(loaded["x"], np.arange(4.0))
    npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])
    assert store.load_observations(sig) is None   # quarantined, not raised
    assert list(tmp_path.glob(f"{npz.name}.corrupt-*"))
    assert not npz.exists()


def test_store_quarantine_emits_journal_event(tmp_path):
    from repro_torch.obs import configure

    path = tmp_path / "store.json"
    path.write_text("{ torn")
    obs = Observer()
    configure(journal=obs.journal)
    try:
        TuningStore(path, device="cpu")
        events = obs.journal.by_kind("store_quarantined")
        assert len(events) == 1
        assert "tuning store" in events[0]["reason"]
    finally:
        configure(journal=None)


# -- resumable tuning (ledger) -----------------------------------------------

def test_ledger_replays_measured_prefix(tmp_path):
    ledger = MeasurementLedger(tmp_path / "m.jsonl")
    calls = []

    def raw(cfg):
        calls.append(cfg)
        return {"time": float(cfg["x"])}

    ev = ledger.wrap(raw)
    assert ev({"x": 2}) == {"time": 2.0}
    assert ev({"x": 2}) == {"time": 2.0}     # in-process hit
    assert len(calls) == 1
    assert ledger.n_real == 1 and ledger.n_replayed == 1
    ledger.close()
    # a fresh process sees the measurement without re-evaluating
    ledger2 = MeasurementLedger(tmp_path / "m.jsonl")
    ev2 = ledger2.wrap(lambda c: pytest.fail("must not re-measure"))
    assert ev2({"x": 2}) == {"time": 2.0}
    assert ledger2.total_real == 1
    ledger2.close()
    # and so does the reference's ledger (one WAL format)
    ref = ref_checkpoint.MeasurementLedger(tmp_path / "m.jsonl")
    assert ref.lookup({"x": 2}) == {"time": 2.0}
    ref.close()


def test_crashed_tune_resumes_within_budget(tmp_path):
    """Crash mid-search; the ledger-resumed run spends <= 1.1x the
    single-run measurement budget and lands on the same winner."""
    from repro_torch.core.space import ConfigSpace, Param
    from repro_torch.tune import TuningSession

    space = ConfigSpace([Param("chunk", (8, 16, 32, 64)),
                         Param("fraction", tuple(range(10, 100, 10)))])

    def raw(cfg):
        return {"time": abs(cfg["fraction"] / 100.0 - 0.7)
                + 0.02 * abs(cfg["chunk"] - 32) / 32.0}

    ref_ledger = MeasurementLedger(tmp_path / "ref.jsonl")
    ref = TuningSession(space, evaluator=raw, ledger=ref_ledger,
                        device="cpu").run("sam", iterations=20, seed=13)
    budget = ref_ledger.total_real
    ref_ledger.close()

    n = {"calls": 0}

    def crashing(cfg):
        if n["calls"] >= 5:
            raise SimulatedCrash("injected")
        n["calls"] += 1
        return raw(cfg)

    ledger = MeasurementLedger(tmp_path / "m.jsonl")
    with pytest.raises(SimulatedCrash):
        TuningSession(space, evaluator=crashing, ledger=ledger,
                      device="cpu").run("sam", iterations=20, seed=13)
    ledger.close()

    ledger2 = MeasurementLedger(tmp_path / "m.jsonl")
    result = TuningSession(space, evaluator=raw, ledger=ledger2,
                           device="cpu").run("sam", iterations=20, seed=13)
    assert ledger2.n_replayed >= 5           # the prefix came from the WAL
    assert ledger2.total_real <= 1.1 * budget
    assert result.best_config == ref.best_config
    ledger2.close()
    # the reference's ledger-backed session measures the same points in
    # the same order: its single run's ledger holds the same bytes
    from repro.core.space import ConfigSpace as RefSpace, Param as RefParam
    from repro.tune import TuningSession as RefSession

    ref_space = RefSpace([RefParam("chunk", (8, 16, 32, 64)),
                          RefParam("fraction", tuple(range(10, 100, 10)))])
    theirs = ref_checkpoint.MeasurementLedger(tmp_path / "theirs.jsonl")
    RefSession(ref_space, evaluator=raw, ledger=theirs).run(
        "sam", iterations=20, seed=13)
    theirs.close()
    assert (tmp_path / "theirs.jsonl").read_bytes() \
        == (tmp_path / "ref.jsonl").read_bytes()


# -- journal durability ------------------------------------------------------

def test_journal_sink_stream_matches_save(tmp_path):
    from repro_torch.obs.journal import Journal

    streamed = tmp_path / "streamed.jsonl"
    with open(streamed, "w") as sink:
        j = Journal(sink=sink, flush_every=2)
        for i in range(5):
            j.event("log", i=i)
    saved = j.save(tmp_path / "saved.jsonl")
    assert streamed.read_bytes() == saved.read_bytes()


def test_journal_flush_every_validation():
    from repro_torch.obs.journal import Journal

    with pytest.raises(ValueError, match="flush_every"):
        Journal(flush_every=0)


# -- fault-plan surface ------------------------------------------------------

def test_parse_fault_plan_process_kinds():
    plan = parse_fault_plan("crash:0@8,torn:0@3")
    kinds = sorted((e.kind, e.step) for e in plan.events)
    assert kinds == [("crash", 8), ("torn", 3)]


def test_crash_does_not_refire_after_fast_forward():
    from repro_torch.runtime.simulate import FaultInjector, sim_skew_groups

    plan = FaultPlan().crash(at=2)
    inj = FaultInjector(plan, sim_skew_groups(3))
    inj.fast_forward(3)                      # steps 0..2: the crash is spent
    for _ in range(4):
        inj.tick()                           # passes step 2 without dying


# -- obs CLI: WAL validation -------------------------------------------------

def test_check_wal_clean_and_complete(tmp_path):
    wal = tmp_path / "wal.jsonl"
    with WalWriter(wal) as w:
        w.append("admit", rid=0, rows=1)
        w.append("retire", rid=0, status="completed")
    errors, stats = check_wal(wal, complete=True)
    assert errors == []
    assert stats == {"records": 2, "admitted": 1, "retired": 1,
                     "torn": False}


def test_check_wal_flags_lost_and_double(tmp_path):
    wal = tmp_path / "wal.jsonl"
    with WalWriter(wal) as w:
        w.append("admit", rid=0, rows=1)
        w.append("admit", rid=1, rows=1)
        w.append("retire", rid=0, status="completed")
        w.append("retire", rid=0, status="completed")
    errors, _ = check_wal(wal, complete=True)
    assert any("retired twice" in e for e in errors)
    assert any("never retired" in e for e in errors)


# -- the real thing: subprocess SIGKILL drill --------------------------------

_DRILL_CODE = """
import sys
from repro_torch.runtime.simulate import FaultPlan
from repro_torch.serve import BatcherConfig, make_sim_engine

CAP_RPS = (4 + 4 / 3) / 4e-4 / 2.1
eng = make_sim_engine(
    n_requests=80, rate_rps=0.6 * CAP_RPS, seed=7,
    fault_plan=FaultPlan().crash(at=5), guard=True,
    batcher_config=BatcherConfig(max_batch_rows=16, coalesce_window_s=0.0),
    wal=sys.argv[1], snapshot=sys.argv[2], resume=(sys.argv[3] == "resume"),
    crash_mode="sigkill")
s = eng.run()
print("completed", s["completed"], "replayed", s["replayed"])
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{SRC}:{env.get('PYTHONPATH', '')}"
    return env


def _run_drill(wal, snap, mode):
    return subprocess.run(
        [sys.executable, "-c", _DRILL_CODE, str(wal), str(snap), mode],
        env=_env(), capture_output=True, text=True, timeout=300)


def test_subprocess_sigkill_drill(tmp_path):
    """A real ``SIGKILL`` mid-run: the on-disk WAL matches the simulated
    crash byte for byte (the port's and the reference's), and the
    restarted process closes the accounting with zero lost / zero
    double-retired requests."""
    wal, snap = tmp_path / "wal.jsonl", tmp_path / "snap.json"
    proc = _run_drill(wal, snap, "fresh")
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert "jax" not in proc.stderr

    sim_wal = tmp_path / "sim_wal.jsonl"
    sim = _drill_engine(sim_wal, tmp_path / "sim_snap.json", resume=False)
    with pytest.raises(SimulatedCrash):
        sim.run()
    assert wal.read_bytes() == sim_wal.read_bytes()
    ref_wal = tmp_path / "ref_wal.jsonl"
    ref = _drill_engine(ref_wal, tmp_path / "ref_snap.json", resume=False,
                        serve=ref_serve, sim=ref_simulate)
    with pytest.raises(ref_checkpoint.SimulatedCrash):
        ref.run()
    assert wal.read_bytes() == ref_wal.read_bytes()

    proc2 = _run_drill(wal, snap, "resume")
    assert proc2.returncode == 0, proc2.stderr[-2000:]
    assert "replayed" in proc2.stdout
    _, torn, admits, retires, double = _wal_accounting(wal)
    assert torn is None
    assert admits == set(retires) and double == []
    errors, stats = check_wal(wal, complete=True)
    assert errors == [], errors
    assert stats["admitted"] == stats["retired"]


@pytest.mark.parametrize("kill", ["raise", "sigkill"])
def test_cli_crash_drill_then_resume(tmp_path, kill):
    """The serving CLI's drill: a scripted crash (exit code 17, or a real
    SIGKILL), then the same command with ``--resume``; every admitted rid
    retires exactly once across both runs (``python -m repro_torch.obs
    --wal --wal-complete``), and the streamed journal of the crashed run
    is on disk up to the crash."""
    wal, snap = tmp_path / "wal.jsonl", tmp_path / "snap.json"
    journal = tmp_path / "journal.jsonl"
    args = ["--serve-requests", "120", "--request-rate", "3000",
            "--fault-plan", "crash:0@5", "--wal", str(wal),
            "--snapshot", str(snap)]
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    first = subprocess.run(
        cmd + (["--crash-sigkill"] if kill == "sigkill" else [])
        + ["--journal-out", str(journal)],
        env=_env(), capture_output=True, text=True, timeout=300)
    want = -signal.SIGKILL if kill == "sigkill" else 17
    assert first.returncode == want, first.stderr[-2000:]
    streamed = [json.loads(line) for line in journal.read_text().splitlines()]
    assert any(e["kind"] == "request_admitted" for e in streamed)
    _, _, admits_pre, retires_pre, _ = _wal_accounting(wal)
    assert len(admits_pre) > len(retires_pre)      # requests in flight

    second = subprocess.run(cmd + ["--resume"], env=_env(),
                            capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    check = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--wal", str(wal),
         "--wal-complete"], env=_env(), capture_output=True, text=True,
        timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
    _, torn, admits, retires, double = _wal_accounting(wal)
    assert torn is None and double == [] and admits == set(retires)
