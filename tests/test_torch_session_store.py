"""repro_torch TuningSession + TuningStore held against ``repro``.

Signatures and store files are compared exactly (hashes, JSON): a store
written by either package must load in the other.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core.space import ConfigSpace as RefSpace, Param as RefParam
from repro.runtime import store as ref_store
from repro.tune import TuneResult as RefResult, TuningSession as RefSession
from repro_torch.core.space import ConfigSpace, Param
from repro_torch.runtime import store as port_store
from repro_torch.runtime.store import TuningStore, quarantine
from repro_torch.tune import Energy, TuneResult, TuningSession, Weighted


def make_space(space_cls=ConfigSpace, param_cls=Param):
    return space_cls([param_cls("x", tuple(range(8))),
                      param_cls("y", (1, 2, 4, 8)),
                      param_cls("mode", ("a", "b"), ordinal=False)])


def measure(cfg):
    return 1.0 + (cfg["x"] - 5) ** 2 + abs(cfg["y"] - 4) + (cfg["mode"] == "a")


WORKLOAD = {"kernel": "toy", "shape": {"t": 4096, "s": 7}, "dtype": "uint8"}


# -- the session ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["observer", "ledger", "online"])
def test_unported_hooks_raise_instead_of_being_ignored(name):
    with pytest.raises(NotImplementedError, match="not ported"):
        TuningSession(make_space(), evaluator=measure, device="cpu",
                      **{name: object()})
    TuningSession(make_space(), evaluator=measure, device="cpu",
                  **{name: None})


def test_session_signature_keeps_the_reference_parameters():
    import inspect

    ref = list(inspect.signature(RefSession.__init__).parameters)
    port = list(inspect.signature(TuningSession.__init__).parameters)
    assert port[:len(ref)] == ref and port[len(ref):] == ["device"]


def test_result_record_has_the_reference_fields():
    assert ([f.name for f in dataclasses.fields(TuneResult)]
            == [f.name for f in dataclasses.fields(RefResult)])
    r = TuneResult("X", {}, 1.0, 2.0, 3, 0, 0, 0)
    assert r.experiments_fraction == 0.0
    assert r.best_score_search == 1.0 and r.best_score_measured == 2.0


def test_session_store_round_trip_and_objective_keys(tmp_path):
    path = tmp_path / "store.json"
    kw = dict(evaluator=measure, workload=WORKLOAD, device="cpu")
    first = TuningSession(make_space(), store=path, **kw).run(
        "sam", iterations=60, seed=2)
    assert not first.from_cache and first.n_experiments > 0
    again = TuningSession(make_space(), store=path, **kw).run(
        "sam", iterations=60, seed=2)
    assert again.from_cache and again.best_config == first.best_config
    assert again.checkpoints == first.checkpoints
    # another strategy, workload or objective is another entry
    assert not TuningSession(make_space(), store=path, **kw).run(
        "random", samples=5).from_cache
    other = dict(kw, workload=dict(WORKLOAD, dtype="int8"))
    assert not TuningSession(make_space(), store=path, **other).run(
        "sam", iterations=5).from_cache

    def metrics(cfg):
        return {"time": measure(cfg), "energy": 10.0 * cfg["y"]}
    weighted = TuningSession(
        make_space(), store=path, evaluator=metrics, workload=WORKLOAD,
        objective=Weighted(Energy()), device="cpu").run("sam", iterations=5)
    assert not weighted.from_cache and weighted.objective == "weighted(energy*1)"
    assert set(weighted.best_metrics) == {"time", "energy"}


def test_session_seed_warm_start_and_truth():
    space = make_space()
    a = TuningSession(space, evaluator=measure, seed=9, device="cpu").run(
        "random", samples=10)
    b = TuningSession(space, evaluator=measure, device="cpu").run(
        "random", samples=10, seed=9)
    assert a.best_config == b.best_config
    warm = {"x": 5, "y": 4, "mode": "b"}
    res = TuningSession(space, evaluator=measure, warm_start=warm,
                        truth=lambda c: 2 * measure(c), device="cpu").run(
        "hillclimb", iterations=5)
    assert res.best_config == warm and res.best_energy_measured == 2.0
    with pytest.raises(ValueError):
        TuningSession(space, evaluator=measure, device="cpu",
                      warm_start={"x": 99, "y": 4, "mode": "b"})
    with pytest.raises(TypeError):
        TuningSession(space, evaluator=3, device="cpu")


def test_n_measured_comes_from_the_oracle_when_it_keeps_one():
    class Oracle:
        n_measured = 0

        def __call__(self, cfg):
            Oracle.n_measured += 1
            return measure(cfg)

    res = TuningSession(make_space(), evaluator=Oracle(), device="cpu").run(
        "random", samples=6, seed=0)
    assert res.n_measured == Oracle.n_measured


# -- the store: signatures ---------------------------------------------------------

def test_canon_sha_and_fingerprint_equal_reference():
    payloads = [WORKLOAD, {"b": (1, 2), "a": [np.int64(3), np.float32(0.5)]},
                {"s": {3, 1, 2}, "arr": np.arange(4)}, None, object]
    for p in payloads:
        assert port_store._canon(p) == ref_store._canon(p)
    assert port_store._sha(WORKLOAD) == ref_store._sha(WORKLOAD)
    assert (port_store.space_fingerprint(make_space())
            == ref_store.space_fingerprint(make_space(RefSpace, RefParam)))
    assert (port_store.workload_signature(make_space(), WORKLOAD, devices="pin")
            == ref_store.workload_signature(make_space(RefSpace, RefParam),
                                            WORKLOAD, devices="pin"))


def test_device_topology_keeps_cpu_and_card_records_apart():
    assert port_store.device_topology("cpu") == [["cpu", "", 1]]
    sig_cpu = port_store.workload_signature(make_space(), WORKLOAD, device="cpu")
    sig_gpu = port_store.workload_signature(
        make_space(), WORKLOAD, devices=[["gpu", "NVIDIA H100 80GB HBM3", 1]])
    assert sig_cpu != sig_gpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_store.device_topology()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TuningStore("unused.json").signature(make_space(), WORKLOAD)


# -- the store: files ----------------------------------------------------------------

def sample_result(cls=TuneResult, score=1.5):
    return cls(strategy="SAM", best_config={"x": 5, "y": 4, "mode": "b"},
               best_energy_search=score, best_energy_measured=score,
               n_experiments=12, n_predictions=0, n_training_experiments=0,
               space_size=64, checkpoints={10: (2.0, {"x": 4, "y": 4,
                                                      "mode": "b"})},
               n_measured=11)


def test_store_written_by_the_reference_loads_in_the_port(tmp_path):
    path = tmp_path / "ref.json"
    ref = ref_store.TuningStore(path, devices="pinned")
    ref.record(make_space(RefSpace, RefParam), WORKLOAD, "sam",
               sample_result(RefResult))
    port = TuningStore(path, devices="pinned")
    hit = port.lookup(make_space(), WORKLOAD, "SAM")
    assert isinstance(hit, TuneResult) and hit.from_cache
    want = dataclasses.asdict(sample_result())
    assert dataclasses.asdict(hit) == dict(want, from_cache=True)
    assert port.best_record(make_space(), WORKLOAD).best_config == want["best_config"]
    assert port.lookup(make_space(), WORKLOAD, "RANDOM") is None
    assert port.lookup(make_space(), dict(WORKLOAD, dtype="f"), "SAM") is None


def test_store_written_by_the_port_loads_in_the_reference(tmp_path):
    path = tmp_path / "port.json"
    port = TuningStore(path, devices="pinned")
    sig = port.record(make_space(), WORKLOAD, "sam", sample_result())
    assert len(port) == 1
    ref = ref_store.TuningStore(path, devices="pinned")
    hit = ref.lookup(make_space(RefSpace, RefParam), WORKLOAD, "SAM")
    assert hit is not None and hit.best_config == sample_result().best_config
    assert ref.signature(make_space(RefSpace, RefParam), WORKLOAD) == sig
    envelope = json.loads(path.read_text())
    assert set(envelope) == {"checksum", "entries"}
    assert envelope["checksum"] == ref_store._sha(envelope["entries"])


def test_best_record_is_the_lowest_measured_score(tmp_path):
    store = TuningStore(tmp_path / "s.json", devices="pinned")
    assert store.best_record(make_space(), WORKLOAD) is None
    store.record(make_space(), WORKLOAD, "sam", sample_result(score=3.0))
    store.record(make_space(), WORKLOAD, "random", sample_result(score=2.0))
    assert store.best_record(make_space(), WORKLOAD).best_energy_measured == 2.0


@pytest.mark.parametrize("damage", ["truncate", "checksum", "not_object",
                                    "entries_not_object", "binary"])
def test_corrupt_store_is_quarantined_not_fatal(tmp_path, damage):
    path = tmp_path / "s.json"
    TuningStore(path, devices="pinned").record(
        make_space(), WORKLOAD, "sam", sample_result())
    text = path.read_text()
    if damage == "truncate":
        path.write_text(text[:len(text) // 2])
    elif damage == "checksum":
        path.write_text(text.replace('"n_experiments": 12', '"n_experiments": 13'))
    elif damage == "not_object":
        path.write_text("[1, 2]")
    elif damage == "entries_not_object":
        path.write_text(json.dumps({"checksum": "x", "entries": [1]}))
    else:
        path.write_bytes(b"\xff\xfe\x00garbage")
    store = TuningStore(path, devices="pinned")
    assert len(store) == 0 and not path.exists()
    moved = list(tmp_path.glob("s.json.corrupt-*"))
    assert len(moved) == 1
    store.record(make_space(), WORKLOAD, "sam", sample_result())
    assert len(TuningStore(path, devices="pinned")) == 1


def test_quarantine_names_by_content(tmp_path):
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    a.write_bytes(b"one")
    b.write_bytes(b"one")
    da, db = quarantine(a, "test"), quarantine(b, "test")
    assert da.name.split("-")[-1] == db.name.split("-")[-1]
    assert not a.exists() and da.exists()


def test_legacy_flat_layout_still_loads(tmp_path):
    path = tmp_path / "s.json"
    TuningStore(path, devices="pinned").record(
        make_space(), WORKLOAD, "sam", sample_result())
    path.write_text(json.dumps(json.loads(path.read_text())["entries"]))
    assert TuningStore(path, devices="pinned").lookup(
        make_space(), WORKLOAD, "sam") is not None


def test_observation_side_car_round_trip_and_corruption(tmp_path):
    store = TuningStore(tmp_path / "s.json", devices="pinned")
    sig = store.signature(make_space(), WORKLOAD)
    assert store.load_observations(sig) is None
    out = store.save_observations(sig, X=np.arange(6).reshape(3, 2), y=[1.0, 2.0])
    got = store.load_observations(sig)
    np.testing.assert_array_equal(got["X"], np.arange(6).reshape(3, 2))
    np.testing.assert_array_equal(got["y"], [1.0, 2.0])
    out.write_bytes(b"not a zip")
    assert store.load_observations(sig) is None
    assert list(tmp_path.glob("*.npz.corrupt-*"))
