"""repro_torch.tune.kernels: registry, timed parity evaluator, cache
round-trips (0 measurements on repeat), graceful fallback when the store
has no entry — the port's twin of ``tests/test_kernel_tuning.py``, on
``device="cpu"`` (the kernels' plain versions) with exact integer parity.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.tune.kernels import kernel_workload as ref_kernel_workload
from repro_torch.core.space import ConfigSpace, Param
from repro_torch.kernels import KernelLaunchError
from repro_torch.kernels.dna_automaton import ops as dna_ops
from repro_torch.runtime.store import TuningStore
from repro_torch.tune import kernels as ktune
from repro_torch.tune.kernels import KernelTimer
from repro_torch.tune.kernels.specs import BLOCK_THREADS, GRAMS, TEXT_CHUNKS


@pytest.fixture
def tuned_path_disabled():
    """Ensure the global tuned-path state never leaks across tests."""
    yield
    ktune.disable()


def smoke_timer(**kw):
    spec = ktune.get_kernel("dna_automaton")
    return spec, KernelTimer(spec, spec.smoke_shape, "uint8", device="cpu",
                             repeats=1, **kw)


def smoke_default(spec):
    """The spec's default at the smoke shape: the nearest valid point
    where the hardcoded defaults exceed the smoke text (the timer's own
    notion of the default)."""
    return spec.default_config(spec.space(spec.smoke_shape), spec.smoke_shape)


# -- registry ------------------------------------------------------------------------

def test_dna_space_is_redrawn_for_the_card():
    spec = ktune.get_kernel("dna_automaton")
    assert ktune.list_kernels() == ["decode_attention", "dna_automaton",
                                   "flash_attention", "mamba_scan",
                                   "mamba_scan_bwd", "rwkv6_wkv",
                                   "rwkv6_wkv_bwd"]
    space = spec.space(spec.default_shape)
    assert space.names == ("map_chunk", "count_chunk", "block_threads",
                           "gram")
    assert 64 <= space.size() == 441 <= 500
    assert space["block_threads"].values == BLOCK_THREADS == (64, 128, 256)
    assert space["map_chunk"].values == TEXT_CHUNKS
    assert space["gram"].values == GRAMS == (1, 2, 4)
    valid = [c for c in space.enumerate()
             if spec.validate(c, spec.default_shape) is None]
    assert len(valid) >= 64
    assert all(p.ordinal for p in space.params)
    assert spec.default_shape == {"t": 3 * 2 ** 30, "s": 7}
    assert spec.smoke_shape == {"t": 4096, "s": 7}
    assert dict(spec.defaults) == dna_ops.DEFAULTS
    assert spec.validate(dna_ops.DEFAULTS, spec.default_shape) is None
    assert (spec.atol, spec.rtol) == (0.0, 0.0)
    assert ktune.SMEM_LIMIT_BYTES == 232448


@pytest.mark.parametrize("name, meta", [
    # B4 at the decode shapes served: Qwen2.5-3B, Jamba's attention layer,
    # phi3-mini (batch 8, cache 2176)
    ("decode_attention", {"b": 8, "kv": 2, "rep": 8, "hd": 128, "s": 2176}),
    ("decode_attention", {"b": 8, "kv": 8, "rep": 4, "hd": 128, "s": 2176}),
    ("decode_attention", {"b": 8, "kv": 32, "rep": 1, "hd": 96, "s": 2176}),
    # B9 at RWKV-6 1.6B's training shape and the smoke shape's head size
    ("rwkv6_wkv_bwd", {"b": 8, "t": 2048, "h": 32, "hd": 64}),
    ("rwkv6_wkv_bwd", {"b": 1, "t": 64, "h": 1, "hd": 16}),
])
def test_redesigned_spaces_hold_their_defaults(name, meta):
    """The spaces redrawn for the one-launch decode kernel and the chunked
    wkv backward keep >= 64 valid points and shared-memory refusals, under
    the reference's meta keys, and the ops' defaults are valid points
    there."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    spec = ktune.get_kernel(name)
    assert set(meta) == set(spec.default_shape)
    space = spec.space(meta)
    reasons = [spec.validate(c, meta) for c in space.enumerate()]
    assert sum(r is None for r in reasons) >= 64
    defaults = (da_ops.DEFAULTS if name == "decode_attention"
                else wkv_ops.BWD_DEFAULTS)
    assert spec.validate(dict(defaults), meta) is None
    assert ktune.kernel_workload(name, meta, spec.dtype) == \
        ref_kernel_workload(name, meta, spec.dtype)
    if meta.get("hd") in (64, 128):
        assert any("shared-memory" in (r or "") for r in reasons)


@pytest.mark.parametrize("shape", ["smoke_shape", "default_shape"])
def test_space_has_valid_default_and_invalid_candidates(shape):
    spec = ktune.get_kernel("dna_automaton")
    meta = getattr(spec, shape)
    space = spec.space(meta)
    default = spec.default_config(space, meta)
    assert spec.validate(default, meta) is None
    invalid = [c for c in space.enumerate() if spec.validate(c, meta)]
    assert invalid and len(invalid) < space.size()
    reasons = {spec.validate(c, meta).split("=")[0] for c in invalid}
    assert "count_chunk" in reasons or "map_chunk" in reasons


def test_default_config_moves_to_nearest_valid_point():
    spec = ktune.get_kernel("dna_automaton")
    meta = {"t": 1024, "s": 7}               # the defaults exceed the text
    cfg = spec.default_config(spec.space(meta), meta)
    assert spec.validate(cfg, meta) is None
    assert cfg == dict(dna_ops.DEFAULTS, map_chunk=1024, count_chunk=1024)
    with pytest.raises(ValueError, match="no valid config"):
        spec.default_config(spec.space({"t": 100, "s": 7}), {"t": 100, "s": 7})


def test_validation_reasons():
    spec = ktune.get_kernel("dna_automaton")
    meta = spec.smoke_shape
    ok = {"map_chunk": 1024, "count_chunk": 2048, "block_threads": 128,
          "gram": 4}
    assert spec.validate(ok, meta) is None
    assert "exceeds" in spec.validate(dict(ok, map_chunk=8192), meta)
    assert "not a multiple" in spec.validate(
        dict(ok, map_chunk=2048, count_chunk=1024), meta)
    assert "does not divide" in spec.validate(ok, {"t": 4096 + 1024 * 3,
                                                   "s": 7})
    assert "16-byte copies" in spec.validate(
        dict(ok, map_chunk=1000, count_chunk=2000), {"t": 4000, "s": 7})
    assert "states above" in spec.validate(ok, {"t": 4096, "s": 4000})
    # 512 threads: 16 warps' rings of text slots pass the shared memory
    assert "shared-memory" in spec.validate(
        dict(ok, block_threads=512), meta)


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        ktune.get_kernel("nope")


@pytest.mark.parametrize("dtype", ["uint8", np.uint8, np.dtype("uint8"),
                                   torch.uint8])
def test_kernel_workload_spells_dtype_like_the_reference(dtype):
    meta = {"t": 4096, "s": 7}
    got = ktune.kernel_workload("dna_automaton", meta, dtype)
    assert got["dtype"] == "uint8"
    assert got == ref_kernel_workload("dna_automaton", meta, "uint8")


# -- timed parity evaluator ----------------------------------------------------------

def test_default_and_random_config_parity():
    spec, timer = smoke_timer(seed=0)
    space = spec.space(spec.smoke_shape)
    assert np.isfinite(timer(spec.default_config(space, spec.smoke_shape)))
    rng = np.random.default_rng(1)
    n = 0
    for _ in range(200):
        cfg = space.random(rng)
        if spec.validate(cfg, spec.smoke_shape) is None:
            assert np.isfinite(timer(cfg)), cfg
            n += 1
            if n == 3:
                break
    assert n == 3 and timer.n_launch_failed == 0


def test_timer_inputs_share_the_reference_numpy_stream():
    _, timer = smoke_timer(seed=5)
    text, table, accept = timer.inputs
    want = np.random.default_rng(5).integers(0, 4, 4096).astype(np.uint8)
    np.testing.assert_array_equal(text.numpy(), want)
    assert text.dtype == torch.uint8 and table.dtype == accept.dtype == torch.int32
    assert (timer.atol, timer.rtol) == (0.0, 0.0)   # exact, also for uint8


def test_invalid_config_scores_inf_without_measuring():
    _, timer = smoke_timer()
    bad = {"map_chunk": 8192, "count_chunk": 8192, "block_threads": 256,
           "gram": 4}
    assert timer(bad) == float("inf")
    assert timer.n_measured == 0
    assert "exceed" in next(iter(timer.rejected.values()))


def test_measurements_deduplicate():
    spec, timer = smoke_timer()
    cfg = smoke_default(spec)
    first = timer(cfg)
    assert timer(dict(cfg)) == first and timer.n_measured == 1


def with_run(spec, run):
    return dataclasses.replace(spec, run=run)


def test_only_a_refused_launch_scores_inf(monkeypatch):
    spec = ktune.get_kernel("dna_automaton")
    cfg = smoke_default(spec)

    def refused(cfg, inputs):
        raise KernelLaunchError("too many resources requested for launch")

    timer = KernelTimer(with_run(spec, refused), spec.smoke_shape, "uint8",
                        device="cpu", repeats=1)
    assert timer(cfg) == float("inf")
    assert timer.n_launch_failed == 1 and timer.n_measured == 0
    assert "launch failed" in next(iter(timer.rejected.values()))

    def faulted(cfg, inputs):
        raise RuntimeError("CUDA error: an illegal memory access")

    timer = KernelTimer(with_run(spec, faulted), spec.smoke_shape, "uint8",
                        device="cpu", repeats=1)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        timer(cfg)
    assert timer.n_launch_failed == 0


def test_parity_failure_is_fatal_at_the_default_only():
    spec = ktune.get_kernel("dna_automaton")

    def wrong(cfg, inputs):
        return spec.run(cfg, inputs) + 1

    timer = KernelTimer(with_run(spec, wrong), spec.smoke_shape, "uint8",
                        device="cpu", repeats=1)
    other = {"map_chunk": 1024, "count_chunk": 1024, "block_threads": 128,
             "gram": 2}
    assert timer(other) == float("inf") and timer.n_measured == 0
    assert "parity" in next(iter(timer.rejected.values()))
    with pytest.raises(RuntimeError, match="default configuration"):
        timer(smoke_default(spec))


@pytest.mark.parametrize("probe_s, calls", [
    (1e-4, 10),            # a decode-sized call: a batch of >= 1 ms
    (3e-4, 4),
    (1.2e-2, 1),           # a DNA/prefill-sized call is its own batch
    (1e-8, 1000),          # capped
])
def test_card_timer_times_batches_of_back_to_back_calls(monkeypatch, probe_s,
                                                        calls):
    """One call of a few short launches timed alone measures the host's
    launch gaps; on the card each repeat is a batch of about MIN_BATCH_S,
    sized from one probe call that also measures the host's enqueue time
    (the spin that holds the card while the host enqueues the batch), and
    the score is the best per-call mean."""
    from repro_torch.tune.kernels import evaluate

    spec, timer = smoke_timer()
    timer.repeats = 3
    batches = []

    def device_seconds(fn, n, host_s):
        batches.append((n, host_s))
        return probe_s * (1 + len(batches))

    monkeypatch.setattr(evaluate, "probe_seconds",
                        lambda fn, device: (7e-5, probe_s))
    monkeypatch.setattr(evaluate, "device_seconds", device_seconds)
    monkeypatch.setattr(timer, "device", torch.device("cuda"))
    monkeypatch.setattr(timer, "_sync", lambda: None)
    assert evaluate.MIN_BATCH_S == 1e-3 and evaluate.MAX_BATCH == 1000
    assert timer(smoke_default(spec)) == pytest.approx(2 * probe_s)
    assert batches == [(calls, 7e-5)] * 3 and timer.n_measured == 1


def test_host_timer_times_single_calls():
    spec = ktune.get_kernel("dna_automaton")
    runs = []

    def counted(cfg, inputs):
        runs.append(1)
        return spec.run(cfg, inputs)

    timer = KernelTimer(with_run(spec, counted), spec.smoke_shape, "uint8",
                        device="cpu", repeats=3)
    assert 0 < timer(smoke_default(spec)) < float("inf")
    assert len(runs) == 1 + 3          # warm + one call per repeat


def test_timer_observer_is_not_silently_ignored():
    from repro_torch.obs import Observer

    spec = ktune.get_kernel("dna_automaton")
    obs = Observer()
    timer = KernelTimer(spec, spec.smoke_shape, "uint8", device="cpu",
                        repeats=1, observer=obs)
    cfg = smoke_default(spec)
    assert timer(cfg) == timer(cfg) < float("inf")
    counters = obs.metrics.to_dict()["counters"]
    assert counters["kernel.dna_automaton.measured"] == 1
    assert counters["kernel.dna_automaton.cache_hits"] == 1
    assert [e["name"] for e in obs.tracer.events] == [
        "measure.dna_automaton"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KernelTimer(spec, spec.smoke_shape, "uint8")


# -- tune + cache round trip -----------------------------------------------------------

def tune(store, **kw):
    kw = {"strategy": "random", "iterations": 3, "smoke": True, "repeats": 1,
          "seed": 0, "device": "cpu", **kw}
    return ktune.tune_kernel("dna_automaton", store=store, **kw)


def test_cache_round_trip_zero_measurements(tmp_path):
    store = TuningStore(tmp_path / "kernels.json", devices="pinned")
    first = tune(store)
    assert first.n_measured > 0 and not first.result.from_cache
    again = tune(store)
    assert again.result.from_cache
    assert again.n_measured == 0                 # the acceptance bar
    assert again.best_config == first.best_config


def test_saml_tunes_within_budget(tmp_path):
    store = TuningStore(tmp_path / "kernels.json", devices="pinned")
    out = tune(store, strategy="saml", iterations=60)
    spec = ktune.get_kernel("dna_automaton")
    assert spec.validate(out.best_config, out.shape) is None
    assert np.isfinite(out.best_time())
    assert out.n_measured <= 25 and out.measured_fraction <= 0.05
    assert out.result.n_training_experiments > 0
    assert out.timer.n_launch_failed == 0
    assert out.best_time() <= out.default_time()
    assert out.dtype == "uint8" and out.shape == {"t": 4096, "s": 7}


def test_tune_keeps_the_fastest_measured_point_over_a_wrong_pick(
        tmp_path, monkeypatch):
    """A surrogate that ranks wrongly (it steers the search to a point the
    timer finds ten times slower than the default) must not be what the
    tune returns or stores: the outcome and the store record hold the
    fastest point measured, here the default, the training sample's best
    and so the warm start."""
    from repro_torch.tune.kernels import tuner

    spec = ktune.get_kernel("dna_automaton")
    meta = spec.smoke_shape
    space = spec.space(meta)
    default = spec.default_config(space, meta)
    valid = [c for c in space.enumerate() if spec.validate(c, meta) is None]
    trap = max(valid, key=lambda c: float(np.abs(
        space.encode(c) - space.encode(default)).sum()))
    trap_x = space.encode(trap)

    def fake_measure(self, cfg, key):
        self.n_measured += 1
        return 0.1 if cfg == default else 1.0 if cfg == trap else 0.5

    class WrongModel:
        def __init__(self, **kw):
            pass

        def fit(self, X, y):
            return self

        def predict(self, X):          # the trap predicts fastest
            return np.abs(np.asarray(X) - trap_x).sum(axis=1)

    picks = []
    run = tuner.TuningSession.run

    def spy(self, *args, **kw):
        result = run(self, *args, **kw)
        picks.append(dict(result.best_config))
        return result

    monkeypatch.setattr(KernelTimer, "_measure", fake_measure)
    monkeypatch.setattr(tuner, "BoostedTreesRegressor", WrongModel)
    monkeypatch.setattr(tuner.TuningSession, "run", spy)
    path = tmp_path / "kernels.json"
    out = tune(TuningStore(path, devices="pinned"), strategy="saml",
               iterations=200)
    assert picks == [trap]                       # the search was misled
    assert out.best_config == default and out.best_source == "warm_start"
    assert out.best_time() == 0.1 == out.result.best_metrics["time"]
    workload = ktune.kernel_workload("dna_automaton", meta, "uint8")
    stored = TuningStore(path, devices="pinned").lookup(space, workload,
                                                        "SAML")
    assert stored.best_config == default
    assert stored.best_energy_measured == 0.1
    again = tune(TuningStore(path, devices="pinned"), strategy="saml",
                 iterations=200)
    assert again.result.from_cache and again.best_source == "cache"
    assert again.best_config == default


def test_too_few_valid_measurements_raises(tmp_path):
    with pytest.raises(ValueError, match="too few valid"):
        ktune.tune_kernel("dna_automaton", {"t": 1024}, device="cpu",
                          n_train=1, repeats=1)


def test_best_record_spans_strategies(tmp_path):
    store = TuningStore(tmp_path / "kernels.json", devices="pinned")
    tune(store, iterations=2)
    tune(store, strategy="hillclimb", iterations=2, seed=1)
    spec = ktune.get_kernel("dna_automaton")
    space = spec.space(spec.smoke_shape)
    workload = ktune.kernel_workload("dna_automaton", spec.smoke_shape, "uint8")
    best = store.best_record(space, workload)
    by_strategy = [store.lookup(space, workload, s)
                   for s in ("RANDOM", "HILLCLIMB")]
    assert all(r is not None for r in by_strategy)
    assert best.best_energy_measured == min(
        r.best_energy_measured for r in by_strategy)


def test_space_change_forces_retune(tmp_path):
    """Editing a kernel's ConfigSpace must invalidate its cached tune:
    the store key hashes the space fingerprint, so the narrowed space
    misses and fresh measurements happen (no stale winner is served)."""
    store = TuningStore(tmp_path / "kernels.json", devices="pinned")
    assert tune(store, iterations=2).n_measured > 0
    again = tune(store, iterations=2)
    assert again.result.from_cache and again.n_measured == 0
    spec = ktune.get_kernel("dna_automaton")

    def narrowed(meta):
        space = spec.space_fn(meta)
        return ConfigSpace([
            Param(p.name, p.values[:-1], ordinal=p.ordinal)
            if p.name == "block_threads" else p for p in space.params])

    try:
        ktune.register_kernel(dataclasses.replace(spec, space_fn=narrowed))
        redo = tune(store, iterations=2)
        assert not redo.result.from_cache and redo.n_measured > 0
    finally:
        ktune.register_kernel(spec)


# -- the ops tuned= path -----------------------------------------------------------------

def test_tuned_true_falls_back_gracefully(tmp_path, tuned_path_disabled):
    """tuned=True with an empty store (or none) must run the defaults."""
    table, accept = dna_ops.build_motif_dfa("ACGTAC")
    text = torch.from_numpy(
        np.random.default_rng(0).integers(0, 4, 4096).astype(np.uint8))
    base = dna_ops.fa_match(text, table, accept)
    assert int(dna_ops.fa_match(text, table, accept, tuned=True)) == int(base)
    ktune.configure(str(tmp_path / "empty.json"), enabled=False, device="cpu")
    assert not ktune.tuning_enabled()
    assert ktune.resolve_config("dna_automaton", {"t": 4096, "s": 7},
                                "uint8", device="cpu") == {}
    assert int(dna_ops.fa_match(text, table, accept, tuned=True)) == int(base)


def test_tuned_path_resolves_recorded_config(tmp_path, tuned_path_disabled):
    """After tuning, ops called with the global enable resolve the cached
    best config (zero measurements) and still match the oracle."""
    from repro_torch.kernels.dna_automaton import ref as dna_ref

    spec = ktune.get_kernel("dna_automaton")
    meta = spec.smoke_shape
    store = TuningStore(tmp_path / "kernels.json", device="cpu")  # live topology
    out = tune(store, iterations=4)
    ktune.configure(store)
    assert ktune.tuning_enabled()
    resolved = ktune.resolve_config("dna_automaton", dict(meta), torch.uint8,
                                    device="cpu")
    assert resolved == out.best_config
    # a record tuned on the CPU never serves a call on the card
    assert ktune.resolve_config("dna_automaton", dict(meta), "uint8",
                                device="cuda") == {}
    # unknown kernels and other shapes miss
    assert ktune.resolve_config("nope", dict(meta), "uint8", device="cpu") == {}
    assert ktune.resolve_config("dna_automaton", {"t": 8192, "s": 7}, "uint8",
                                device="cpu") == {}

    table, accept = dna_ops.build_motif_dfa("ACGTAC")
    text = np.random.default_rng(3).integers(0, 4, meta["t"]).astype(np.uint8)
    n_measured = out.timer.n_measured
    got = int(dna_ops.fa_match(torch.from_numpy(text), table, accept))
    assert got == dna_ref.fa_match_ref(text, table, accept)[0]
    assert out.timer.n_measured == n_measured


def test_hand_edited_stale_config_is_dropped(tmp_path, tuned_path_disabled):
    """A store entry whose best_config is no longer a point of the
    current space (hand-edited file, renamed launch param) must resolve
    to {} — the ops layer keeps its defaults rather than crashing."""
    path = tmp_path / "kernels.json"
    out = tune(TuningStore(path, devices="pinned"), iterations=2)
    spec = ktune.get_kernel("dna_automaton")
    meta = dict(spec.smoke_shape)
    ktune.configure(TuningStore(path, devices="pinned"), enabled=False)
    assert ktune.resolve_config("dna_automaton", meta, "uint8",
                                device="cpu") == out.best_config

    data = json.loads(path.read_text())["entries"]
    for entry in data.values():
        for report in entry["reports"].values():
            report["best_config"]["block_threads"] = 999   # out of the domain
    path.write_text(json.dumps(data))
    ktune.configure(TuningStore(path, devices="pinned"), enabled=False)
    assert ktune.resolve_config("dna_automaton", meta, "uint8",
                                device="cpu") == {}

    for entry in data.values():
        for report in entry["reports"].values():
            report["best_config"].update(map_chunk=512, count_chunk=256,
                                         block_threads=64)  # does not nest
    path.write_text(json.dumps(data))
    ktune.configure(TuningStore(path, devices="pinned"), enabled=False)
    assert ktune.resolve_config("dna_automaton", meta, "uint8",
                                device="cpu") == {}
