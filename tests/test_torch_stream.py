"""The streamed host/device work split: ``fa_match_rows`` against the
reference's sequential oracle, ``dna_stream_builder`` against the
reference's, ``serve_stream`` against the reference's greedy tokens, the
host worker's threads and affinity, and the paper's split space tuned
within 5 % measured and served from the store.  All on the CPU, in
process: CPU groups run their steps on worker threads, simulated groups
on a ``VirtualClock``."""

import dataclasses
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core.hetero import DeviceGroup as RefGroup
from repro.kernels.dna_automaton import ref as ref_dna
from repro.launch import serve as ref_serve
from repro.models import LM as RefLM
from repro.runtime import StreamingPipeline as RefPipeline
from repro.runtime import dna_stream_builder as ref_dna_builder
from repro.runtime import simulate as ref_sim
from repro_torch import configs
from repro_torch.convert import lm_from_jax_params
from repro_torch.core.hetero import DeviceGroup
from repro_torch.kernels.dna_automaton import kernel, ops
from repro_torch.launch import serve
from repro_torch.runtime import (StreamingPipeline, TuningStore,
                                 VirtualClock, dna_stream_builder,
                                 make_serial_sim_builder)
from repro_torch.runtime.simulate import FakeDevice
from repro_torch.runtime.stream import (EventHandle, FutureHandle,
                                        affinity_cpus, host_executor)

MOTIFS = {7: "ACGTAC", 21: "ACGTTGCAAGCTTCGAACGT"}


def ref_counts(texts, table, accept):
    return [int(ref_dna.fa_match_ref(jnp.asarray(row), jnp.asarray(table),
                                     jnp.asarray(accept))[0])
            for row in np.asarray(texts)]


def random_rows(rows, length, seed, motif):
    """Random DNA with the motif planted often enough to be counted."""
    rng = np.random.default_rng(seed)
    texts = rng.integers(0, 4, (rows, length)).astype(np.uint8)
    sym = np.asarray(["ACGT".index(c) for c in motif], np.uint8)
    for r in range(rows):
        for at in rng.integers(0, max(length - len(sym), 1), 3):
            texts[r, at:at + len(sym)] = sym[:length - at]
    return texts


# -- fa_match_rows ---------------------------------------------------------------

@pytest.mark.parametrize("s,length", [(7, 1000), (7, 4096), (7, 777),
                                      (21, 1000), (21, 999)])
def test_fa_match_rows_matches_the_sequential_oracle(s, length):
    table, accept = ops.build_motif_dfa(MOTIFS[s])
    texts = random_rows(5, length, s + length, MOTIFS[s])
    want = ref_counts(texts, table, accept)
    assert max(want) > 0
    t = torch.as_tensor(texts)
    got = ops.fa_match_rows(t, table, accept, map_chunk=128,
                            count_chunk=256, device="cpu")
    assert got.dtype == torch.int32 and got.tolist() == want
    assert ops.fa_match_rows_plain(t, table, accept, chunk=100).tolist() \
        == want


@pytest.mark.parametrize("gram", kernel.GRAMS)
@pytest.mark.parametrize("s", [7, 21])
def test_fa_match_rows_in_the_kernels_formulation(s, gram):
    """The row decomposition through the kernels' formulation in plain
    PyTorch (k-gram tables, slices composed in order) at every ``gram``:
    the same per-row counts as the oracle, uneven slices included (the
    vector route's, S <= 16; the gather route walks a chunk whole)."""
    table, accept = ops.build_motif_dfa(MOTIFS[s])
    texts = random_rows(3, 1536, gram, MOTIFS[s])
    t = torch.as_tensor(texts)
    tt, at = torch.as_tensor(table), torch.as_tensor(accept.astype(np.int32))
    slices = 3 if kernel.route_of(s) == "vector" else 1
    got = ops._match_rows(
        t, tt, at, 128, 512,
        functools.partial(kernel.state_map_gram_plain, gram=gram,
                          slices=slices),
        functools.partial(kernel.count_hits_gram_plain, gram=gram))
    assert got.tolist() == ref_counts(texts, table, accept)
    # and the wrapper's launch checks accept the gram
    assert ops.fa_match_rows(t, table, accept, gram=gram,
                             device="cpu").tolist() == got.tolist()


def test_fa_match_rows_resolves_tuned_params_and_refuses_bad_input(tmp_path):
    from repro_torch.tune import kernels as ktune

    table, accept = ops.build_motif_dfa("ACGTAC")
    texts = torch.as_tensor(random_rows(2, 4096, 0, "ACGTAC"))
    out = ktune.tune_kernel("dna_automaton", {"t": 8192}, store=tmp_path
                            / "k.json", device="cpu", smoke=True,
                            iterations=20, repeats=1)
    try:
        ktune.configure(tmp_path / "k.json", device="cpu")
        resolved = ktune.resolve_config("dna_automaton", {"t": 8192, "s": 7},
                                        "uint8", device="cpu")
        assert resolved == out.best_config
        assert ops.fa_match_rows(texts, table, accept, tuned=True).tolist() \
            == ref_counts(texts, table, accept)
    finally:
        ktune.disable()
    with pytest.raises(TypeError):
        ops.fa_match_rows(texts.to(torch.int32), table, accept, device="cpu")
    with pytest.raises(ValueError):
        ops.fa_match_rows(texts[0], table, accept, device="cpu")


# -- the DNA stream builder ------------------------------------------------------

def cpu_groups():
    return [DeviceGroup("host", [torch.device("cpu")]),
            DeviceGroup("device", [torch.device("cpu")])]


def capture(builder, seen):
    def build(group):
        inner = builder(group)

        def fn(chunk):
            handle = inner(chunk)
            seen.append((np.asarray(chunk["text"]), handle))
            return handle
        return fn
    return build


def test_dna_stream_counts_equal_the_references_through_two_groups():
    table, accept = ops.build_motif_dfa("ACGT")
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 4, (16, 300)).astype(np.uint8)
               for _ in range(2)]

    port_seen, ref_seen = [], []
    builder = dna_stream_builder(table, accept)
    pipe = StreamingPipeline(capture(builder, port_seen), cpu_groups())
    recs = pipe.run([{"text": torch.as_tensor(b)} for b in batches])
    builder.close()
    assert all(sum(r["rows_completed"]) == 16 for r in recs)
    assert builder.dispatches == {"host": 4, "device": 4}
    assert all(isinstance(h, FutureHandle) for _, h in port_seen)

    dev = jax.devices()[0]
    ref_pipe = RefPipeline(capture(ref_dna_builder(table, accept), ref_seen),
                           [RefGroup("host", [dev]), RefGroup("device",
                                                              [dev])])
    ref_pipe.run([{"text": b} for b in batches])

    def by_row(seen, value):
        return {row.tobytes(): int(c) for text, h in seen
                for row, c in zip(text, value(h))}
    got = by_row(port_seen, lambda h: h.value.numpy())
    want = by_row(ref_seen, np.asarray)
    assert got == want and len(got) == 32


def test_host_worker_threads_and_affinity_stay_on_the_worker():
    cpus = sorted(os.sched_getaffinity(0))
    main_threads = torch.get_num_threads()
    for affinity in ("none", "compact", "scatter"):
        pool = host_executor(2, affinity)
        try:
            seen = pool.submit(lambda: (torch.get_num_threads(),
                                        os.sched_getaffinity(0))).result()
        finally:
            pool.shutdown()
        want = affinity_cpus(2, affinity)
        assert seen == (2, set(cpus) if want is None else want)
        assert len(seen[1]) == (len(cpus) if want is None
                                else min(2, len(cpus)))
    assert torch.get_num_threads() == main_threads
    assert os.sched_getaffinity(0) == set(cpus)
    assert affinity_cpus(2, "compact") == set(cpus[:2])
    with pytest.raises(ValueError):
        affinity_cpus(2, "spread")


def test_host_step_returns_before_its_work_is_done():
    table, accept = ops.build_motif_dfa("ACGTAC")
    builder = dna_stream_builder(table, accept)
    gate = threading.Event()
    pool = builder._pool()
    pool.submit(gate.wait)                  # hold the worker busy
    fn = builder(DeviceGroup("host", [torch.device("cpu")]))
    text = torch.as_tensor(random_rows(2, 512, 1, "ACGTAC"))
    handle = fn({"text": text})
    assert isinstance(handle, FutureHandle) and not handle.is_ready()
    gate.set()
    assert handle.block_until_ready().value.tolist() == \
        ref_counts(text, table, accept)
    builder.close()


def test_card_group_needs_the_card():
    table, accept = ops.build_motif_dfa("ACGTAC")
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dna_stream_builder(table, accept)(
            DeviceGroup("card", [torch.device("cuda")]))
    with pytest.raises(TypeError, match="sim builder"):
        dna_stream_builder(table, accept)(
            DeviceGroup("sim", [FakeDevice()]))
    assert EventHandle.block_until_ready          # the card's handle type


# -- serve_stream against the reference ------------------------------------------

def test_serve_stream_greedy_tokens_equal_the_references():
    cfg = dataclasses.replace(configs.get("qwen2.5-3b").smoke(),
                              compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_configs.get("qwen2.5-3b").smoke(),
                                  compute_dtype="float32")
    params = jax.tree.map(np.asarray,
                          RefLM(ref_cfg).init(jax.random.PRNGKey(0)))
    kw = dict(n_batches=2, batch=4, prompt_len=8, gen=4, seed=0)

    port_seen, ref_seen = [], []
    model = lm_from_jax_params(params, cfg, "cpu")
    out = serve.serve_stream(
        cfg, groups=cpu_groups(), step_builder=capture_tokens(
            serve._stream_step_builder(model, prompt_len=8, gen=4, seed=0),
            port_seen), **kw)
    dev = jax.devices()[0]
    ref_out = ref_serve.serve_stream(
        ref_cfg, groups=[RefGroup("host", [dev]), RefGroup("device", [dev])],
        step_builder=capture_tokens(ref_serve._stream_step_builder(
            RefLM(ref_cfg), prompt_len=8, gen=4, seed=0), ref_seen), **kw)
    assert out["summary"]["rows_total"] == ref_out["summary"]["rows_total"] \
        == 8

    got = {p.tobytes(): t for p, t in rows(port_seen, lambda h: h.value)}
    want = {p.tobytes(): t for p, t in rows(ref_seen, np.asarray)}
    assert got == want and len(got) == 8


def capture_tokens(builder, seen):
    def build(group):
        inner = builder(group)

        def fn(chunk):
            handle = inner(chunk)
            seen.append((np.asarray(chunk["tokens"]), handle))
            return handle
        return fn
    return build


def rows(seen, value):
    for prompts, handle in seen:
        for p, t in zip(prompts, np.asarray(value(handle))):
            yield p.astype(np.int64), t.tolist()


# -- the split tune -------------------------------------------------------------

def test_paper_split_space_tunes_within_5_percent_and_caches(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    space = serve.split_space()
    assert space.size() >= 64
    assert space["host_threads"].values == (1, 2, 4, 8)
    assert space["host_fraction"].values[0] == 0.0
    for cpus in (4, 6):
        monkeypatch.setattr(os, "cpu_count", lambda: cpus)
        assert serve.split_space().size() >= 64
    monkeypatch.setattr(os, "cpu_count", lambda: 8)

    def tune(store, groups, clock):
        dispatched = []
        sim = make_serial_sim_builder(1e-4, clock=clock)

        def builder(group):
            fn = sim(group)

            def counted(chunk):
                dispatched.append(group.name)
                return fn(chunk)
            return counted
        shares, result = serve.tune_stream_split(
            None, groups=groups, space="paper",
            sample={"x": np.zeros((256, 1), np.float32)},
            step_builder=builder, store=store, seed=0, device="cpu",
            row_quantum=1, workload={"stream": "sim"}, iterations=200,
            clock=clock)
        return shares, result, dispatched

    for host_mult in (100, 1):
        clock = VirtualClock()
        groups = [DeviceGroup("host", [FakeDevice()],
                              work_multiplier=host_mult),
                  DeviceGroup("device", [FakeDevice()])]
        store = TuningStore(tmp_path / f"split{host_mult}.json",
                            devices="pinned")
        shares, result, dispatched = tune(store, groups, clock)
        assert not result.from_cache
        assert result.n_measured / result.space_size <= 0.05
        assert result.n_measured <= 5
        if host_mult == 100:        # the host only slows the step down
            assert result.best_config["host_fraction"] == 0.0
            np.testing.assert_array_equal(shares, [0.0, 1.0])
        else:                       # equal groups: split near half
            assert result.best_config["host_fraction"] >= 25.0
        again_shares, again, again_dispatched = tune(store, groups, clock)
        assert again.from_cache and again_dispatched == []
        assert again.best_config == result.best_config
        np.testing.assert_array_equal(again_shares, shares)


@pytest.mark.parametrize("space", ["paper", "fraction"])
def test_split_tune_stops_at_a_group_failure(space):
    """A failed group's rows run on the other group, so the step's time is
    not the point's: the tune raises instead of scoring it."""
    from repro_torch.dist.fault import GroupFailure

    clock = VirtualClock()
    sim = make_serial_sim_builder(1e-4, clock=clock)

    def builder(group):
        fn = sim(group)

        def step(chunk):
            if group.name == "host":
                raise GroupFailure("host", "injected")
            return fn(chunk)
        return step
    groups = [DeviceGroup("host", [FakeDevice()]),
              DeviceGroup("device", [FakeDevice()])]
    with pytest.raises(RuntimeError, match="group failures"):
        serve.tune_stream_split(
            None, groups=groups, space=space, batch=16, device="cpu",
            sample={"x": np.zeros((16, 1), np.float32)},
            step_builder=builder, seed=0, row_quantum=1, clock=clock,
            iterations=20)


def test_fraction_split_tune_equals_the_references(monkeypatch):
    """The reference's nine-fraction space, searched by SAM on the same
    simulated groups: the same split, the same effort.  The reference's
    tuner reads the wall clock; both read a virtual one here."""
    import time

    out = {}
    for side, (sim_mod, group_cls, tune) in {
            "ref": (ref_sim, RefGroup, ref_serve.tune_stream_split),
            "port": (None, DeviceGroup, serve.tune_stream_split)}.items():
        from repro_torch.runtime import simulate as port_sim
        mod = sim_mod or port_sim
        clock = mod.VirtualClock()
        groups = [group_cls("fast", [mod.FakeDevice()] * 2),
                  group_cls("slow", [mod.FakeDevice()] * 2,
                            work_multiplier=3)]
        cfg = (ref_configs if side == "ref" else configs).get(
            "qwen2.5-3b").smoke()
        kw = {"device": "cpu"} if side == "port" else {}
        monkeypatch.setattr(time, "perf_counter", clock.now)
        shares, result = tune(cfg, groups=groups, batch=16, seed=0,
                              step_builder=mod.make_serial_sim_builder(
                                  1e-3, clock=clock), iterations=10, **kw)
        monkeypatch.undo()
        out[side] = (shares.tolist(), result.best_config,
                     result.n_experiments, result.best_energy_measured)
    assert out["port"] == out["ref"]
    assert out["port"][1] == {"fraction": 80}         # 3:1 -> 0.75


def test_serve_stream_starts_a_zero_share_group_dropped():
    clock = VirtualClock()
    groups = [DeviceGroup("host", [FakeDevice()]),
              DeviceGroup("device", [FakeDevice()])]
    out = serve.serve_stream(
        None, groups=groups, batch=8, initial_shares=[0.0, 1.0],
        step_builder=make_serial_sim_builder(1e-3, clock=clock), clock=clock,
        batches=[{"x": np.zeros((8, 1))}] * 3)
    assert out["summary"]["live_final"] == [False, True]
    assert all(r["rows"] == [0, 8] for r in out["records"])


def test_dna_stream_cli_on_the_cpu(capsys):
    serve.main(["--stream", "--stream-workload", "dna", "--device", "cpu",
                "--batch", "8", "--row-len", "2048", "--stream-batches", "2",
                "--tune-split"])
    out = capsys.readouterr().out
    assert "tuned split:" in out and "stream: 2 batches" in out


def test_dna_stream_cli_fails_when_a_group_fails(monkeypatch, capsys):
    """Outside a drill the survivors serve a failed group's rows, and the
    run exits non-zero all the same."""
    from repro_torch.kernels import KernelLaunchError
    from repro_torch.runtime.stream import DnaStreamBuilder

    build = DnaStreamBuilder.__call__

    def failing(self, group):
        fn = build(self, group)
        if group.name != "device":
            return fn

        def step(chunk):
            raise KernelLaunchError("launch refused")
        return step
    monkeypatch.setattr(DnaStreamBuilder, "__call__", failing)
    with pytest.raises(SystemExit, match="group failures") as exc:
        serve.main(["--stream", "--stream-workload", "dna", "--device",
                    "cpu", "--batch", "8", "--row-len", "2048",
                    "--stream-batches", "2"])
    assert exc.value.code != 0
    assert "stream: 2 batches" in capsys.readouterr().out
