"""repro_torch.runtime.scheduler held against repro.runtime.scheduler: the
EWMA controller, chunk planning and online convergence run through both
packages on a ``VirtualClock`` with the same serial-device sim, and their
shares, row plans and step times are compared exactly.  The reference's
two subprocess tests (real sharded dispatch on forced host devices) are
real dispatch here in-process: CPU groups whose steps run on worker
threads; those assert coverage, counts and order, never times."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.hetero import proportional_rebalance as ref_proportional
from repro.kernels.dna_automaton import ref as ref_dna
from repro.runtime import scheduler as ref_sched_mod
from repro.runtime import simulate as ref_sim
from repro_torch.core.hetero import DeviceGroup, proportional_rebalance
from repro_torch.kernels.dna_automaton import ops as dna_ops
from repro_torch.runtime import (ChunkedScheduler, StreamingPipeline,
                                 dna_stream_builder, ewma_rebalance)
from repro_torch.runtime import scheduler as port_sched_mod
from repro_torch.runtime import simulate as port_sim

SIDES = {"ref": (ref_sched_mod, ref_sim), "port": (port_sched_mod, port_sim)}


def on_both(run):
    """``run(sched_mod, sim_mod)`` on both packages; the port's result,
    after checking that it equals the reference's."""
    out = {side: run(*mods) for side, mods in SIDES.items()}
    np.testing.assert_equal(out["port"], out["ref"])
    return out["port"]


# -- ewma_rebalance -------------------------------------------------------------

def test_two_groups_reduce_to_proportional_rebalance():
    for f, ta, tb in [(0.5, 1.0, 2.0), (0.8, 0.3, 1.1), (0.2, 2.0, 0.5)]:
        ref = proportional_rebalance(f, ta, tb)
        assert ref == ref_proportional(f, ta, tb)
        out = ewma_rebalance([f, 1 - f], [ta, tb], min_share=1e-3)
        np.testing.assert_array_equal(out, ref_sched_mod.ewma_rebalance(
            [f, 1 - f], [ta, tb], min_share=1e-3))
        assert out[0] == pytest.approx(ref)
        assert out.sum() == pytest.approx(1.0)


def test_degenerate_times_keep_shares():
    s = np.array([0.7, 0.3])
    np.testing.assert_allclose(ewma_rebalance(s, [0.0, 1.0]), s)
    np.testing.assert_allclose(ewma_rebalance(s, [1.0, -2.0]), s)


def test_min_share_floor_and_sum():
    out = ewma_rebalance([0.5, 0.5], [1e-6, 10.0], damping=1.0,
                         min_share=0.05)
    np.testing.assert_array_equal(out, ref_sched_mod.ewma_rebalance(
        [0.5, 0.5], [1e-6, 10.0], damping=1.0, min_share=0.05))
    assert out.min() >= 0.05 - 1e-12
    assert out.sum() == pytest.approx(1.0)


def test_three_group_convergence_to_speed_ratio():
    cost = np.array([1.0, 2.0, 4.0])

    def run(mod, _):
        c = mod.EwmaController(3, min_share=0.01)
        for _ in range(40):
            rows = c.shares * 700
            c.update(rows * cost, rows=rows)
        return c.shares
    shares = on_both(run)
    np.testing.assert_allclose(shares, [4 / 7, 2 / 7, 1 / 7], atol=1e-3)


# -- chunk planning -------------------------------------------------------------

def test_plan_rows_alignment_and_cover():
    def run(mod, sim):
        sched = mod.ChunkedScheduler(
            sim.make_serial_sim_builder(), sim.sim_skew_groups(),
            controller=mod.EwmaController(2, shares=np.array([0.7, 0.3])))
        return sched.plan_rows(64)
    rows = on_both(run)
    assert sum(rows) == 64
    assert all(r >= 4 and r % 4 == 0 for r in rows)
    assert rows[0] > rows[1]


def test_plan_rows_never_starves_largest_share_group():
    def run(mod, sim):
        return mod.ChunkedScheduler(
            sim.make_serial_sim_builder(), sim.sim_skew_groups(),
            controller=mod.EwmaController(2, shares=np.array([0.97, 0.03]),
                                          min_share=0.01)).plan_rows(16)
    assert on_both(run) == [12, 4]


def test_plan_rows_rejects_tiny_batches():
    sched = ChunkedScheduler(port_sim.make_serial_sim_builder(),
                             port_sim.sim_skew_groups())
    with pytest.raises(ValueError):
        sched.plan_rows(4)


def test_chunks_cover_batch_in_order():
    def run(mod, sim):
        seen = []

        def recording_builder(group):
            def fn(chunk):
                seen.append(np.asarray(chunk["x"]))
                return sim.SimReadyAt(None, 0.0)
            return fn

        sched = mod.ChunkedScheduler(recording_builder, sim.sim_skew_groups(),
                                     chunks_per_group=3)
        x = np.arange(96, dtype=np.float32)
        rec = sched.step({"x": x if sim is ref_sim else torch.as_tensor(x)},
                         rebalance=False)
        return rec["rows"], rec["n_chunks"], [s.tolist() for s in seen]
    rows, n_chunks, seen = on_both(run)
    assert sum(rows) == 96 and n_chunks == [3, 3]
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(96, dtype=np.float32))


# -- online convergence ---------------------------------------------------------

def converge(mod, sim, shares, steps, rebalance, *, fast_first=True,
             sizes=(128,)):
    clock = sim.VirtualClock()
    sched = mod.ChunkedScheduler(
        sim.make_serial_sim_builder(0.0004, clock=clock),
        sim.sim_skew_groups(fast_first=fast_first),
        controller=mod.EwmaController(
            2, shares=None if shares is None else np.asarray(shares),
            min_share=0.02), clock=clock)
    batches = [{"x": np.zeros((n, 4), np.float32)} for n in sizes]
    recs = [sched.step(batches[i % len(batches)], rebalance=rebalance)
            for i in range(steps)]
    return ([r["t_step"] for r in recs], [r["rows"] for r in recs],
            [r["shares"].tolist() for r in recs], sched.shares.tolist())


def test_online_converges_to_oracle_within_20_steps():
    oracle = on_both(lambda m, s: converge(m, s, [0.75, 0.25], 5, False))
    t_oracle = np.median(oracle[0])
    t_steps, _, _, shares = on_both(
        lambda m, s: converge(m, s, [0.5, 0.5], 20, True))
    assert np.median(t_steps[-5:]) <= 1.10 * t_oracle
    assert shares[0] == pytest.approx(0.75, abs=0.05)


def test_convergence_is_group_order_independent():
    *_, shares = on_both(lambda m, s: converge(m, s, None, 20, True,
                                               fast_first=False))
    assert shares[0] == pytest.approx(0.25, abs=0.05)


def test_row_quantum_stabilizes_chunk_shapes():
    def run(mod, sim):
        shapes = set()

        def recording_builder(group):
            def fn(chunk):
                shapes.add(chunk["x"].shape[0])
                return sim.SimReadyAt(None, 0.0)
            return fn

        sched = mod.ChunkedScheduler(recording_builder, sim.sim_skew_groups(),
                                     row_quantum=4)
        rows = []
        for shares in ([0.5, 0.5], [0.55, 0.45], [0.72, 0.28], [0.8, 0.2]):
            sched.controller.shares = np.asarray(shares)
            rows.append(sched.step({"x": np.zeros((64, 2), np.float32)},
                                   rebalance=False)["rows"])
        return rows, sorted(shapes)
    rows, shapes = on_both(run)
    assert all(sum(r) == 64 and all(x % 4 == 0 for x in r) for r in rows)
    assert len(shapes) <= 4 and all(s % 4 == 0 for s in shapes)


def test_plan_cache_debounces_noise_but_adopts_persistent_moves():
    def run(mod, sim):
        clock = sim.VirtualClock()
        sched = mod.ChunkedScheduler(
            sim.make_serial_sim_builder(clock=clock), sim.sim_skew_groups(),
            controller=mod.EwmaController(2, min_share=0.02), clock=clock)
        batch = {"x": np.zeros((64, 2), np.float32)}
        recs = [sched.step(batch, rebalance=False)]
        out = []
        for shares in ([0.7, 0.3], [0.5, 0.5], [0.75, 0.25], None):
            if shares is not None:
                sched.controller.shares = np.asarray(shares)
            before = sched.controller.shares.copy()
            recs.append(sched.step(batch))
            out.append((before.tolist(), sched.controller.shares.tolist()))
        return [(r["rows"], r["plan_changed"]) for r in recs], out
    recs, shares = on_both(run)
    base = recs[0][0]
    assert recs[1] == (base, False) and recs[2] == (base, False)
    assert recs[3] == (base, False)
    assert recs[4][1] and recs[4][0] != base
    # the adoption step does not feed its times back into the controller
    assert shares[3][0] == shares[3][1]


def test_variable_batch_sizes_still_rebalance():
    *_, shares = on_both(lambda m, s: converge(m, s, None, 24, True,
                                               sizes=(128, 96)))
    assert shares[0] == pytest.approx(0.75, abs=0.06)


def test_rebalance_off_always_honors_fresh_plan():
    def run(mod, sim):
        sched = mod.ChunkedScheduler(sim.make_serial_sim_builder(),
                                     sim.sim_skew_groups())
        rows = []
        for f in (0.5, 0.55, 0.7, 0.3):
            sched.controller.shares = np.asarray([f, 1 - f])
            rec = sched.step({"x": np.zeros((64, 2), np.float32)},
                             rebalance=False)
            assert rec["rows"] == sched.plan_rows(64)
            rows.append(tuple(rec["rows"]))
        return rows
    rows = on_both(run)
    assert rows[0] != rows[2] != rows[3]


# -- real dispatch, in-process --------------------------------------------------

def cpu_groups():
    return [DeviceGroup("a", [torch.device("cpu")] * 4),
            DeviceGroup("b", [torch.device("cpu")] * 4)]


def test_real_dispatch_results_and_rebalance():
    from repro_torch.runtime.stream import FutureHandle, host_executor

    pool = host_executor()
    outs = []

    def builder(group):
        def fn(chunk):
            fut = pool.submit(lambda x: x.sum(dim=1), chunk["x"])
            outs.append((group.name, fut))
            return FutureHandle(fut)
        return fn

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (64, 16)).astype(np.float32))
    sched = ChunkedScheduler(builder, cpu_groups())
    try:
        for _ in range(3):
            rec = sched.step({"x": x})
            assert sum(rec["rows"]) == 64 and sum(rec["rows_completed"]) == 64
            assert not np.isnan(rec["row_done_at"]).any()
    finally:
        sched.close()
        pool.shutdown()
    # every row's sum came back, three times over
    got = torch.cat([f.result() for _, f in outs])
    torch.testing.assert_close(got.sort().values,
                               x.sum(dim=1).repeat(3).sort().values)
    assert abs(float(sched.shares.sum()) - 1.0) < 1e-9
    assert (sched.shares >= 0.01 - 1e-12).all()


# -- streaming pipeline ---------------------------------------------------------

def test_dna_stream_counts_match_reference():
    table, accept = dna_ops.build_motif_dfa("ACGT")
    builder = dna_stream_builder(table, accept)
    pipe = StreamingPipeline(builder, cpu_groups())
    rng = np.random.default_rng(1)
    batches = [{"text": torch.as_tensor(rng.integers(0, 4, (32, 256))
                                        .astype(np.uint8))}
               for _ in range(3)]
    pipe.run(batches)
    s = pipe.summary()
    assert s["batches"] == 3 and s["rows_total"] == 96
    assert s["rows_per_s_mean"] > 0
    assert sum(builder.dispatches.values()) == 3 * 4

    counts = []

    def capture_builder(group):
        inner = builder(group)

        def fn(chunk):
            handle = inner(chunk)
            counts.append(handle)
            return handle
        return fn

    pipe2 = StreamingPipeline(capture_builder, cpu_groups())
    pipe2.run([batches[0]], rebalance=False)
    builder.close()
    got = np.sort(np.concatenate([h.value.numpy() for h in counts]))
    want = np.sort(np.asarray([
        int(ref_dna.fa_match_ref(jnp.asarray(row), jnp.asarray(table),
                                 jnp.asarray(accept))[0])
        for row in batches[0]["text"].numpy()]))
    np.testing.assert_array_equal(got, want)
