"""The port's roofline (``repro_torch.roofline``) against the reference's,
on the CPU.

1. The analytic ledger (``analytic_cost``, ``model_flops``,
   ``analytic_collective_bytes``) equals the reference's for every
   arch x applicable cell under the default policy, and ``roofline_terms``
   equals the reference's under the reference's chip constants.
2. The ledger's forward FLOPs of a 1-layer Qwen probe lie within 0.8-1.25x
   of the FLOPs its dry run counts (``FlopCounterMode`` plus the kernel
   census), as the reference holds them against XLA's ``cost_analysis``.
3. The counter census of a loop of 12 all-reduces: 12 calls, ring
   transfer bytes.
4. The H100's terms, MODEL_FLOPS bands and the Nemotron-4-340B training
   footprint a rank against the card's 80 GB.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from repro import configs as ref_configs
from repro.launch import policies as ref_policies
from repro.launch import shapes as ref_shapes
from repro.roofline import analysis as ref_analysis
from repro_torch import configs
from repro_torch.dist.collectives import COUNTERS, all_reduce_
from repro_torch.dist.sharding import ShardingConfig
from repro_torch.launch import dryrun, policies, shapes
from repro_torch.launch.meta_trace import trace
from repro_torch.models import build_model
from repro_torch.roofline import analysis
from repro_torch.roofline.census import collective_census

REL = 1e-12


def cells():
    return [(name, cell) for name in configs.ARCH_NAMES
            for cell in shapes.SHAPE_CELLS
            if shapes.applicable(configs.get(name),
                                 shapes.SHAPE_CELLS[cell])[0]]


def both(name: str, cell: str):
    """(port cfg, cell, scfg), (reference cfg, cell, scfg) under each
    package's own policies."""
    out = []
    for cfgs, pol, shp in ((configs, policies, shapes),
                           (ref_configs, ref_policies, ref_shapes)):
        c = shp.SHAPE_CELLS[cell]
        cfg = pol.arch_for_cell(cfgs.get(name), c)
        out.append((cfg, c, pol.default_sharding(cfg, c)))
    return out


def assert_ledgers_equal(got, want):
    assert got.flops == pytest.approx(want.flops, rel=REL)
    assert got.hbm_bytes == pytest.approx(want.hbm_bytes, rel=REL)
    assert got.model_flops == pytest.approx(want.model_flops, rel=REL)
    assert list(got.detail) == list(want.detail)
    for k, v in want.detail.items():
        assert got.detail[k] == pytest.approx(v, rel=REL), k


@pytest.mark.parametrize("name,cell", cells())
def test_ledger_equals_the_references(name, cell):
    (cfg, c, scfg), (rcfg, rc, rscfg) = both(name, cell)
    for n_chips in (256, 512, 64 * 4):
        assert_ledgers_equal(analysis.analytic_cost(cfg, c, scfg, n_chips),
                             ref_analysis.analytic_cost(rcfg, rc, rscfg,
                                                        n_chips))
        assert analysis.analytic_collective_bytes(
            cfg, c, scfg, n_chips) == pytest.approx(
            ref_analysis.analytic_collective_bytes(rcfg, rc, rscfg,
                                                   n_chips), rel=REL)
    assert analysis.model_flops(cfg, c) == pytest.approx(
        ref_analysis.model_flops(rcfg, rc), rel=REL)


def test_roofline_terms_equal_the_references():
    v5e = ref_analysis.V5E
    hw = analysis.HW(peak_flops=v5e.peak_flops, hbm_bw=v5e.hbm_bw,
                     link_bw=v5e.ici_bw, hbm_gb=v5e.hbm_gb)
    for name, cell in cells():
        (cfg, c, scfg), (rcfg, rc, rscfg) = both(name, cell)
        ledger = analysis.analytic_cost(cfg, c, scfg)
        coll = analysis.analytic_collective_bytes(cfg, c, scfg)
        got = analysis.roofline_terms(ledger, coll, 256, hw)
        want = ref_analysis.roofline_terms(
            ref_analysis.analytic_cost(rcfg, rc, rscfg),
            ref_analysis.analytic_collective_bytes(rcfg, rc, rscfg), 256)
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k] == (v if isinstance(v, str)
                              else pytest.approx(v, rel=REL)), (name, k)


def test_analytic_flops_vs_the_dry_runs_counted_flops():
    """1-layer model: the ledger's forward FLOPs within 20 % of what the
    dry run of its forward counts (the products PyTorch runs and the
    flash-attention kernel's census)."""
    base = configs.get("qwen2.5-3b")
    cfg = dataclasses.replace(
        base, n_layers=1, layer_kinds=("attn",), d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=1024,
        param_dtype="float32", compute_dtype="float32", logit_chunk=64,
        tie_embeddings=False, qkv_bias=False)
    model = build_model(cfg, device="meta")
    b, t = 4, 256
    batch = {"tokens": torch.zeros((b, t), dtype=torch.int32,
                                   device="meta"),
             "labels": torch.zeros((b, t), dtype=torch.int32,
                                   device="meta")}
    out = trace(lambda: model.loss(batch)[0], (), list(model.parameters()))
    counted = out["torch_flops"] + out["kernel_flops"]
    assert out["kernels"]["flash_attention_fwd"]["calls"] == 1
    cell = shapes.ShapeCell("probe", "train", t, b)
    scfg = ShardingConfig(remat=False, fsdp_axes=(), microbatches=1)
    ledger = analysis.analytic_cost(cfg, cell, scfg, n_chips=1)
    fwd_analytic = ledger.flops / 3.0
    assert 0.8 <= fwd_analytic / counted <= 1.25, \
        f"analytic {fwd_analytic:.3e} vs counted {counted:.3e}"


def test_census_of_a_loop_of_all_reduces():
    with dryrun.fake_ranks((8,), ("d",)) as mesh:
        x = torch.empty((64, 64), dtype=torch.float32, device="meta")
        for _ in range(12):
            x = all_reduce_(x, mesh, ("d",))
        census = collective_census(COUNTERS.snapshot(), mesh)
    nbytes = 64 * 64 * 4
    assert census["raw"]["all-reduce"] == {
        "count": 12, "bytes": 12 * nbytes,
        "transfer_bytes": pytest.approx(12 * 2 * nbytes * 7 / 8)}
    assert census["weighted"]["all-reduce"]["count"] == 12.0
    assert census["loops"] == []
    assert census["transfer_bytes_per_step"] == pytest.approx(
        12 * 2 * nbytes * 7 / 8)
    assert COUNTERS.snapshot() == {}      # restored on leaving


def test_roofline_terms_arithmetic():
    hw = analysis.H100_SXM
    ledger = analysis.Ledger(flops=hw.peak_flops * 256,
                             hbm_bytes=hw.hbm_bw * 0.5)
    ledger.model_flops = hw.peak_flops * 256 * 0.5
    terms = analysis.roofline_terms(ledger, hw.link_bw * 0.25, 256)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(0.5)
    assert terms["collective_s"] == pytest.approx(0.25)
    assert terms["dominant"] == "compute_s"
    assert terms["mfu_bound"] == pytest.approx(0.5)


def test_model_flops_bands():
    cell = shapes.ShapeCell("train_4k", "train", 4096, 256)
    for name in ("qwen2.5-3b", "nemotron-4-340b"):
        cfg = configs.get(name)
        mf = analysis.model_flops(cfg, cell)
        expect = 6 * cfg.param_count() * 4096 * 256
        assert 0.9 <= mf / expect <= 1.1


def test_nemotron_training_footprint_fits_the_card():
    """bf16 parameters, float32 gradients and int8 moments, each held in
    256 blocks, against the H100's 80 GB."""
    cfg = configs.get("nemotron-4-340b")
    n = cfg.param_count()
    per_rank = (2 * n + 4 * n + 2 * n) / 256 / 1e9
    assert per_rank < analysis.H100_SXM.hbm_gb, f"{per_rank:.1f} GB"
